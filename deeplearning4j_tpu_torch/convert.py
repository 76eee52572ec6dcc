"""Carry weights from the JAX package's nets into the port.

``params_from_jax(conf, params)`` takes a JAX net's params as numpy
arrays (e.g. ``jax.tree.map(np.asarray, net.params)``): for a
``ComputationGraph`` a dict node -> param name -> array, for a
``MultiLayerNetwork`` a list of per-layer dicts. It returns the port's
params for the port config ``conf`` (a graph or a
``MultiLayerConfiguration``), so that both nets compute the same function.
Both packages keep the same names and layouts (``W`` ``[in, out]``,
attention ``Wq/Wk/Wv`` ``[F, H*D]``, GravesLSTM's peepholes ``pW`` flat
``[3H]``, GravesBidirectionalLSTM's backward direction as ``W_bwd``,
``RW_bwd``, ``b_bwd``, ``pW_bwd``: each layer's ``param_order()``), so
each tensor is a copy, not a transpose: a conv kernel stays HWIO
``[kh, kw, in, out]``, since the port's activations stay NHWC.
``states_from_jax(conf, states)`` carries the layers' state (batch norm's
running ``mean`` and ``var``) the same way, so an inference-mode
``output()`` compares too. ``params_to_numpy`` (and ``states_to_numpy``)
go the other way, to numpy arrays in the same structure, so tests
compare the two nets' params, gradients or states by name.
``opt_state_from_jax(net, leaves)`` writes a JAX net's optax state, given
as its flattened leaves (``jax.tree_util.tree_leaves(opt_state)`` as
numpy), into a port net's updater state, and ``opt_state_to_jax(net)``
gives a port net's state as those leaves, for ``tree_unflatten`` with the
JAX net's treedef (``Updater.optax_layout`` holds the map).
``lookup_table_from_jax(table)`` carries a JAX ``InMemoryLookupTable``
(its vocab words with counts, codes and points; ``syn0`` / ``syn1`` /
``syn1neg`` and the negative-sampling CDF as numpy copies) into the
port's, and ``tree_vectorizer_from_jax(jax_tv, tv)`` copies a JAX
``TreeVectorizer``'s ``W`` and ``b`` into the port's, on its device. This
module imports nothing of the JAX package: it reads arrays.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerConf


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16, unknown to torch
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def layer_params_from_jax(layer: BaseLayerConf,
                          params: Mapping) -> Dict[str, torch.Tensor]:
    """One layer's params, by its ``param_order()`` names."""
    names = layer.param_order()
    missing = [n for n in names if n not in params]
    extra = [n for n in params if n not in names]
    if missing or extra:
        raise ValueError(
            f"{type(layer).__name__} {layer.name!r}: params "
            f"{sorted(params)} do not match param_order() {names}")
    return {n: _to_tensor(params[n]) for n in names}


def params_from_jax(conf, params: Union[Mapping, Sequence[Mapping]]
                    ) -> Union[Dict[str, Dict[str, torch.Tensor]],
                               List[Dict[str, torch.Tensor]]]:
    """The port's params (CPU tensors): a list, one dict per layer, for a
    ``MultiLayerConfiguration``; else a dict for every layer node of the
    graph config ``conf``."""
    if isinstance(conf, MultiLayerConfiguration):
        if len(params) != len(conf.layers):
            raise ValueError(f"{len(params)} param dicts for "
                             f"{len(conf.layers)} layers")
        return [layer_params_from_jax(layer, p)
                for layer, p in zip(conf.layers, params)]
    out = {}
    for name in conf.topological_order:
        node = conf.nodes[name]
        if node.kind == "layer":
            out[name] = layer_params_from_jax(node.layer,
                                              params.get(name, {}))
    return out


def states_from_jax(conf, states: Union[Mapping, Sequence[Mapping]]
                    ) -> Union[Dict[str, Dict[str, torch.Tensor]],
                               List[Dict[str, torch.Tensor]]]:
    """The port's layer states (CPU tensors) from a JAX net's, in the
    structure of ``params_from_jax``: each layer's state must hold the
    names its ``init_state()`` holds."""
    def layer_state(layer, state):
        if sorted(state) != sorted(layer.init_state()):
            raise ValueError(
                f"{type(layer).__name__} {layer.name!r}: state "
                f"{sorted(state)} does not match init_state()")
        return {n: _to_tensor(a) for n, a in state.items()}

    if isinstance(conf, MultiLayerConfiguration):
        if len(states) != len(conf.layers):
            raise ValueError(f"{len(states)} state dicts for "
                             f"{len(conf.layers)} layers")
        return [layer_state(layer, s)
                for layer, s in zip(conf.layers, states)]
    return {name: layer_state(conf.nodes[name].layer, states.get(name, {}))
            for name in conf.topological_order
            if conf.nodes[name].kind == "layer"}


def params_to_numpy(params):
    """A port container's params or gradients (a dict node -> name ->
    tensor, or a list of per-layer dicts) as numpy arrays in the same
    structure, on the host; bf16 comes back as float32. The arrays are
    copies: a snapshot that later in-place updates of the params (a
    training step, ``set_params_flat``) leave as it was."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


#: a container's states as numpy arrays, in the same structure
states_to_numpy = params_to_numpy


def opt_state_from_jax(net, leaves: Sequence) -> None:
    """Write optax's flattened leaves (numpy arrays, in
    ``jax.tree_util.tree_leaves`` order) into ``net.opt_state`` in place."""
    net._tx.load_optax_leaves(net.opt_state, [_to_tensor(a) for a in leaves])


def opt_state_to_jax(net) -> List[np.ndarray]:
    """``net.opt_state`` as optax's flattened leaves (numpy arrays; bf16
    moments as float32)."""
    return [params_to_numpy(t) for t in net._tx.optax_leaves(net.opt_state)]


def lookup_table_from_jax(table):
    """The port's ``nlp.lookup.InMemoryLookupTable`` holding a copy of the
    JAX package's ``table``: the same words in the same order with their
    counts, Huffman codes and points, the same vocab total, and numpy
    copies of its weights and negative-sampling CDF."""
    from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
    cache = VocabCache()
    for w in table.vocab.vocab_words():
        cache.add(VocabWord(w.word, w.count, codes=list(w.codes),
                            points=list(w.points)))
    cache.total_word_count = table.vocab.total_word_count
    out = InMemoryLookupTable(cache, table.vector_length, use_hs=table.use_hs,
                              negative=table.negative)
    for name in ("syn0", "syn1", "syn1neg", "_neg_cdf"):
        setattr(out, name, np.array(getattr(table, name), copy=True))
    return out


def tree_vectorizer_from_jax(jax_tv, tv) -> None:
    """Copy a JAX ``TreeVectorizer``'s composition weights ``W`` [2D, D]
    and ``b`` [D] into the port's ``tv`` in place, on its device."""
    for name in ("W", "b"):
        dst = getattr(tv, name)
        src = np.asarray(getattr(jax_tv, name), np.float32)
        if src.shape != tuple(dst.shape):
            raise ValueError(f"TreeVectorizer.{name}: {src.shape} does not "
                             f"match {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, copy=True)))
