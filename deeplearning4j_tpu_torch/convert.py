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
compare the two nets' params, gradients or states by name. This module
imports nothing of the JAX package: it reads arrays.
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
    structure, on the host; bf16 comes back as float32."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


#: a container's states as numpy arrays, in the same structure
states_to_numpy = params_to_numpy
