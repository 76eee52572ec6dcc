"""ComputationGraph: the DAG model container (the JAX package's
``nn/graph.py``), inference and incremental decode.

Params are a dict keyed by node name -> {param name -> tensor}, in the
JAX package's names and layouts, on the net's device. The container runs
on ``cuda`` unless it is built with ``device="cpu"``; with ``device=None``
and no card it raises. Training, tBPTT, the paged decode and the
evaluation/scoring mixins are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    LayerNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.shape import TimeDistributedLayer

Tensor = torch.Tensor


def _dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = _dtype_of(conf.training.dtype)
        self.params: Optional[Dict[str, Dict[str, Tensor]]] = None
        self.states: Optional[Dict[str, Dict[str, Tensor]]] = None
        self._decode_fns = None
        self._layer_nodes = [n for n in conf.topological_order
                             if conf.nodes[n].kind == "layer"]
        # weight tying: resolve once, fail loudly at construction
        for name in self._layer_nodes:
            tied = getattr(conf.nodes[name].layer, "tied_to", None)
            if not tied:
                continue
            src = conf.nodes.get(tied)
            if src is None or src.kind != "layer":
                raise ValueError(
                    f"node {name!r}: tied_to={tied!r} does not name a "
                    "layer node in this graph")
            if "W" not in (src.layer.param_order() or []):
                raise ValueError(
                    f"node {name!r}: tied_to node {tied!r} "
                    f"({type(src.layer).__name__}) has no 'W' param to "
                    "tie to")

    # ------------------------------------------------------------------ init
    def init(self, params=None) -> "ComputationGraph":
        """Draw params from a CPU ``torch.Generator`` seeded with the
        config's seed (the same weights on every device), or take
        ``params`` (e.g. ``convert.params_from_jax``); either way they
        are moved to the net's device."""
        if params is None:
            gen = torch.Generator().manual_seed(self.conf.training.seed)
            params = {}
            for name in self._layer_nodes:
                layer = self.conf.nodes[name].layer
                params[name] = (layer.init_params(gen, self.dtype)
                                if layer.has_params() else {})
        self.params = {n: {k: t.to(self.device) for k, t in p.items()}
                       for n, p in params.items()}
        self.states = {name: self.conf.nodes[name].layer.init_state()
                       for name in self._layer_nodes}
        return self

    def _check_init(self):
        if self.params is None:
            raise RuntimeError("Call init() before using the network")

    def _layer_params(self, params, name: str):
        """One layer node's params, plus — for a tied head — the tied
        node's ``W`` injected as ``W_tok`` (the same tensor, not a copy)."""
        tied = getattr(self.conf.nodes[name].layer, "tied_to", None)
        if tied:
            return {**params[name], "W_tok": params[tied]["W"]}
        return params[name]

    def num_params(self) -> int:
        self._check_init()
        return sum(t.numel() for p in self.params.values()
                   for t in p.values())

    # ---------------------------------------------------------------- forward
    def _forward(self, params, states, inputs: Dict[str, Tensor],
                 masks: Optional[Dict[str, Tensor]] = None):
        """Walk the DAG in topological order (inference). Each node takes
        the mask of its FIRST input. Returns (activations, masks)."""
        acts: Dict[str, Tensor] = {}
        out_masks: Dict[str, Optional[Tensor]] = {}
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                acts[name] = inputs[name]
                out_masks[name] = (masks or {}).get(name)
                continue
            in_acts = [acts[i] for i in node.inputs]
            in_mask = out_masks.get(node.inputs[0]) if node.inputs else None
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(in_acts)
                out_masks[name] = in_mask
                continue
            layer = node.layer
            acts[name], _ = layer.apply(self._layer_params(params, name),
                                        in_acts[0], state=states[name],
                                        mask=in_mask)
            out_masks[name] = layer.propagate_mask(in_mask)
        return acts, out_masks

    def _to_tensor(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def outputs(self, inputs: Union[Tensor, np.ndarray, Sequence, Dict],
                mask=None) -> List[Tensor]:
        """Final activations of all output nodes (ref:
        ComputationGraph.output(...)). ``mask``: a [B, T] feature mask for
        the first input, or a name -> mask dict."""
        self._check_init()
        names = self.conf.network_inputs
        if isinstance(inputs, dict):
            in_map = {k: self._to_tensor(v) for k, v in inputs.items()}
        elif isinstance(inputs, (list, tuple)):
            in_map = {n: self._to_tensor(x) for n, x in zip(names, inputs)}
        else:
            in_map = {names[0]: self._to_tensor(inputs)}
        masks = None
        if mask is not None:
            masks = ({k: None if v is None else self._to_tensor(v)
                      for k, v in mask.items()} if isinstance(mask, dict)
                     else {names[0]: self._to_tensor(mask)})
        with torch.no_grad():
            acts, _ = self._forward(self.params, self.states, in_map, masks)
        return [acts[o] for o in self.conf.network_outputs]

    def output(self, inputs, mask=None) -> Tensor:
        return self.outputs(inputs, mask=mask)[0]

    # ----------------------------------------------------- incremental decode
    # Token-level serving: per-request KV caches of static
    # [rows, H, max_len, D] shape are threaded through the step; every row
    # masks its own prefix.

    def kv_cache_nodes(self) -> List[str]:
        """Layer nodes that thread a KV cache (causal attention)."""
        return [n for n in self._layer_nodes
                if getattr(self.conf.nodes[n].layer,
                           "supports_kv_cache", False)]

    def decode_max_len(self) -> int:
        """Static cache length: the learned position table's capacity."""
        for n in self._layer_nodes:
            ml = getattr(self.conf.nodes[n].layer, "max_timesteps", 0)
            if ml:
                return int(ml)
        for t in self.conf.input_types.values():
            if t is not None and t.kind == "rnn" and t.timesteps:
                return int(t.timesteps)
        raise ValueError(
            "decode needs a static max sequence length (a "
            "PositionalEmbeddingLayer max_timesteps or a recurrent "
            "InputType with fixed timesteps)")

    def decode_vocab(self) -> int:
        t = self.conf.input_types.get(self.conf.network_inputs[0])
        if t is None or t.kind != "rnn":
            raise ValueError("decode needs a recurrent input type")
        return int(t.size)

    def _check_decodable(self) -> None:
        """Fail loudly when the graph is not an incremental decoder:
        single input/output, every time-mixing layer a causal attention
        (KV cache) or the positional embedding, the rest per-timestep."""
        if len(self.conf.network_inputs) != 1 \
                or len(self.conf.network_outputs) != 1:
            raise ValueError("incremental decode supports single-input/"
                             "single-output graphs")
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "vertex":
                if not isinstance(node.vertex, ElementWiseVertex):
                    raise ValueError(
                        f"vertex {name!r} ({type(node.vertex).__name__}) "
                        "is not per-timestep-local; cannot decode "
                        "incrementally")
                continue
            if node.kind != "layer":
                continue
            layer = node.layer
            if isinstance(layer, SelfAttentionLayer):
                if not layer.supports_kv_cache:
                    raise ValueError(
                        f"attention node {name!r} is not causal — "
                        "incremental decode would change its output")
                continue
            ok = (hasattr(layer, "decode_step")
                  or isinstance(layer, (LayerNormalization,
                                        TimeDistributedLayer,
                                        RnnOutputLayer)))
            if not ok:
                raise ValueError(
                    f"node {name!r} ({type(layer).__name__}) is not "
                    "known to be per-timestep-local; cannot decode "
                    "incrementally")

    def init_decode_cache(self, rows: int, max_len: Optional[int] = None
                          ) -> Dict[str, Dict[str, Tensor]]:
        """Fresh zeroed KV caches for a ``rows``-row decode bucket — one
        {k, v} pair per causal-attention node, on the net's device."""
        if max_len is None:
            max_len = self.decode_max_len()
        out = {}
        for n in self.kv_cache_nodes():
            shape = self.conf.nodes[n].layer.cache_shape(rows, max_len)
            out[n] = {kv: torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
                      for kv in ("k", "v")}
        return out

    def _incremental_forward(self, params, states, x, caches, positions,
                             lengths=None):
        """One DAG walk shared by prefill (``lengths`` given, x the padded
        [B, T, V] prompt block) and decode (x the [B, 1, V] current token,
        ``positions`` each row's position). Caches are updated in place.
        Returns (output activation, caches)."""
        acts: Dict[str, Tensor] = {self.conf.network_inputs[0]: x}
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            in_acts = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(in_acts)
                continue
            layer = node.layer
            h = in_acts[0]
            p = self._layer_params(params, name)
            if getattr(layer, "supports_kv_cache", False):
                cache = caches[name]
                if lengths is not None:
                    h, _, _ = layer.prefill(p, h, cache["k"], cache["v"],
                                            lengths)
                else:
                    h, _, _ = layer.decode_step(p, h, cache["k"],
                                                cache["v"], positions)
            elif lengths is None and hasattr(layer, "decode_step"):
                h = layer.decode_step(p, h, positions)
            else:
                h, _ = layer.apply(p, h, state=states[name], mask=None)
            acts[name] = h
        return acts[self.conf.network_outputs[0]], caches

    def decode_fns(self):
        """The two step functions of token-level serving:

        - ``prefill(params, states, caches, x, lengths)`` -> ``(probs
          [B, V] at each row's last prompt position, caches)`` — x is the
          pow2-padded one-hot prompt block [B, T, V];
        - ``decode(params, states, caches, x, positions)`` -> ``(probs
          [B, V], caches)`` — x is the [B, 1, V] one-hot of each row's
          current token.

        Both update ``caches`` in place and return it."""
        if self._decode_fns is None:
            self._check_decodable()

            @torch.no_grad()
            def prefill(params, states, caches, x, lengths):
                out, caches = self._incremental_forward(
                    params, states, x, caches, None, lengths=lengths)
                rows = torch.arange(x.shape[0], device=x.device)
                return out[rows, lengths - 1], caches

            @torch.no_grad()
            def decode(params, states, caches, x, positions):
                out, caches = self._incremental_forward(
                    params, states, x, caches, positions)
                return out[:, 0, :], caches

            self._decode_fns = (prefill, decode)
        return self._decode_fns
