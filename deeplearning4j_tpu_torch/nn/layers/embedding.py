"""Transformer-LM embedding layers (the JAX package's
``nn/layers/embedding.py``): token + learned position embedding, and the
weight-tied LM head (forward only).

Weight tying is resolved by the container: ``TiedRnnOutputLayer`` owns no
params, and ``ComputationGraph._layer_params`` hands it the tied node's
``W`` under ``W_tok`` on each call (the same tensor, never a copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.ops.activations import get_activation

#: GPT-2's positional-embedding init scale
POSITION_INIT_SCALE = 0.02


@register_layer
@dataclass
class PositionalEmbeddingLayer(BaseLayerConf):
    """[B, T, V] -> [B, T, D]: ``x @ W + b + P[:T]`` — token embedding as
    a (one-hot) matmul plus learned absolute positions. ``max_timesteps``
    (the P table's length) is filled from the input type at build time."""
    n_out: int = 0
    max_timesteps: int = 0

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"PositionalEmbeddingLayer expects RNN input, got {in_type}")
        self.n_in = in_type.size
        if not self.max_timesteps:
            if in_type.timesteps is None:
                raise ValueError(
                    "PositionalEmbeddingLayer needs fixed timesteps (set "
                    "max_timesteps= or declare them in the InputType)")
            self.max_timesteps = int(in_type.timesteps)

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def param_order(self) -> List[str]:
        return ["W", "P", "b"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        P = torch.randn((self.max_timesteps, self.n_out), generator=gen)
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "P": (POSITION_INIT_SCALE * P).to(dtype),
            "b": self._init_b((self.n_out,), dtype),
        }

    def apply(self, params, x, *, state, mask=None):
        T = x.shape[1]
        if T > self.max_timesteps:
            raise ValueError(
                f"sequence length {T} exceeds the learned position table "
                f"({self.max_timesteps}); rebuild with max_timesteps>={T}")
        out = x @ params["W"] + params["b"] + params["P"][None, :T, :]
        out = get_activation(self.activation or "identity")(out)
        if mask is not None:
            out = out * mask[..., None]
        return out, state

    def decode_step(self, params, x, positions):
        """Embedding of ONE token per row: ``x`` [B, 1, V] one-hot,
        ``positions`` [B] each row's sequence position. Returns [B, 1, D]."""
        out = x @ params["W"] + params["b"] \
            + params["P"][positions][:, None, :]
        return get_activation(self.activation or "identity")(out)


@register_layer
@dataclass
class TiedRnnOutputLayer(RnnOutputLayer):
    """Per-timestep head projecting through the TRANSPOSED token embedding
    of the node named ``tied_to``, with no bias: ``act(x @ W_tok.T)``."""
    tied_to: Optional[str] = None

    def param_order(self) -> List[str]:
        return []

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {}

    def _logits(self, params, x):
        if "W_tok" not in params:
            raise ValueError(
                f"TiedRnnOutputLayer({self.name!r}): no tied weights were "
                f"injected — tied_to={self.tied_to!r} must name a layer "
                "node with a 'W' param, and the container must thread it")
        return x @ params["W_tok"].T

    def apply(self, params, x, *, state, mask=None):
        out = get_activation(self.activation)(self._logits(params, x))
        if mask is not None:
            out = out * mask[..., None]
        return out, state
