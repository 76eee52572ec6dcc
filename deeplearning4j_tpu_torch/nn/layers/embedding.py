"""Transformer-LM embedding layers (the JAX package's
``nn/layers/embedding.py``): token + learned position embedding, and the
weight-tied LM head.

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
from deeplearning4j_tpu_torch.ops.losses import get_loss, promote_loss_dtype

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

    sequence_local = True
    takes_seq_shard = True

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

    def apply(self, params, x, *, state, train=False, rng=None, mask=None,
              seq_shard: bool = False):
        """``seq_shard``: ``x`` is this rank's time shard of a
        sequence-parallel step, so its positions start at the shard's
        offset (sp index x T_local)."""
        x = self._dropout_input(x, train, rng)
        T = x.shape[1]
        start = 0
        if seq_shard:
            from deeplearning4j_tpu_torch.parallel.mesh import (
                active_sequence_context,
            )
            start = active_sequence_context().seq_index * T
        if start + T > self.max_timesteps:
            raise ValueError(
                f"sequence length {start + T} exceeds the learned position "
                f"table ({self.max_timesteps}); rebuild with "
                f"max_timesteps>={start + T}")
        out = (x @ params["W"] + params["b"]
               + params["P"][None, start:start + T, :])
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

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        out = get_activation(self.activation)(self._logits(params, x))
        if mask is not None:
            out = out * mask[..., None]
        return out, state

    def compute_loss(self, params, x, labels, *, mask=None,
                     average: bool = True):
        """RnnOutputLayer's loss semantics (per-timestep loss summed over
        time, mean over the batch) on the rank-3 route, without the
        ``[B*T, F]`` flatten, as the JAX head does; ``average=False``
        keeps the per-timestep ``[B, T]`` matrix via the flat route."""
        preout = self._logits(params, x)
        preout, labels = promote_loss_dtype(preout, labels)
        if not average:
            B, T, F = preout.shape
            flat_mask = mask.reshape(B * T) if mask is not None else None
            per = get_loss(self.loss)(labels.reshape(B * T, F),
                                      preout.reshape(B * T, F),
                                      self.activation, flat_mask)
            return per.reshape(B, T)
        return get_loss(self.loss)(labels, preout, self.activation,
                                   mask).mean()
