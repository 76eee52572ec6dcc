"""Recurrent layers (the JAX package's ``nn/layers/recurrent.py``; so far
only ``RnnOutputLayer``, forward only, as the base of the tied LM head)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation


@register_layer
@dataclass
class RnnOutputLayer(BaseLayerConf):
    """Per-timestep dense head over [B, T, F]. ``loss`` names the training
    objective, which is not ported yet."""
    n_out: int = 0
    loss: str = "mcxent"

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"RnnOutputLayer expects RNN input, got {in_type}")
        self.n_in = in_type.size

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
        }

    def apply(self, params, x, *, state, mask=None):
        out = get_activation(self.activation)(x @ params["W"] + params["b"])
        if mask is not None:
            out = out * mask[..., None]
        return out, state
