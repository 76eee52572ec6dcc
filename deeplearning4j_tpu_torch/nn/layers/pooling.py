"""Global pooling (the JAX package's ``nn/layers/pooling.py``): max, avg,
sum or pnorm over T of [B, T, F] or over (H, W) of NHWC [B, H, W, C]. With
a [B, T] mask the masked steps are left out of the reduction, as DL4J's
MaskedReductionUtil does."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, register_layer,
)


@register_layer
@dataclass
class GlobalPoolingLayer(BaseLayerConf):
    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def propagate_mask(self, mask):
        return None  # pools the time axis away; the mask is consumed

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        if in_type.kind == "rnn":
            return InputType.feed_forward(in_type.size)
        if in_type.kind == "cnn":
            return InputType.feed_forward(in_type.channels)
        raise ValueError(
            f"GlobalPooling expects RNN or CNN input, got {in_type}")

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        if x.dim() == 3:      # [B, T, F] -> pool over T
            axes = (1,)
        elif x.dim() == 4:    # [B, H, W, C] -> pool over H, W
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling: unsupported rank {x.dim()}")
        kind = self.pooling_type
        p = float(self.pnorm)
        if mask is not None and x.dim() == 3:
            m = mask[..., None]  # [B, T, 1]
            if kind == "max":
                return torch.where(m > 0, x, -torch.inf).amax(axes), state
            if kind == "sum":
                return (x * m).sum(axes), state
            if kind == "avg":
                return ((x * m).sum(axes)
                        / m.sum(axes).clamp(min=1e-8)), state
            if kind == "pnorm":
                return ((x * m).abs() ** p).sum(axes) ** (1.0 / p), state
            raise ValueError(kind)
        if kind == "max":
            return x.amax(axes), state
        if kind == "sum":
            return x.sum(axes), state
        if kind == "avg":
            return x.mean(axes), state
        if kind == "pnorm":
            return (x.abs() ** p).sum(axes) ** (1.0 / p), state
        raise ValueError(kind)
