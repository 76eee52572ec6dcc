"""Normalization layers (the JAX package's ``nn/layers/normalization.py``;
so far only ``LayerNormalization``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)


@register_layer
@dataclass
class LayerNormalization(BaseLayerConf):
    """Layer normalization over the feature (last) axis, statistics in at
    least f32. The variance is the population variance (``jnp.var``), and
    ``eps`` sits inside the reciprocal square root."""
    eps: float = 1e-5
    # filled by builder:
    n_features: int = 0

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()
        self.n_features = (in_type.channels if in_type.kind == "cnn"
                           else in_type.flat_size())

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return ["gamma", "beta"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {"gamma": torch.ones((self.n_features,), dtype=dtype),
                "beta": torch.zeros((self.n_features,), dtype=dtype)}

    def apply(self, params, x, *, state, mask=None):
        in_dtype = x.dtype
        xs = x.to(torch.promote_types(in_dtype, torch.float32))
        mean = xs.mean(dim=-1, keepdim=True)
        var = xs.var(dim=-1, keepdim=True, unbiased=False)
        xhat = (xs - mean) * torch.rsqrt(var + self.eps)
        out = params["gamma"] * xhat + params["beta"]
        return out.to(in_dtype), state
