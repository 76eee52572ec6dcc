"""Shape layers (the JAX package's ``nn/layers/shape.py``; so far only
``TimeDistributedLayer``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, register_layer,
)


@register_layer
@dataclass
class TimeDistributedLayer(BaseLayerConf):
    """Apply an inner feed-forward layer independently per timestep:
    [B, T, ...] -> flatten time into batch -> inner -> unflatten."""
    inner: Optional[BaseLayerConf] = None

    def apply_global_defaults(self, g) -> None:
        super().apply_global_defaults(g)
        self.inner.apply_global_defaults(g)

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"TimeDistributed expects RNN input, got {in_type}")
        self.n_in = in_type.size
        self.inner.set_n_in(InputType.feed_forward(in_type.size))

    def infer_output_type(self, in_type: InputType) -> InputType:
        inner_out = self.inner.infer_output_type(
            InputType.feed_forward(in_type.size))
        return InputType.recurrent(inner_out.flat_size(), in_type.timesteps)

    def has_params(self) -> bool:
        return self.inner.has_params()

    def param_order(self) -> List[str]:
        return self.inner.param_order()

    def init_params(self, gen, dtype=torch.float32):
        return self.inner.init_params(gen, dtype)

    def init_state(self):
        return self.inner.init_state()

    def apply(self, params, x, *, state, mask=None):
        B, T = x.shape[0], x.shape[1]
        flat = x.reshape((B * T,) + tuple(x.shape[2:]))
        out, new_state = self.inner.apply(params, flat, state=state,
                                          mask=None)
        out = out.reshape((B, T) + tuple(out.shape[1:]))
        if mask is not None:
            out = out * mask[..., None]
        return out, new_state
