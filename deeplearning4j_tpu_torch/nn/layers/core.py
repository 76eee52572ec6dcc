"""Feed-forward layers (the JAX package's ``nn/layers/core.py``; so far
only ``DenseLayer``, which the GPT decoder's MLP uses)."""

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
class DenseLayer(BaseLayerConf):
    """Fully connected: act(x @ W + b), W ``[n_in, n_out]``."""
    n_out: int = 0

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
        }

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        return get_activation(self.activation)(
            x @ params["W"] + params["b"]), state
