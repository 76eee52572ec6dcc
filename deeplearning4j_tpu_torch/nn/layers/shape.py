"""Shape layers (the JAX package's ``nn/layers/shape.py``): reshape,
permute, repeat, the time-distributed wrapper and 1-D zero padding, each
without params of its own."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, layer_from_dict, register_layer,
)


def _type_from_dims(dims: Tuple[int, ...]) -> InputType:
    """Keras' reading of a per-example shape: (F) -> ff, (T, F) -> rnn,
    (H, W, C) -> cnn."""
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        return InputType.convolutional(dims[0], dims[1], dims[2])
    raise ValueError(f"Cannot type a rank-{len(dims)} per-example shape")


def _dims_of(t: InputType) -> Tuple[int, ...]:
    if t.kind in ("ff", "cnnflat"):
        return (t.flat_size(),)
    if t.kind == "rnn":
        return (t.timesteps, t.size)
    if t.kind == "cnn":
        return (t.height, t.width, t.channels)
    raise ValueError(t.kind)


@dataclass
class _ReshapingLayer(BaseLayerConf):
    """A layer that rearranges or creates the time axis: no params, and a
    [B, T] mask is stale after it."""

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()

    def param_order(self) -> List[str]:
        return []

    def propagate_mask(self, mask):
        return None


@register_layer
@dataclass
class ReshapeLayer(_ReshapingLayer):
    """Per-example reshape (Keras ``Reshape(target_shape)``)."""
    target_shape: Tuple[int, ...] = ()

    def infer_output_type(self, in_type: InputType) -> InputType:
        n = 1
        for d in self.target_shape:
            n *= int(d)
        if in_type.kind in ("ff", "cnnflat", "cnn") \
                and in_type.flat_size() != n:
            raise ValueError(
                f"Reshape {self.target_shape} has {n} elements, input "
                f"has {in_type.flat_size()}")
        return _type_from_dims(tuple(self.target_shape))

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.target_shape)), state


@register_layer
@dataclass
class PermuteLayer(_ReshapingLayer):
    """Per-example axis permutation (Keras ``Permute(dims)``, 1-indexed
    over the non-batch axes)."""
    dims: Tuple[int, ...] = ()

    def infer_output_type(self, in_type: InputType) -> InputType:
        src = _dims_of(in_type)
        if len(self.dims) != len(src):
            raise ValueError(
                f"Permute dims {self.dims} rank != input rank {len(src)}")
        return _type_from_dims(tuple(src[d - 1] for d in self.dims))

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return x.permute((0,) + tuple(self.dims)), state


@register_layer
@dataclass
class RepeatVectorLayer(_ReshapingLayer):
    """[B, F] -> [B, n, F] (Keras ``RepeatVector(n)``)."""
    n: int = 1

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind not in ("ff", "cnnflat"):
            raise ValueError(f"RepeatVector expects 2D input, got {in_type}")
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(in_type.flat_size(), self.n)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return x[:, None, :].expand(-1, self.n, -1), state


@register_layer
@dataclass
class TimeDistributedLayer(BaseLayerConf):
    """Apply an inner feed-forward layer independently per timestep:
    [B, T, ...] -> flatten time into batch -> inner -> unflatten."""
    inner: Optional[BaseLayerConf] = None

    def __post_init__(self):
        # JSON round trip: inner arrives as a plain dict
        if isinstance(self.inner, dict):
            self.inner = layer_from_dict(self.inner)

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

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        B, T = x.shape[0], x.shape[1]
        flat = x.reshape((B * T,) + tuple(x.shape[2:]))
        out, new_state = self.inner.apply(params, flat, state=state,
                                          train=train, rng=rng, mask=None)
        out = out.reshape((B, T) + tuple(out.shape[1:]))
        if mask is not None:
            out = out * mask[..., None]
        return out, new_state

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["inner"] = self.inner.to_dict()
        return d


@register_layer
@dataclass
class ZeroPadding1DLayer(BaseLayerConf):
    """Zero-pad the time axis of [B, T, F] by ``padding`` = (left, right);
    the mask is padded with zeros too."""
    padding: Tuple[int, int] = (1, 1)

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"ZeroPadding1D expects RNN input, got {in_type}")
        self.n_in = in_type.size

    def infer_output_type(self, in_type: InputType) -> InputType:
        left, right = self.padding
        t = in_type.timesteps
        return InputType.recurrent(in_type.size,
                                   None if t is None else t + left + right)

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        left, right = self.padding
        return F.pad(x, (0, 0, left, right)), state

    def propagate_mask(self, mask):
        return None if mask is None else F.pad(mask, tuple(self.padding))
