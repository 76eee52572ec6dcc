"""Convolution, subsampling and zero-padding layers (the JAX package's
``nn/layers/convolution.py``).

Activations stay NHWC ``[B, H, W, C]`` (``[B, T, F]`` for the 1-D layers)
and kernels HWIO ``[kh, kw, in, out]`` (``[k, in, out]``), as in the JAX
package, so weights carry across as copies. The ops run on PyTorch's
convolution and pooling (cuDNN on the card) over NCHW *views*:
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a channels-last
NCHW tensor, which cuDNN convolves without a copy, and the kernel goes
to OIHW by ``W.permute(3, 2, 0, 1)``. A 1-D layer is the 2-D one over
``[B, T, 1, F]``.

``convolution_mode`` follows DL4J's ConvolutionMode: ``strict`` (the
output size must come out whole), ``truncate`` (floor) and ``same``
(ceil(in / stride)). ``same`` is XLA's SAME, which is asymmetric: of
``pad_total = max((ceil(in / s) - 1) * s + k_eff - in, 0)`` it puts
``pad_total // 2`` before and the rest after (ResNet's 7x7/2 stem on 224
pads (2, 3)), which PyTorch's symmetric ``padding=`` cannot express, so
the pad is an explicit ``F.pad`` (with -inf for max pooling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation

Tensor = torch.Tensor


def _out_size(in_size: int, k: int, s: int, p: int, mode: str) -> int:
    if mode == "same":
        return math.ceil(in_size / s)
    out = (in_size + 2 * p - k) / s + 1
    if mode == "strict":
        if out != int(out):
            raise ValueError(
                f"ConvolutionMode.Strict: (in={in_size} + 2*{p} - {k}) / "
                f"{s} + 1 = {out} is not an integer")
        return int(out)
    return int(math.floor((in_size + 2 * p - k) / s)) + 1


def same_pads(in_size: int, k_eff: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (before, after)."""
    total = max((math.ceil(in_size / s) - 1) * s + k_eff - in_size, 0)
    return total // 2, total - total // 2


def _pads(x: Tensor, k_eff, stride, padding, mode) -> Tuple[int, ...]:
    """``F.pad``'s (left, right, top, bottom) for an NCHW view ``x``."""
    if mode == "same":
        top, bottom = same_pads(x.shape[2], k_eff[0], stride[0])
        left, right = same_pads(x.shape[3], k_eff[1], stride[1])
        return left, right, top, bottom
    return padding[1], padding[1], padding[0], padding[0]


def _pad(x: Tensor, pads, value: float = 0.0) -> Tensor:
    return F.pad(x, pads, value=value) if any(pads) else x


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_nhwc(x: Tensor, w: Tensor, stride, padding, dilation,
                mode: str) -> Tensor:
    """NHWC ``x`` convolved with HWIO ``w``, without bias: NHWC out."""
    k_eff = tuple((k - 1) * d + 1 for k, d in zip(w.shape[:2], dilation))
    xc = _nchw(x)
    xc = _pad(xc, _pads(xc, k_eff, stride, padding, mode))
    return _nhwc(F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride),
                          dilation=tuple(dilation)))


def pool2d_nhwc(x: Tensor, kind: str, kernel, stride, padding, mode: str,
                pnorm: float = 2.0) -> Tensor:
    """Max / avg / sum / pnorm pooling of NHWC ``x``, padded as
    ``lax.reduce_window`` pads: -inf for max, 0 for the sums. ``avg``
    divides by the count of unpadded elements under ``same`` and by
    ``kh * kw`` otherwise (explicit padding counts as elements)."""
    xc = _nchw(x)
    pads = _pads(xc, kernel, stride, padding, mode)
    kernel, stride = tuple(kernel), tuple(stride)
    if kind == "max":
        return _nhwc(F.max_pool2d(_pad(xc, pads, -math.inf), kernel,
                                  stride))
    if kind == "pnorm":
        xc = xc.abs() ** pnorm
    elif kind not in ("avg", "sum"):
        raise ValueError(f"Unknown pooling type {kind!r}")
    out = F.avg_pool2d(_pad(xc, pads), kernel, stride, divisor_override=1)
    if kind == "pnorm":
        out = out ** (1.0 / pnorm)
    elif kind == "avg":
        if mode == "same":
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            out = out / F.avg_pool2d(_pad(ones, pads), kernel, stride,
                                     divisor_override=1)
        else:
            out = out / (kernel[0] * kernel[1])
    return _nhwc(out)


@register_layer
@dataclass
class ConvolutionLayer(BaseLayerConf):
    """2-D convolution; kernel ``W`` HWIO ``[kh, kw, in, out]``,
    activations NHWC. Runs in the kernel's dtype (the input is cast to
    it), as the JAX layer does."""
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"   # strict | truncate | same
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = True
    # filled by the builder from the incoming InputType:
    in_channels: Optional[int] = None

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "cnn":
            raise ValueError(
                f"ConvolutionLayer expects CNN input, got {in_type}")
        self.in_channels = in_type.channels
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        dh, dw = self.dilation
        sh, sw = self.stride
        ph, pw = self.padding
        # dilation widens the receptive field: k_eff = (k - 1) * d + 1
        h = _out_size(in_type.height, (kh - 1) * dh + 1, sh, ph,
                      self.convolution_mode)
        w = _out_size(in_type.width, (kw - 1) * dw + 1, sw, pw,
                      self.convolution_mode)
        return InputType.convolutional(h, w, self.n_out)

    def param_order(self) -> List[str]:
        return ["W", "b"] if self.has_bias else ["W"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        kh, kw = self.kernel_size
        p = {"W": self._init_w(gen, (kh, kw, self.in_channels, self.n_out),
                               self.in_channels * kh * kw,
                               self.n_out * kh * kw, dtype)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype)
        return p

    def _conv(self, params, x):
        return conv2d_nhwc(x, params["W"], self.stride, self.padding,
                           self.dilation, self.convolution_mode)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng).to(params["W"].dtype)
        out = self._conv(params, x)
        if self.has_bias:
            out = out + params["b"]
        return get_activation(self.activation)(out), state


@register_layer
@dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-D convolution over the time axis of [B, T, F]; kernel ``W``
    ``[k, in, out]``. Only the first entry of ``kernel_size``, ``stride``,
    ``padding`` and ``dilation`` applies."""
    kernel_size: Tuple[int, int] = (3, 1)

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"Convolution1D expects RNN input, got {in_type}")
        self.in_channels = in_type.size
        self.n_in = in_type.size

    def infer_output_type(self, in_type: InputType) -> InputType:
        k = (self.kernel_size[0] - 1) * self.dilation[0] + 1
        t = in_type.timesteps
        t_out = None if t is None else _out_size(
            t, k, self.stride[0], self.padding[0], self.convolution_mode)
        return InputType.recurrent(self.n_out, t_out)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        k = self.kernel_size[0]
        p = {"W": self._init_w(gen, (k, self.in_channels, self.n_out),
                               self.in_channels * k, self.n_out * k, dtype)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype)
        return p

    def _conv(self, params, x):
        # [B, T, F] as [B, T, 1, F], the kernel as [k, 1, in, out]; the JAX
        # layer does not cast the input to the kernel's dtype
        return conv2d_nhwc(x[:, :, None, :], params["W"][:, None],
                           (self.stride[0], 1), (self.padding[0], 0),
                           (self.dilation[0], 1),
                           self.convolution_mode)[:, :, 0, :]

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        out = self._conv(params, x)
        if self.has_bias:
            out = out + params["b"]
        return get_activation(self.activation)(out), state


@register_layer
@dataclass
class SubsamplingLayer(BaseLayerConf):
    """Max / avg / pnorm / sum pooling over (H, W) of NHWC input."""
    pooling_type: str = "max"   # max | avg | pnorm | sum
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "cnn":
            raise ValueError(
                f"SubsamplingLayer expects CNN input, got {in_type}")
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        h = _out_size(in_type.height, kh, sh, ph, self.convolution_mode)
        w = _out_size(in_type.width, kw, sw, pw, self.convolution_mode)
        return InputType.convolutional(h, w, in_type.channels)

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return pool2d_nhwc(x, self.pooling_type, self.kernel_size,
                           self.stride, self.padding, self.convolution_mode,
                           float(self.pnorm)), state


@register_layer
@dataclass
class Subsampling1DLayer(SubsamplingLayer):
    """1-D pooling over T of [B, T, F]. As in the JAX layer, ``max`` takes
    the maximum and every other type the window's sum, which ``avg``
    divides by the kernel size (also under ``same``)."""

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"Subsampling1D expects RNN input, got {in_type}")
        self.n_in = in_type.size

    def infer_output_type(self, in_type: InputType) -> InputType:
        t = in_type.timesteps
        t_out = None if t is None else _out_size(
            t, self.kernel_size[0], self.stride[0], self.padding[0],
            self.convolution_mode)
        return InputType.recurrent(in_type.size, t_out)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        k = self.kernel_size[0]
        kind = "max" if self.pooling_type == "max" else "sum"
        out = pool2d_nhwc(x[:, :, None, :], kind, (k, 1),
                          (self.stride[0], 1), (self.padding[0], 0),
                          self.convolution_mode)[:, :, 0, :]
        if self.pooling_type == "avg":
            out = out / k
        return out, state


@register_layer
@dataclass
class ZeroPaddingLayer(BaseLayerConf):
    """Spatial zero padding of NHWC input; ``pad`` = (top, bottom, left,
    right)."""
    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        t, b, left, right = self.pad
        return InputType.convolutional(in_type.height + t + b,
                                       in_type.width + left + right,
                                       in_type.channels)

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        t, b, left, right = self.pad
        return F.pad(x, (0, 0, left, right, t, b)), state
