"""Recurrent layers (the JAX package's ``nn/layers/recurrent.py``): LSTM /
GravesLSTM (peepholes) / GravesBidirectionalLSTM, SimpleRnn, GRU,
RnnOutputLayer (with its loss) and LastTimeStepLayer.

Param layout (the JAX package's contract, so weights carry across as
copies): W ``[n_in, 4H]``, RW ``[H, 4H]``, b ``[4H]``; Graves peepholes pW
``[3H]`` (input/forget/output gates see c). **Gate block order is
(i, f, g, o).** ``forget_gate_bias_init`` is added to the forget gate's
pre-activation at every step; ``b`` itself starts at zeros.

``LSTM.scan`` sends an unmasked sequence with sigmoid gates and a tanh
activation through the fused kernel path (``ops/fused_lstm``: on the card
the inference kernel K1, or the training kernels K2 and K3 when a
gradient is needed; their plain versions on the CPU), differentiable in
the weights and the carry (h0, c0); the reverse direction of the
bidirectional layer runs it on the flipped sequence. Anything else runs
the ``_lstm_cell`` step loop, differentiable through autograd, where the
JAX package runs ``lax.scan``. Masked steps carry (h, c) through
unchanged and output zeros. ``step`` and ``scan`` with a carry serve
stateful streaming (``rnn_time_step``) and truncated BPTT.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.fused_lstm import MAX_HIDDEN, fused_lstm
from deeplearning4j_tpu_torch.ops.losses import get_loss, promote_loss_dtype

Tensor = torch.Tensor


def _lstm_cell(params: Params, x_t: Tensor, h: Tensor, c: Tensor,
               gate_act, out_act, forget_bias: float,
               peephole: bool) -> Tuple[Tensor, Tensor]:
    """One LSTM step. Gate order (i, f, g, o)."""
    z = x_t @ params["W"] + h @ params["RW"] + params["b"]
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    if peephole:
        pi, pf, po = params["pW"].chunk(3, dim=-1)
        zi = zi + c * pi
        zf = zf + c * pf
    i = gate_act(zi)
    f = gate_act(zf + forget_bias)
    g = out_act(zg)
    c_new = f * c + i * g
    if peephole:
        zo = zo + c_new * po
    o = gate_act(zo)
    h_new = o * out_act(c_new)
    return h_new, c_new


def _step_loop(cell, x: Tensor, carry, mask: Optional[Tensor],
               reverse: bool):
    """``lax.scan`` over time for a single-tensor or (h, c) carry:
    ``cell(x_t, carry) -> (h_t, carry')``. A masked step keeps the carry
    and outputs 0. Returns ``([B, T, H], final carry)``."""
    T = x.shape[1]
    ys: List[Optional[Tensor]] = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        h, new = cell(x[:, t], carry)
        if mask is not None:
            m = mask[:, t, None]
            blend = (lambda a, b: m * a + (1 - m) * b)
            new = (tuple(blend(a, b) for a, b in zip(new, carry))
                   if isinstance(carry, tuple) else blend(new, carry))
            h = m * (new[0] if isinstance(new, tuple) else new)
        ys[t] = h
        carry = new
    return torch.stack(ys, dim=1), carry


class _RecurrentBase(BaseLayerConf):
    """Shape inference shared by the layers that read [B, T, F]."""

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"{type(self).__name__} expects RNN input, got {in_type}")
        self.n_in = in_type.size

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)


@register_layer
@dataclass
class LSTM(_RecurrentBase):
    """Standard LSTM (no peepholes)."""
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    _peephole = False
    # Containers thread (h, c) carries through layers with this set (the
    # rnn_time_step dispatch flag). Bidirectional layers cannot stream.
    supports_carry = True

    def param_order(self) -> List[str]:
        return ["W", "RW", "b"] + (["pW"] if self._peephole else [])

    def init_params(self, gen, dtype=torch.float32) -> Params:
        H = self.n_out
        fan_in, fan_out = self.n_in + H, 4 * H
        p = {
            "W": self._init_w(gen, (self.n_in, 4 * H), fan_in, fan_out,
                              dtype),
            "RW": self._init_w(gen, (H, 4 * H), fan_in, fan_out, dtype),
            "b": torch.zeros((4 * H,), dtype=dtype),
        }
        if self._peephole:
            p["pW"] = torch.zeros((3 * H,), dtype=dtype)
        return p

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        H = self.n_out
        return (torch.zeros((batch, H), dtype=dtype, device=device),
                torch.zeros((batch, H), dtype=dtype, device=device))

    def _acts(self):
        return (get_activation(self.gate_activation),
                get_activation(self.activation or "tanh"))

    def step(self, params: Params, x_t: Tensor, carry):
        """Single timestep for stateful inference."""
        h, c = carry
        gate_act, out_act = self._acts()
        h2, c2 = _lstm_cell(params, x_t, h, c, gate_act, out_act,
                            self.forget_gate_bias_init, self._peephole)
        return h2, (h2, c2)

    def _fused_kernel_ok(self, mask, dtype=torch.float32) -> bool:
        """The kernel path is taken iff the configuration is what the kernel
        hardcodes: no mask, sigmoid gates, tanh activation, a hidden size
        within the kernel's shared-memory carry (``MAX_HIDDEN``) and an
        input of one of its types (f32, bf16; a float64 net, such as a
        gradient check's, takes the step loop). The decision reads the
        arguments only, the same on every device."""
        return (mask is None and self.gate_activation == "sigmoid"
                and (self.activation or "tanh") == "tanh"
                and self.n_out <= MAX_HIDDEN
                and dtype in (torch.float32, torch.bfloat16))

    def scan(self, params: Params, x: Tensor, carry,
             mask: Optional[Tensor], reverse: bool = False):
        """Run the full sequence [B, T, F] -> ([B, T, H], final carry)."""
        if self._fused_kernel_ok(mask, x.dtype):
            h0, c0 = carry
            xin = torch.flip(x, dims=[1]) if reverse else x
            ys, hT, cT = fused_lstm(
                xin, params["W"], params["RW"], params["b"],
                params["pW"] if self._peephole else None, h0, c0,
                forget_bias=self.forget_gate_bias_init)
            if reverse:
                ys = torch.flip(ys, dims=[1])
            return ys, (hT, cT)
        gate_act, out_act = self._acts()

        def cell(x_t, hc):
            h2, c2 = _lstm_cell(params, x_t, hc[0], hc[1], gate_act, out_act,
                                self.forget_gate_bias_init, self._peephole)
            return h2, (h2, c2)
        return _step_loop(cell, x, tuple(carry), mask, reverse)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        carry = self.initial_carry(x.shape[0], x.dtype, x.device)
        ys, _ = self.scan(params, x, carry, mask)
        return ys, state


@register_layer
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections, as in Graves (2013)."""
    _peephole = True


@register_layer
@dataclass
class GravesBidirectionalLSTM(LSTM):
    """Bidirectional Graves LSTM; forward and backward outputs are
    **added**."""
    _peephole = True
    supports_carry = False  # backward direction needs the full sequence

    def param_order(self) -> List[str]:
        return ["W", "RW", "b", "pW", "W_bwd", "RW_bwd", "b_bwd", "pW_bwd"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        fwd = super().init_params(gen, dtype)
        bwd = super().init_params(gen, dtype)
        fwd.update({f"{k}_bwd": v for k, v in bwd.items()})
        return fwd

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        carry = self.initial_carry(x.shape[0], x.dtype, x.device)
        fwd_p = {k: params[k] for k in ("W", "RW", "b", "pW")}
        bwd_p = {k: params[f"{k}_bwd"] for k in ("W", "RW", "b", "pW")}
        ys_f, _ = self.scan(fwd_p, x, carry, mask)
        ys_b, _ = self.scan(bwd_p, x, carry, mask, reverse=True)
        return ys_f + ys_b, state


@register_layer
@dataclass
class SimpleRnn(_RecurrentBase):
    """Vanilla RNN: h_t = act(x_t W + h_{t-1} RW + b)."""
    n_out: int = 0

    supports_carry = True

    def param_order(self) -> List[str]:
        return ["W", "RW", "b"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        H = self.n_out
        return {
            "W": self._init_w(gen, (self.n_in, H), self.n_in, H, dtype),
            "RW": self._init_w(gen, (H, H), H, H, dtype),
            "b": self._init_b((H,), dtype),
        }

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def _cell(self, params, x_t, h):
        act = get_activation(self.activation or "tanh")
        return act(x_t @ params["W"] + h @ params["RW"] + params["b"])

    def step(self, params, x_t, carry):
        h = self._cell(params, x_t, carry)
        return h, h

    def scan(self, params, x, carry, mask: Optional[Tensor] = None,
             reverse: bool = False):
        return _step_loop(lambda x_t, h: self.step(params, x_t, h), x, carry,
                          mask, reverse)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        ys, _ = self.scan(params, x, self.initial_carry(
            x.shape[0], x.dtype, x.device), mask)
        return ys, state


@register_layer
@dataclass
class GRU(_RecurrentBase):
    """Gated recurrent unit, Keras-compatible gate layout (z, r, h blocks
    in ``W``/``RW``/``b``). ``reset_after=True`` applies the reset gate
    after the recurrent matmul and keeps a second recurrent bias ``b2``;
    ``False`` is the classic formulation."""
    n_out: int = 0
    gate_activation: str = "sigmoid"
    reset_after: bool = True

    supports_carry = True

    def param_order(self) -> List[str]:
        return ["W", "RW", "b"] + (["b2"] if self.reset_after else [])

    def init_params(self, gen, dtype=torch.float32) -> Params:
        H = self.n_out
        fan_in, fan_out = self.n_in + H, 3 * H
        p = {
            "W": self._init_w(gen, (self.n_in, 3 * H), fan_in, fan_out,
                              dtype),
            "RW": self._init_w(gen, (H, 3 * H), fan_in, fan_out, dtype),
            "b": torch.zeros((3 * H,), dtype=dtype),
        }
        if self.reset_after:
            p["b2"] = torch.zeros((3 * H,), dtype=dtype)
        return p

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def _cell(self, params, x_t, h):
        H = self.n_out
        gate = get_activation(self.gate_activation)
        act = get_activation(self.activation or "tanh")
        xz = x_t @ params["W"] + params["b"]
        if self.reset_after:
            hz = h @ params["RW"] + params["b2"]
            z = gate(xz[:, :H] + hz[:, :H])
            r = gate(xz[:, H:2 * H] + hz[:, H:2 * H])
            hh = act(xz[:, 2 * H:] + r * hz[:, 2 * H:])
        else:
            hz = h @ params["RW"][:, :2 * H]
            z = gate(xz[:, :H] + hz[:, :H])
            r = gate(xz[:, H:2 * H] + hz[:, H:])
            hh = act(xz[:, 2 * H:] + (r * h) @ params["RW"][:, 2 * H:])
        return z * h + (1.0 - z) * hh  # Keras update convention

    def step(self, params, x_t, carry):
        h = self._cell(params, x_t, carry)
        return h, h

    def scan(self, params, x, carry, mask: Optional[Tensor] = None,
             reverse: bool = False):
        return _step_loop(lambda x_t, h: self.step(params, x_t, h), x, carry,
                          mask, reverse)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        ys, _ = self.scan(params, x, self.initial_carry(
            x.shape[0], x.dtype, x.device), mask)
        return ys, state


@register_layer
@dataclass
class RnnOutputLayer(_RecurrentBase):
    """Per-timestep dense head over [B, T, F] with loss ``loss``."""
    n_out: int = 0
    loss: str = "mcxent"

    sequence_local = True

    def column_parallel_params(self, n_model: int) -> set:
        return {"W"}

    def _preout(self, params, x):
        from deeplearning4j_tpu_torch.parallel.tensor import column_linear
        return column_linear(x, params["W"], params["b"], self.n_out)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
        }

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        out = get_activation(self.activation)(self._preout(params, x))
        if mask is not None:
            out = out * mask[..., None]
        return out, state

    def compute_loss(self, params, x, labels, *, mask=None,
                     average: bool = True):
        """Loss from this head's *input* ``x``: per-timestep loss summed
        over time, masked steps excluded; the mean over the batch, or the
        ``[B, T]`` matrix with ``average=False``."""
        preout = self._preout(params, x)
        preout, labels = promote_loss_dtype(preout, labels)
        B, T, F = preout.shape
        flat_mask = mask.reshape(B * T) if mask is not None else None
        per = get_loss(self.loss)(labels.reshape(B * T, F),
                                  preout.reshape(B * T, F), self.activation,
                                  flat_mask)
        return per.reshape(B, T).sum(dim=1).mean() if average \
            else per.reshape(B, T)


@register_layer
@dataclass
class LastTimeStepLayer(_RecurrentBase):
    """[B, T, F] -> [B, F]: the last time step, or with a mask the last
    UNMASKED step per example (pre- or post-padding)."""

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(in_type.size)

    def param_order(self) -> List[str]:
        return []

    def propagate_mask(self, mask):
        return None  # output is [B, F]; the time mask is consumed here

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        if mask is None:
            return x[:, -1, :], state
        # index of the LAST step where mask == 1: the first 1 of the
        # reversed mask (argmax returns the first maximum)
        T = mask.shape[1]
        idx = T - 1 - torch.argmax((torch.flip(mask, dims=[1]) > 0).to(
            torch.int32), dim=1)
        out = torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0, :]
        return out, state
