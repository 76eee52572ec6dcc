"""The char-LSTM serving slice of the port against the JAX package: the
fused LSTM recurrence K1 (``ops/fused_lstm``), each recurrent layer, the
sequential container (``MultiLayerNetwork.output`` and ``rnn_time_step``),
``ComputationGraph.rnn_time_step`` and ``char_rnn_lstm``, on the same
inputs (numpy, fixed seed) and the same weights (carried across with
``convert.params_from_jax``).

The JAX side runs as its own tests run it on the CPU: its Pallas LSTM
kernel in interpret mode (``DL4J_TPU_PALLAS=interpret``) where it takes
the kernel path, ``lax.scan`` (``=0``) otherwise. On the CPU the port's
wrapper runs its plain version, so these tests hold that plain version to
the TPU kernel's contract; the CUDA kernel is held against the same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py). Sizes are
small and deliberately not multiples of 8 (the JAX wrapper pads H to 128
and B to 8; the port does not pad). Tolerance: atol 1e-5, the JAX
package's own for the fused LSTM forward (tests/test_pallas_kernels.py).

Where trouble was expected, a test names it: the forget bias added at
every step, the peephole order (i and f read c_prev, o reads c_new), the
mask carrying (h, c) through, the bidirectional sum, and streaming.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import pallas_kernels as jpk

from deeplearning4j_tpu_torch.convert import (
    layer_params_from_jax, params_from_jax,
)
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor, FeedForwardToRnnPreProcessor,
    RnnToFeedForwardPreProcessor, auto_preprocessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_lstm as tfl

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
B, T, F, H = 3, 7, 5, 13


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _post_mask(b=B, t=T):
    m = np.ones((b, t), np.float32)
    m[1, 4:] = 0.0
    m[2, 2:] = 0.0
    return m


def _pre_mask(b=B, t=T):
    m = np.ones((b, t), np.float32)
    m[1, :3] = 0.0
    m[2, :5] = 0.0
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------ K1 and its core

def _core_inputs(seed, peephole, Hh=H, Bb=B, Tt=T):
    xz = _x(seed, Tt, Bb, 4 * Hh)
    rw = _x(seed + 1, Hh, 4 * Hh, scale=0.3)
    pw = _x(seed + 2, 3, Hh, scale=0.5) if peephole else np.zeros(
        (3, Hh), np.float32)
    h0 = _x(seed + 3, Bb, Hh, scale=0.5)
    c0 = _x(seed + 4, Bb, Hh)
    return xz, rw, pw, h0, c0


@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "nopeep"])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_plain_matches_jax_infer_kernel(peephole, forget_bias):
    """The plain recurrence against the TPU kernel body itself
    (``_run_lstm_fwd_infer`` in interpret mode, unpadded), with nonzero
    h0/c0: hs, h_T and c_T."""
    xz, rw, pw, h0, c0 = _core_inputs(0, peephole)
    hs_j, cT_j = jpk._run_lstm_fwd_infer(
        *map(jnp.asarray, (xz, rw, pw, h0, c0)), forget_bias, True)
    hs, hT, cT = tfl.lstm_recurrence_plain(
        *map(_t, (xz, rw, pw, h0, c0)), forget_bias=forget_bias)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hs_j)[-1], atol=ATOL)
    np.testing.assert_allclose(cT.numpy(), np.asarray(cT_j), atol=ATOL)


@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "nopeep"])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_fused_lstm_matches_jax_fused_lstm(peephole, forget_bias):
    """The public batch-major entry point: the JAX one pads H to 128 and B
    to 8 with zero gate blocks (exact), the port does not pad."""
    x = _x(1, B, T, F)
    w = _x(2, F, 4 * H, scale=0.4)
    rw = _x(3, H, 4 * H, scale=0.3)
    b = _x(4, 4 * H, scale=0.2)
    pw = _x(5, 3 * H, scale=0.5) if peephole else None
    h0, c0 = _x(6, B, H, scale=0.5), _x(7, B, H)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (x, w, rw, b, pw, h0, c0)]
    ys_j, hT_j, cT_j = jpk.fused_lstm(*jargs, forget_bias=forget_bias,
                                      interpret=True)
    targs = [None if a is None else _t(a) for a in (x, w, rw, b, pw, h0, c0)]
    ys, hT, cT = tfl.fused_lstm(*targs, forget_bias=forget_bias)
    assert ys.shape == (B, T, H)
    for got, ref in ((ys, ys_j), (hT, hT_j), (cT, cT_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args = [_t(a) for a in _core_inputs(3, True)]
    before = tfl.lstm_recurrence.launches
    hs, hT, cT = tfl.lstm_recurrence(*args, forget_bias=1.0)
    ref = tfl.lstm_recurrence_plain(*args, forget_bias=1.0)
    assert tfl.lstm_recurrence.launches == before
    assert all(torch.equal(a, b) for a, b in zip((hs, hT, cT), ref))


def test_bf16_keeps_the_carry_in_bf16_and_tracks_f32():
    """bf16 inputs: f32 arithmetic, the carry rounded to bf16 after each
    step, outputs in bf16; within 3e-2 (four bf16 ulps of 1.0) of the f32
    recurrence on the same (bf16-representable) inputs. T=1 equals one
    streaming step of the same contract exactly."""
    args = [_t(a).to(torch.bfloat16) for a in _core_inputs(4, True)]
    hs, hT, cT = tfl.lstm_recurrence(*args, forget_bias=1.0)
    assert hs.dtype == hT.dtype == cT.dtype == torch.bfloat16
    ref = tfl.lstm_recurrence_plain(*[a.float() for a in args],
                                    forget_bias=1.0)
    for got, want in zip((hs, hT, cT), ref):
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=3e-2)
    # streaming one step at a time through the bf16 carry is the same
    h, c = args[3], args[4]
    for t in range(T):
        step, h, c = tfl.lstm_recurrence(args[0][t:t + 1].contiguous(),
                                         args[1], args[2], h, c,
                                         forget_bias=1.0)
        assert torch.equal(step[0], hs[t])
    assert torch.equal(c, cT)


def _bf16_recurrence_in_order(xz, rw, pw, order):
    """The bf16 contract (f32 arithmetic, carry rounded to bf16 each step,
    forget bias 1, zero h0/c0) with z = xz[t] + h @ rw summed in a given
    f32 order, every fused multiply-add and add rounded to f32 exactly
    (products of f32 values are exact in f64). ``order``: "gemm" sums the
    product in one sequence and adds xz last (the plain version's
    structure, a GEMM then an add); "kernel" sums it in the CUDA kernel's
    four k-slices, each a chain of fmaf, slices added in turn, and adds xz
    last; "xz_first" is the kernel's order with xz starting slice 0's
    chain instead. Returns (hs, c_T) as float64 arrays of bf16 values."""
    f32 = lambda a: a.astype(np.float32).astype(np.float64)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).double().numpy()
    sig = lambda a: f32(1.0 / (1.0 + np.exp(-a)))
    Tn, Bn, H4 = xz.shape
    Hn = H4 // 4

    def chain(h, k0, k1, acc):
        for k in range(k0, k1):
            acc = f32(h[:, k:k + 1] * rw[k] + acc)
        return acc

    h, c = np.zeros((Bn, Hn)), np.zeros((Bn, Hn))
    hs = []
    for t in range(Tn):
        zero = np.zeros((Bn, H4))
        if order == "gemm":
            z = f32(chain(h, 0, Hn, zero) + xz[t])
        else:
            kc = Hn // 4
            z = chain(h, 0, kc, xz[t] if order == "xz_first" else zero)
            for s in range(1, 4):
                z = f32(z + chain(h, s * kc, (s + 1) * kc, zero))
            if order == "kernel":
                z = f32(z + xz[t])
        zi, zf, zg, zo = (z[:, q * Hn:(q + 1) * Hn] for q in range(4))
        i = sig(f32(zi + f32(c * pw[0])))
        f = sig(f32(f32(zf + f32(c * pw[1])) + 1.0))
        c_new = f32(f32(f * c) + f32(i * f32(np.tanh(zg))))
        o = sig(f32(zo + f32(c_new * pw[2])))
        h, c = bf16(f32(o * f32(np.tanh(c_new)))), bf16(c_new)
        hs.append(h)
    return np.stack(hs), c


def test_bf16_kernel_order_adds_xz_after_the_product():
    """Why the CUDA kernel adds xz[t] after its sum of h @ rw. On the
    inputs of chip_smoke.py's bf16 case (T=64, B=32, H=256), the kernel's
    order stays within the card tolerance of the plain version's (4 bf16
    ulps of 1.0; c_T scaled by max |c|). Starting the sum at xz instead
    moves one unit's c_T by more than that, while h stays within it: a
    bf16 rounding of c that flips, in a unit whose forget gate is near 1,
    is kept for every later step. The order of an f32 sum alone decides
    it, so over many bf16 steps the kernel is also held step by step on
    the card (chip_smoke.py, tests/test_torch_cuda.py)."""
    Tn, Bn, Hn = 64, 32, 256
    g = torch.Generator().manual_seed(1234 + Tn + Bn + Hn)
    rw = torch.randn(Hn, 4 * Hn, generator=g) * Hn ** -0.5
    pw = torch.randn(3, Hn, generator=g) * 0.3
    xz = torch.randn(Tn, Bn, 4 * Hn, generator=g)
    xz, rw, pw = (a.to(torch.bfloat16).double().numpy() for a in (xz, rw, pw))
    hs_ref, c_ref = _bf16_recurrence_in_order(xz, rw, pw, "gemm")
    tol = 3.2e-2
    tol_c = tol * max(1.0, float(np.abs(c_ref).max()))
    hs, c = _bf16_recurrence_in_order(xz, rw, pw, "kernel")
    assert np.abs(hs - hs_ref).max() <= tol
    assert np.abs(c - c_ref).max() <= tol_c
    hs, c = _bf16_recurrence_in_order(xz, rw, pw, "xz_first")
    assert np.abs(hs - hs_ref).max() <= tol
    assert np.abs(c - c_ref).max() > tol_c


@pytest.mark.parametrize("bad", ["dtype_mix", "float16", "noncontig",
                                 "rw_shape", "h0_shape", "xz_rank", "T0",
                                 "too_wide"])
def test_inputs_outside_the_contract_raise(bad):
    xz, rw, pw, h0, c0 = [_t(a) for a in _core_inputs(5, True)]
    if bad == "dtype_mix":
        rw = rw.to(torch.bfloat16)
    elif bad == "float16":
        xz, rw, pw, h0, c0 = (a.half() for a in (xz, rw, pw, h0, c0))
    elif bad == "noncontig":
        rw = torch.zeros(4 * H, H).t()
    elif bad == "rw_shape":
        rw = torch.zeros(H + 1, 4 * H)
    elif bad == "h0_shape":
        h0 = torch.zeros(B + 1, H)
    elif bad == "xz_rank":
        xz = xz[0]
    elif bad == "T0":
        xz = xz[:0]
    elif bad == "too_wide":
        Hw = tfl.MAX_HIDDEN + 1
        xz, rw = torch.zeros(1, 1, 4 * Hw), torch.zeros(Hw, 4 * Hw)
        pw, h0, c0 = torch.zeros(3, Hw), torch.zeros(1, Hw), torch.zeros(1, Hw)
    with pytest.raises(ValueError):
        tfl.check_inputs(xz, rw, pw, h0, c0)
    with pytest.raises(ValueError):
        tfl.lstm_recurrence(xz, rw, pw, h0, c0)


# ------------------------------------------------------------------- layers

def _pair(jcls, tcls, *, random_params=True, n_in=F, seed=0, **kw):
    """Shape a JAX layer and its port twin for [B, T, n_in] input; the JAX
    layer draws the weights (``random_params`` then overwrites every one
    with seeded noise, so zero-initialised b and pW are exercised too),
    and they are carried into the port."""
    jl, tl = jcls(**kw), tcls(**kw)
    jl.set_n_in(JInputType.recurrent(n_in, T))
    tl.set_n_in(InputType.recurrent(n_in, T))
    jp = jl.init_params(jax.random.PRNGKey(seed))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    if random_params:
        np_p = {k: _x(seed + i + 1, *v.shape, scale=0.4)
                for i, (k, v) in enumerate(sorted(np_p.items()))}
        jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    return jl, tl, jp, layer_params_from_jax(tl, np_p)


def _apply_both(jl, tl, jp, tp, x, mask=None):
    ref, _ = jl.apply(jp, jnp.asarray(x), state={}, train=False, rng=None,
                      mask=None if mask is None else jnp.asarray(mask))
    got, _ = tl.apply(tp, _t(x), state={},
                      mask=None if mask is None else _t(mask))
    return got.numpy(), np.asarray(ref)


LAYER_CASES = {
    "LSTM": (jrec.LSTM, trec.LSTM, dict(n_out=H, activation="tanh")),
    "GravesLSTM": (jrec.GravesLSTM, trec.GravesLSTM,
                   dict(n_out=H, activation="tanh")),
    "GravesBidirectionalLSTM": (jrec.GravesBidirectionalLSTM,
                                trec.GravesBidirectionalLSTM,
                                dict(n_out=H, activation="tanh")),
    "LSTM-hardsigmoid-softsign": (jrec.LSTM, trec.LSTM,
                                  dict(n_out=H, activation="softsign",
                                       gate_activation="hardsigmoid")),
    "SimpleRnn": (jrec.SimpleRnn, trec.SimpleRnn,
                  dict(n_out=H, activation="tanh")),
    "GRU-reset_after": (jrec.GRU, trec.GRU,
                        dict(n_out=H, activation="tanh", reset_after=True)),
    "GRU-classic": (jrec.GRU, trec.GRU,
                    dict(n_out=H, activation="tanh", reset_after=False)),
}


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_recurrent_layer_matches_jax(monkeypatch, case, masked):
    """Unmasked LSTMs take the kernel path on both sides (the JAX kernel in
    interpret mode); masked ones and other activations take the step loop
    (``lax.scan`` in JAX). Masked steps output 0."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jcls, tcls, kw = LAYER_CASES[case]
    jl, tl, jp, tp = _pair(jcls, tcls, **kw)
    x = _x(11, B, T, F)
    mask = _post_mask() if masked else None
    got, ref = _apply_both(jl, tl, jp, tp, x, mask)
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if masked:
        assert np.all(got[1, 4:] == 0.0) and np.all(got[2, 2:] == 0.0)


def test_forget_bias_default_added_every_step(monkeypatch):
    """The default forget_gate_bias_init (1.0) is added to f's
    pre-activation at every step, with b at its zero init: it is no bias
    init. Dropping it changes the output far beyond the tolerance."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jl, tl, jp, tp = _pair(jrec.GravesLSTM, trec.GravesLSTM,
                           random_params=False, n_out=H, activation="tanh")
    assert tl.forget_gate_bias_init == 1.0
    assert not tp["b"].any() and not tp["pW"].any()
    x = _x(12, B, T, F)
    got, ref = _apply_both(jl, tl, jp, tp, x)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    tl.forget_gate_bias_init = 0.0
    dropped, _ = _apply_both(jl, tl, jp, tp, x)
    assert np.abs(dropped - ref).max() > 1e-2


def test_peepholes_i_f_read_c_prev_and_o_reads_c_new():
    """One step from a nonzero c0 with only one peephole row set at a time:
    each row moves the output exactly as the contract says."""
    Hh = 4
    xz = _x(13, 1, 2, 4 * Hh)
    rw = np.zeros((Hh, 4 * Hh), np.float32)
    h0 = np.zeros((2, Hh), np.float32)
    c0 = _x(14, 2, Hh)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    zi, zf, zg, zo = np.split(xz[0], 4, axis=-1)
    for row in range(3):
        pw = np.zeros((3, Hh), np.float32)
        pw[row] = 0.7
        _, hT, cT = tfl.lstm_recurrence_plain(
            *map(_t, (xz, rw, pw, h0, c0)), forget_bias=1.0)
        i = sig(zi + c0 * pw[0])
        f = sig(zf + c0 * pw[1] + 1.0)
        c_new = f * c0 + i * np.tanh(zg)
        o = sig(zo + c_new * pw[2])
        np.testing.assert_allclose(cT.numpy(), c_new, atol=1e-6)
        np.testing.assert_allclose(hT.numpy(), o * np.tanh(c_new), atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_lstm_scan_with_carry_matches_jax(monkeypatch, reverse, masked):
    """``scan`` from a nonzero carry, forwards and reversed: outputs and the
    final (h, c), on the kernel path and the masked step loop. A masked
    step carries (h, c) through unchanged."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jl, tl, jp, tp = _pair(jrec.GravesLSTM, trec.GravesLSTM, n_out=H,
                           activation="tanh")
    x = _x(15, B, T, F)
    h0, c0 = _x(16, B, H, scale=0.5), _x(17, B, H)
    mask = _pre_mask() if masked else None
    ys_j, (h_j, c_j) = jl.scan(jp, jnp.asarray(x), (jnp.asarray(h0),
                                                   jnp.asarray(c0)),
                               None if mask is None else jnp.asarray(mask),
                               reverse=reverse)
    ys, (h, c) = tl.scan(tp, _t(x), (_t(h0), _t(c0)),
                         None if mask is None else _t(mask), reverse=reverse)
    for got, ref in ((ys, ys_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("padding", ["post", "pre", "none"])
def test_last_time_step_layer_matches_jax(padding):
    jl, tl = jrec.LastTimeStepLayer(), trec.LastTimeStepLayer()
    jl.set_n_in(JInputType.recurrent(F, T))
    tl.set_n_in(InputType.recurrent(F, T))
    x = _x(18, B, T, F)
    mask = {"post": _post_mask(), "pre": _pre_mask(), "none": None}[padding]
    got, ref = _apply_both(jl, tl, {}, {}, x, mask)
    assert got.shape == (B, F)
    np.testing.assert_allclose(got, ref, atol=0)
    assert tl.propagate_mask(mask) is None
    assert tl.infer_output_type(InputType.recurrent(F, T)) == \
        InputType.feed_forward(F)


def test_fused_kernel_ok_decides_from_the_arguments(monkeypatch):
    """The kernel path is taken iff there is no mask, the gates are sigmoid
    and the activation tanh, and H fits the kernel; anything else runs the
    step loop. Spied on the CPU, where the plain version stands in."""
    calls = []
    real = trec.fused_lstm
    monkeypatch.setattr(trec, "fused_lstm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tl, _, tp = _pair(jrec.LSTM, trec.LSTM, n_out=H, activation="tanh")
    x = _t(_x(19, B, T, F))
    carry = tl.initial_carry(B)
    tl.scan(tp, x, carry, None)
    assert calls == [1] and tl._fused_kernel_ok(None)
    tl.scan(tp, x, carry, _t(_post_mask()))
    assert calls == [1] and not tl._fused_kernel_ok(_t(_post_mask()))
    tl.gate_activation = "hardsigmoid"
    assert not tl._fused_kernel_ok(None)
    tl.gate_activation, tl.activation = "sigmoid", "relu"
    assert not tl._fused_kernel_ok(None)
    tl.activation, tl.n_out = "tanh", tfl.MAX_HIDDEN + 1
    assert not tl._fused_kernel_ok(None)


def test_bidirectional_adds_directions_and_does_not_stream():
    _, tl, _, tp = _pair(jrec.GravesBidirectionalLSTM,
                         trec.GravesBidirectionalLSTM, n_out=H,
                         activation="tanh")
    assert tl.supports_carry is False
    x = _t(_x(20, B, T, F))
    carry = tl.initial_carry(B)
    fwd = {k: tp[k] for k in ("W", "RW", "b", "pW")}
    bwd = {k: tp[f"{k}_bwd"] for k in ("W", "RW", "b", "pW")}
    want = tl.scan(fwd, x, carry, None)[0] + tl.scan(
        bwd, x, carry, None, reverse=True)[0]
    got, _ = tl.apply(tp, x, state={})
    assert torch.equal(got, want)


def test_port_init_draws_the_jax_param_shapes_with_the_lstm_fans():
    """Init: W and RW both use fan_in = n_in + H and fan_out = 4H; b and pW
    start at zeros. Same names and shapes as the JAX init."""
    for name, (jcls, tcls, kw) in LAYER_CASES.items():
        jl, tl, jp, _ = _pair(jcls, tcls, random_params=False, **kw)
        tp = tl.init_params(torch.Generator().manual_seed(0))
        assert tl.param_order() == jl.param_order()
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}, name
    tl = trec.GravesLSTM(n_out=H, weight_init="xavier_uniform")
    tl.set_n_in(InputType.recurrent(F))
    tp = tl.init_params(torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / ((F + H) + 4 * H))
    for k in ("W", "RW"):
        assert tp[k].abs().max() <= limit and tp[k].abs().max() > 0.9 * limit
    assert not tp["b"].any() and not tp["pW"].any()


# ------------------------------------------------------- the containers

V, HID = 11, 10


def _char_nets(**kw):
    jconf = jchar_rnn(V, hidden=HID, layers=2, **kw)
    jnet = JNet(jconf).init()
    conf = char_rnn_lstm(V, hidden=HID, layers=2, **kw)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _chars(seed, b=B, t=T):
    tok = np.random.default_rng(seed).integers(0, V, (b, t))
    return np.eye(V, dtype=np.float32)[tok]


def test_char_rnn_config_matches_jax():
    """Two GravesLSTMs and a softmax RnnOutputLayer; rnn -> rnn, so no
    preprocessor is inserted; the same parameter count and shapes."""
    conf = char_rnn_lstm(96, hidden=256, layers=2)
    jconf = jchar_rnn(96, hidden=256, layers=2)
    assert [type(l).__name__ for l in conf.layers] == \
        [type(l).__name__ for l in jconf.layers]
    assert conf.preprocessors == {} and jconf.preprocessors == {}
    assert [l.n_in for l in conf.layers] == [96, 256, 256]
    assert conf.training.backprop_type == "truncated_bptt"
    assert conf.training.gradient_normalization == \
        "clipelementwiseabsolutevalue"
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert net.num_params() == 912_992
    jnet = JNet(jconf).init()
    assert net.num_params() == jnet.num_params()
    for tp, jp in zip(net.params, jnet.params):
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
    again = MultiLayerNetwork(char_rnn_lstm(96, hidden=256, layers=2),
                              device="cpu").init()
    assert all(torch.equal(a, b) for p, q in zip(net.params, again.params)
               for a, b in zip(p.values(), q.values()))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_char_rnn_output_matches_jax(monkeypatch, masked):
    """``MultiLayerNetwork.output``: unmasked through the kernel path on
    both sides; masked through the step loops. The head takes no mask (the
    JAX container applies its loss head after the forward), so a masked
    step's output is softmax(b): every row sums to 1."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, tnet = _char_nets()
    x = _chars(21)
    mask = _post_mask() if masked else None
    ref = np.asarray(jnet.output(x, mask=mask))
    got = tnet.output(x, mask=mask).numpy()
    assert got.shape == (B, T, V)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if masked:
        head = tnet.params[-1]["b"]
        np.testing.assert_allclose(
            got[2, 2:], np.broadcast_to(torch.softmax(head, -1).numpy(),
                                        (T - 2, V)), atol=1e-6)
    np.testing.assert_array_equal(tnet.predict(x), np.asarray(
        jnet.predict(x)))


def test_char_rnn_plain_lstm_cells_match_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, tnet = _char_nets(graves=False)
    x = _chars(22)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)


@pytest.mark.parametrize("mode", ["step2d", "step3d", "chunks"])
def test_rnn_time_step_matches_jax_and_output(monkeypatch, mode):
    """Streaming: one step at a time as [B, F] (squeezed back to [B, V]) or
    [B, 1, F], or in chunks of 3; each call against JAX's rnn_time_step,
    the whole stream against output(). Clearing the state restarts."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, tnet = _char_nets(seed=5)
    x = _chars(23)
    full = tnet.output(x).numpy()
    if mode == "chunks":
        pieces = [x[:, t:t + 3] for t in range(0, T, 3)]
    elif mode == "step2d":
        pieces = [x[:, t] for t in range(T)]
    else:
        pieces = [x[:, t:t + 1] for t in range(T)]
    got = []
    for p in pieces:
        g = tnet.rnn_time_step(p).numpy()
        assert g.shape == (p.shape[:1] + (V,) if p.ndim == 2
                           else p.shape[:2] + (V,))
        np.testing.assert_allclose(g, np.asarray(jnet.rnn_time_step(p)),
                                   atol=ATOL)
        got.append(g if g.ndim == 3 else g[:, None])
    np.testing.assert_allclose(np.concatenate(got, axis=1), full, atol=ATOL)
    tnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    again = tnet.rnn_time_step(pieces[0]).numpy()
    np.testing.assert_allclose(again, got[0].reshape(again.shape), atol=0)
    np.testing.assert_allclose(again, np.asarray(
        jnet.rnn_time_step(pieces[0])), atol=ATOL)


def _stack_confs(jb, tb):
    """LSTM -> DenseLayer -> RnnOutputLayer from both builders: the dense
    layer gets an auto RnnToFeedForward preprocessor, the head a
    FeedForwardToRnn one."""
    for b, rec, core in ((jb, jrec, jcore), (tb, trec, tcore)):
        b.layer(rec.LSTM(n_out=HID, activation="tanh"))
        b.layer(core.DenseLayer(n_out=6, activation="relu"))
        b.layer(rec.RnnOutputLayer(n_out=V, activation="softmax"))
    return (jb.set_input_type(JInputType.recurrent(F)).build(),
            tb.set_input_type(InputType.recurrent(F)).build())


def test_preprocessors_and_a_mixed_stack_match_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jconf, conf = _stack_confs(JNNC.builder().seed(3).list(),
                               NeuralNetConfiguration.builder().seed(3)
                               .list())
    assert {i: type(p).__name__ for i, p in conf.preprocessors.items()} == \
        {i: type(p).__name__ for i, p in jconf.preprocessors.items()} == \
        {1: "RnnToFeedForwardPreProcessor",
         2: "FeedForwardToRnnPreProcessor"}
    jnet = JNet(jconf).init()
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    x = _x(24, B, T, F)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)
    acts = tnet.feed_forward(x)
    assert len(acts) == 3 and torch.equal(acts[-1], tnet.output(x))


def test_auto_preprocessor_choices():
    rnn, ff = InputType.recurrent(4), InputType.feed_forward(4)
    assert auto_preprocessor(rnn, "rnn") is None
    assert auto_preprocessor(rnn, "any") is None
    assert isinstance(auto_preprocessor(rnn, "ff"),
                      RnnToFeedForwardPreProcessor)
    assert isinstance(auto_preprocessor(ff, "rnn"),
                      FeedForwardToRnnPreProcessor)
    cnn, flat = (InputType.convolutional(2, 2, 1),
                 InputType.convolutional_flat(2, 2, 1))
    assert isinstance(auto_preprocessor(cnn, "ff"),
                      CnnToFeedForwardPreProcessor)
    assert isinstance(auto_preprocessor(cnn, "rnn"), CnnToRnnPreProcessor)
    assert auto_preprocessor(flat, "cnn") == FeedForwardToCnnPreProcessor(
        2, 2, 1)
    with pytest.raises(ValueError, match="Cannot infer CNN shape"):
        auto_preprocessor(ff, "cnn")


def test_list_builder_checks():
    with pytest.raises(ValueError, match="No layers"):
        NeuralNetConfiguration.builder().list().build()
    with pytest.raises(ValueError, match="n_in not set"):
        NeuralNetConfiguration.builder().list().layer(
            trec.LSTM(n_out=3)).build()
    with pytest.raises(ValueError, match="truncated_bptt"):
        (NeuralNetConfiguration.builder().list()
         .layer(trec.LSTM(n_out=3)).layer(trec.LastTimeStepLayer())
         .backprop_type("truncated_bptt")
         .set_input_type(InputType.recurrent(4)).build())
    with pytest.raises(ValueError):
        (NeuralNetConfiguration.builder().list()
         .layer(trec.LSTM(n_out=3, gate_activation="nope"))
         .set_input_type(InputType.recurrent(4)).build())


def _graph_confs():
    def build(nnc, rec, itype):
        return (nnc.builder().seed(11).graph_builder()
                .add_inputs("in")
                .add_layer("lstm", rec.GravesLSTM(n_out=6, activation="tanh"),
                           "in")
                .add_layer("out", rec.RnnOutputLayer(
                    n_out=3, activation="softmax"), "lstm")
                .set_outputs("out")
                .set_input_types(itype.recurrent(4, 6)).build())
    return (build(JNNC, jrec, JInputType),
            build(NeuralNetConfiguration, trec, InputType))


@pytest.mark.parametrize("chunk", [1, 2], ids=["steps", "chunks2"])
def test_graph_rnn_time_step_matches_jax(monkeypatch, chunk):
    """ComputationGraph.rnn_time_step on a small LSTM graph: per call
    against JAX, the stream against output(); clearing restarts."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jconf, conf = _graph_confs()
    jnet = JGraph(jconf).init()
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    x = _x(25, 2, 6, 4)
    full = tnet.output(x).numpy()
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)), atol=ATOL)
    got = []
    for t in range(0, 6, chunk):
        piece = x[:, t] if chunk == 1 else x[:, t:t + chunk]
        g = tnet.rnn_time_step(piece).numpy()
        np.testing.assert_allclose(g, np.asarray(jnet.rnn_time_step(piece)),
                                   atol=ATOL)
        got.append(g if g.ndim == 3 else g[:, None])
    np.testing.assert_allclose(np.concatenate(got, axis=1), full, atol=ATOL)
    tnet.rnn_clear_previous_state()
    first = tnet.rnn_time_step(x[:, :chunk] if chunk > 1 else x[:, 0])
    np.testing.assert_allclose(first.numpy(), got[0].reshape(first.shape),
                               atol=0)


def test_multilayer_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = char_rnn_lstm(V, hidden=HID, layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf)
    assert MultiLayerNetwork(conf, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="init"):
        MultiLayerNetwork(conf, device="cpu").output(_chars(0))


def test_import_check_walks_the_lstm_slice_modules():
    """tests/test_torch_gpt.py bans JAX imports in every .py under the port
    package; this slice's modules are among the files it walks."""
    files = set((ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))
    new = {ROOT / "deeplearning4j_tpu_torch" / p for p in (
        "ops/fused_lstm.py", "nn/layers/recurrent.py", "nn/multilayer.py",
        "nn/conf/preprocessors.py", "nn/conf/builder.py", "nn/graph.py",
        "models/char_rnn.py", "convert.py")}
    assert new <= files
