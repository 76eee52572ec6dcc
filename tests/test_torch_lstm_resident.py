"""K1 and K2's resident body (``csrc/lstm_common.cuh``,
``lstm_fwd_steps_resident``) on the CPU: which hidden sizes it takes, and
a numpy emulation of its arithmetic held against the plain recurrence and
the JAX package's Pallas kernel (interpreted).

The body runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Its arithmetic is f32 on CUDA cores: each gate column's sum of h @ rw
runs over 8 slices of k (H padded with zero rows to a multiple of 32),
each slice one chain of fused multiply-adds in k order, the slices added
in turn, then xz[t] added to the sum. The emulation rounds every
multiply-add and add to f32 (products of f32 values are exact in f64) and,
for bf16, the carry to bf16 every step. Tolerances are the card's: f32
1e-5 (the JAX package's fused-LSTM forward tolerance), c scaled by
max(1, |c|); bf16 four bf16 ulps of 1.0, held step by step.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk

from deeplearning4j_tpu_torch.ops import fused_lstm as tfl

TOL_F32 = 1e-5
TOL_BF16 = 3.2e-2
#: the resident body's shape (csrc/lstm_common.cuh): CTAs a cluster, batch
#: rows a cluster, slices of each column's sum over k, threads a CTA, and
#: an H100's shared memory a CTA
CLUSTER, ROWS, KSPLIT, THREADS = 8, 4, 8, 512
SMEM_LIMIT = 227 * 1024


def _smem_bytes(H, itemsize):
    """A resident CTA's shared memory, as ``resident_smem_bytes`` counts
    it: its slice of RW ``[Hp, 4U]`` in the input type (U = ceil(H / 8)
    units a CTA, Hp = H padded to a multiple of 32 with zero rows), two
    buffers of h ``[ROWS, Hp]`` and the partial sums ``[8, ROWS, 4U]`` in
    f32."""
    units = -(-H // CLUSTER)
    hp = -(-H // (4 * KSPLIT)) * 4 * KSPLIT
    return itemsize * hp * 4 * units + 4 * (
        2 * ROWS * hp + KSPLIT * ROWS * 4 * units)


def _fits(H, itemsize):
    return (_smem_bytes(H, itemsize) <= SMEM_LIMIT
            and ROWS * -(-H // CLUSTER) <= THREADS)


@pytest.mark.parametrize("dtype,widest", [(torch.float32, 312),
                                          (torch.bfloat16, 424)])
def test_resident_limit_follows_the_shared_memory(dtype, widest):
    """``RESIDENT_MAX_HIDDEN`` is the last H whose resident CTA fits 227 KB
    of shared memory: every H up to it fits, none past it up to
    ``MAX_HIDDEN`` (the streaming body's); the char-RNN's H = 256 runs
    resident in both types."""
    size = torch.empty((), dtype=dtype).element_size()
    assert tfl.RESIDENT_MAX_HIDDEN[dtype] == widest
    assert all(_fits(H, size) for H in range(1, widest + 1))
    assert not any(_fits(H, size)
                   for H in range(widest + 1, tfl.MAX_HIDDEN + 1))
    assert 256 <= widest < tfl.MAX_HIDDEN


def test_resident_shared_memory_at_the_char_rnn_width():
    """At H = 256 in f32 a CTA keeps 32 units' slice of RW (256 x 128
    f32, 128 KiB), two h buffers of 4 rows and 8 x 4 x 128 partial sums:
    152 KiB; in bf16 the slice halves."""
    assert _smem_bytes(256, 4) == 128 * 1024 + 4 * (
        2 * 4 * 256 + 8 * 4 * 128)
    assert _smem_bytes(256, 2) == 64 * 1024 + 4 * (
        2 * 4 * 256 + 8 * 4 * 128)


def _f32(a):
    return a.astype(np.float32).astype(np.float64)


def _bf16(a):
    return torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).double().numpy()


def _resident_step(xz_t, rw, pw, h, c, fb, carry):
    """One step of the resident body's arithmetic from carry (h, c):
    returns (h_new, c_new) rounded to ``carry`` (f32 or bf16) and h_new
    before that rounding, as the body writes hs."""
    sig = lambda a: _f32(1.0 / (1.0 + np.exp(-a)))
    Hn = rw.shape[0]
    hp = -(-Hn // 32) * 32
    kc = hp // KSPLIT
    hpad = np.zeros((h.shape[0], hp))
    hpad[:, :Hn] = h
    wpad = np.zeros((hp, rw.shape[1]))
    wpad[:Hn] = rw
    z = None
    for s in range(KSPLIT):
        acc = np.zeros((h.shape[0], rw.shape[1]))
        for k in range(s * kc, (s + 1) * kc):
            acc = _f32(hpad[:, k:k + 1] * wpad[k] + acc)
        z = acc if z is None else _f32(z + acc)
    z = _f32(z + xz_t)
    zi, zf, zg, zo = (z[:, q * Hn:(q + 1) * Hn] for q in range(4))
    i = sig(_f32(zi + _f32(c * pw[0])))
    f = sig(_f32(_f32(zf + _f32(c * pw[1])) + fb))
    c_new = _f32(_f32(f * c) + _f32(i * _f32(np.tanh(zg))))
    o = sig(_f32(zo + _f32(c_new * pw[2])))
    h_new = _f32(o * _f32(np.tanh(c_new)))
    rnd = _f32 if carry == "f32" else _bf16
    return rnd(h_new), rnd(c_new), h_new


def _inputs(Tn, Bn, Hn, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    rw = torch.randn(Hn, 4 * Hn, generator=g) * Hn ** -0.5
    pw = torch.randn(3, Hn, generator=g) * 0.3
    xz = torch.randn(Tn, Bn, 4 * Hn, generator=g)
    h0 = torch.randn(Bn, Hn, generator=g) * 0.5
    c0 = torch.randn(Bn, Hn, generator=g)
    return [a.to(dtype) for a in (xz, rw, pw, h0, c0)]


@pytest.mark.parametrize("Tn,Bn,Hn", [
    (64, 32, 256), (9, 5, 100), (6, 1, 1), (6, 2, 7), (6, 3, 31),
    (6, 4, 33), (5, 5, 129), (4, 2, 255), (4, 3, 312), (4, 2, 424)],
    ids=["char_rnn_64_steps", "ragged_H100", "H1", "H7_one_unit_a_cta",
         "H31", "H33", "H129", "H255", "widest_f32", "widest_bf16_in_f32"])
def test_resident_f32_arithmetic_tracks_the_plain_recurrence(Tn, Bn, Hn):
    """f32 over all steps: the emulated resident body against the plain
    recurrence (a GEMM per step) within 1e-5, c_T within 1e-5 x
    max(1, |c|); at the char-RNN's shape over 64 steps, and at hidden
    sizes whose k slices end in zero padding or hold none of H at all
    (H < 32), whose CTAs own unequal numbers of units, up to the resident
    body's widest H."""
    args = _inputs(Tn, Bn, Hn, torch.float32, 1234 + Tn + Bn + Hn)
    hs_ref, _, c_ref = tfl.lstm_recurrence_plain(*args, forget_bias=1.0)
    xz, rw, pw, h, c = (a.double().numpy() for a in args)
    hs = []
    for t in range(Tn):
        h, c, h_out = _resident_step(xz[t], rw, pw, h, c, 1.0, "f32")
        hs.append(h_out)
    assert np.abs(np.stack(hs) - hs_ref.double().numpy()).max() <= TOL_F32
    tol_c = TOL_F32 * max(1.0, float(c_ref.abs().max()))
    assert np.abs(c - c_ref.double().numpy()).max() <= tol_c


def test_resident_f32_arithmetic_matches_the_jax_kernel():
    """The emulated resident body against the JAX package's inference
    kernel K1 (``_run_lstm_fwd_infer``, Pallas interpreted, unpadded) on
    the same inputs with nonzero carries, within 1e-5."""
    Tn, Bn, Hn = 12, 5, 40
    xz, rw, pw, h0, c0 = (a.numpy() for a in _inputs(Tn, Bn, Hn,
                                                      torch.float32, 77))
    ref_hs, ref_c = jpk._run_lstm_fwd_infer(
        *map(jnp.asarray, (xz, rw, pw, h0, c0)), 1.0, True)
    xz, rw, pw, h, c = (a.astype(np.float64) for a in (xz, rw, pw, h0, c0))
    hs = []
    for t in range(Tn):
        h, c, h_out = _resident_step(xz[t], rw, pw, h, c, 1.0, "f32")
        hs.append(h_out)
    np.testing.assert_allclose(np.stack(hs), np.asarray(ref_hs),
                               atol=TOL_F32)
    np.testing.assert_allclose(c, np.asarray(ref_c), atol=TOL_F32)


def test_resident_bf16_arithmetic_holds_step_by_step():
    """bf16 at the char-RNN's shape over 64 steps: each emulated step of
    the resident body, from the carry the previous step returned, within
    four bf16 ulps of 1.0 of the plain step from the same carry (c scaled
    by max(1, |c|)), as the card holds the kernel."""
    Tn, Bn, Hn = 64, 32, 256
    args = _inputs(Tn, Bn, Hn, torch.bfloat16, 4321)
    xz_t, rw_t, pw_t = args[:3]
    xz, rw, pw, h, c = (a.double().numpy() for a in args)
    for t in range(Tn):
        h_ref, c_ref = (a.double().numpy() for a in tfl.lstm_recurrence_plain(
            xz_t[t:t + 1], rw_t, pw_t, torch.from_numpy(h).bfloat16(),
            torch.from_numpy(c).bfloat16(), forget_bias=1.0)[1:])
        h, c, _ = _resident_step(xz[t], rw, pw, h, c, 1.0, "bf16")
        assert np.abs(h - h_ref).max() <= TOL_BF16, t
        tol_c = TOL_BF16 * max(1.0, float(np.abs(c_ref).max()))
        assert np.abs(c - c_ref).max() <= tol_c, t
