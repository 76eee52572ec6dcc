"""K3's resident body (``csrc/lstm_bwd.cu``, ``lstm_bwd_steps_resident``)
on the CPU: which hidden sizes it takes, and a numpy emulation of its
arithmetic held against the plain sweep (``lstm_bwd_plain``) and the JAX
package's Pallas kernel (``_run_lstm_bwd``, interpreted).

The body runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Its arithmetic is f32 on CUDA cores. A cluster of 8 CTAs: CTA d owns
hidden units [d U, d U + U), U = ceil(H / 8), and their four gate columns
of dz (its column q U + j is dz's column q H + d U + j), padded with zero
columns to a multiple of 16 and cut into 4 slices. Each slice's sum of
dz @ rw^T for every (row, k) is one chain of fused multiply-adds in column
order; a CTA adds its slices in slice order into its partial dh_prev, and
the owner of unit k adds the 8 CTAs' partials in rank order (they reach
it through distributed shared memory, which changes no value). dz and the
(dh, dc) carries are rounded to the input type every step, and dh_prev is
summed from the rounded dz. The emulation rounds every multiply-add and
add to f32 (products of f32 values are exact in f64) and, for bf16, dz and
the carries to bf16. Tolerances are the card's: f32 2e-4 (the reference's
gradient tolerance), bf16 four bf16 ulps of 1.0 held step by step, each
scaled by max(1, max |x|).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk

from deeplearning4j_tpu_torch.ops import fused_lstm as tfl

TOL_F32 = 2e-4
TOL_BF16 = 3.2e-2
#: the resident body's shape (csrc/lstm_common.cuh, csrc/lstm_bwd.cu):
#: CTAs a cluster, batch rows a cluster, slices of a CTA's dz columns,
#: threads a CTA, and an H100's shared memory a CTA
CLUSTER, ROWS, CSPLIT, THREADS = 8, 4, 4, 512
SMEM_LIMIT = 227 * 1024


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernel in interpret mode."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")


def _units(H):
    return -(-H // CLUSTER)


def _ncp(H):
    """A CTA's dz columns, 4U padded to a multiple of 4 slices x 4."""
    return -(-4 * _units(H) // (4 * CSPLIT)) * 4 * CSPLIT


def _smem_bytes(H, itemsize):
    """A resident CTA's shared memory, as ``bwd_resident_smem_bytes``
    counts it: its rows of rw^T ``[NCp, Hp]`` in the input type (Hp = H
    padded to even), dz ``[ROWS, NCp]``, the slices' partial sums
    ``[CSPLIT, ROWS, Hp]`` and two receive buffers ``[2, 8, ROWS, U]`` in
    f32, and the buffers' two 8-byte mbarriers."""
    hp = -(-H // 2) * 2
    return itemsize * _ncp(H) * hp + 4 * (
        ROWS * _ncp(H) + CSPLIT * ROWS * hp
        + 2 * CLUSTER * ROWS * _units(H)) + 2 * 8


def _fits(H, itemsize):
    return (_smem_bytes(H, itemsize) <= SMEM_LIMIT
            and ROWS * _units(H) <= THREADS)


@pytest.mark.parametrize("dtype,widest", [(torch.float32, 312),
                                          (torch.bfloat16, 420)])
def test_bwd_resident_limit_follows_the_shared_memory(dtype, widest):
    """``BWD_RESIDENT_MAX_HIDDEN`` is the last H whose resident CTA fits
    227 KB of shared memory: every H up to it fits, none past it up to
    ``MAX_HIDDEN``; the char-RNN's H = 256 runs resident in both types. In
    f32 it is K1/K2's limit; in bf16 it is below theirs."""
    size = torch.empty((), dtype=dtype).element_size()
    assert tfl.BWD_RESIDENT_MAX_HIDDEN[dtype] == widest
    assert all(_fits(H, size) for H in range(1, widest + 1))
    assert not any(_fits(H, size)
                   for H in range(widest + 1, tfl.MAX_HIDDEN + 1))
    assert 256 <= widest <= tfl.RESIDENT_MAX_HIDDEN[dtype]


def test_bwd_resident_shared_memory_at_the_char_rnn_width():
    """At H = 256 in f32 a CTA keeps 32 units' 128 rows of rw^T (128 x 256
    f32, 128 KiB), dz for 4 rows, 4 x 4 x 256 partial sums, two
    8 x 4 x 32 receive buffers and their mbarriers: 154 KiB and 16 bytes;
    in bf16 the rows of rw^T halve."""
    rest = 4 * (4 * 128 + 4 * 4 * 256 + 2 * 8 * 4 * 32) + 16
    assert _smem_bytes(256, 4) == 128 * 1024 + rest == 154 * 1024 + 16
    assert _smem_bytes(256, 2) == 64 * 1024 + rest


def _f32(a):
    return a.astype(np.float32).astype(np.float64)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


def _columns(H):
    """[CLUSTER, CSPLIT, NCp / CSPLIT]: the dz (and rw^T row) each slice
    of each CTA sums over, in order; 4H stands for a zero padding
    column."""
    U, ncp = _units(H), _ncp(H)
    cols = np.full((CLUSTER, ncp), 4 * H)
    for d in range(CLUSTER):
        for c in range(4 * U):
            q, j = divmod(c, U)
            if d * U + j < H:
                cols[d, c] = q * H + d * U + j
    return cols.reshape(CLUSTER, CSPLIT, ncp // CSPLIT)


def _resident_step(eps_t, g4, c_t, c_prev, rwT, pw, dh, dc, carry):
    """One step of the resident body's arithmetic from carries (dh, dc):
    returns (dz [B, 4H], dh_prev, dc_prev), each rounded to ``carry``
    (f32 or bf16)."""
    rnd = _f32 if carry == "f32" else _bf16
    H = rwT.shape[1]
    i, f, g, o = (g4[:, q * H:(q + 1) * H] for q in range(4))
    pi, pf, po = pw
    dh = _f32(dh + eps_t)
    tc = _f32(np.tanh(c_t))
    dzo = _f32(_f32(_f32(dh * tc) * o) * _f32(1.0 - o))
    dcn = _f32(_f32(dc + _f32(_f32(dh * o) * _f32(1.0 - _f32(tc * tc))))
               + _f32(dzo * po))
    dzi = _f32(_f32(_f32(dcn * g) * i) * _f32(1.0 - i))
    dzf = _f32(_f32(_f32(dcn * c_prev) * f) * _f32(1.0 - f))
    dzg = _f32(_f32(dcn * i) * _f32(1.0 - _f32(g * g)))
    dc_prev = rnd(_f32(_f32(_f32(dcn * f) + _f32(dzi * pi))
                       + _f32(dzf * pf)))
    dz = rnd(np.concatenate([dzi, dzf, dzg, dzo], axis=1))
    # the product: acc[d, s, b, k], one fma chain per slice in column
    # order; padding columns (index 4H) read zeros
    cols = _columns(H)
    dzp = np.concatenate([dz, np.zeros((dz.shape[0], 1))], axis=1)
    wp = np.concatenate([rwT, np.zeros((1, H))], axis=0)
    acc = np.zeros((CLUSTER, CSPLIT, dz.shape[0], H))
    for c in range(cols.shape[2]):
        idx = cols[:, :, c]
        acc = _f32(dzp[:, idx].transpose(1, 2, 0)[..., None]
                   * wp[idx][:, :, None, :] + acc)
    part = acc[:, 0]
    for s in range(1, CSPLIT):         # a CTA's slices, in slice order
        part = _f32(part + acc[:, s])
    tot = part[0]
    for d in range(1, CLUSTER):        # the owner: CTAs in rank order
        tot = _f32(tot + part[d])
    return dz, rnd(tot), dc_prev


def _inputs(Tn, Bn, Hn, dtype, seed):
    """K3's inputs from K2's plain forward on numpy-seeded weights:
    ``(eps, gates, cs, c0, rw, pw, dh_T, dc_T)`` in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.normal(size=s)).astype(np.float32)).to(dtype)
    rw = x(Hn, 4 * Hn, scale=Hn ** -0.5)
    pw = x(3, Hn, scale=0.3)
    xz, h0, c0 = x(Tn, Bn, 4 * Hn), x(Bn, Hn, scale=0.5), x(Bn, Hn)
    _, gates, cs = tfl.lstm_fwd_train_plain(xz, rw, pw, h0, c0,
                                            forget_bias=1.0)
    eps, dh_T, dc_T = x(Tn, Bn, Hn), x(Bn, Hn), x(Bn, Hn)
    return eps, gates, cs, c0, rw, pw, dh_T, dc_T


def _emulate(eps, gates, cs, c0, rw, pw, dh_T, dc_T):
    """The resident body's whole sweep in f32: ``(dz, dh0, dc0)`` as f64
    arrays of f32 values."""
    eps, gates, cs, c0, rw, pw, dh, dc = (
        a.double().numpy() for a in (eps, gates, cs, c0, rw, pw, dh_T, dc_T))
    c_prev = np.concatenate([c0[None], cs[:-1]])
    dz = [None] * eps.shape[0]
    for t in reversed(range(eps.shape[0])):
        dz[t], dh, dc = _resident_step(eps[t], gates[t], cs[t], c_prev[t],
                                       rw.T, pw, dh, dc, "f32")
    return np.stack(dz), dh, dc


def _assert_scaled_close(got, want, rel, what):
    want = np.asarray(want, np.float64)
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got, np.float64) - want).max() <= tol, what


SHAPES = [(50, 32, 256), (9, 5, 100), (6, 2, 1), (6, 3, 7), (6, 4, 31),
          (5, 2, 33), (4, 3, 129), (3, 2, 312), (3, 2, 420), (7, 1, 64),
          (6, 11, 40), (1, 6, 48)]
SHAPE_IDS = ["char_rnn_window", "ragged_H100", "H1", "H7_one_unit_a_cta",
             "H31", "H33", "H129", "widest_f32", "widest_bf16_in_f32",
             "B1", "B11_three_clusters", "T1"]


@pytest.mark.parametrize("Tn,Bn,Hn", SHAPES, ids=SHAPE_IDS)
def test_bwd_resident_f32_arithmetic_tracks_the_plain_sweep(Tn, Bn, Hn):
    """f32 over the whole sweep: the emulated resident body against the
    plain sweep (a GEMM per step), dz, dh0 and dc0 within 2e-4 x
    max(1, max |x|); at the char-RNN's tBPTT window, at hidden sizes whose
    CTAs own unequal numbers of units or none (H < 8), whose column slices
    end in zero padding, up to K3's widest resident H in both types, at
    one row, at rows spread over three clusters and at one step."""
    args = _inputs(Tn, Bn, Hn, torch.float32, 900 + Tn + Bn + Hn)
    c_prev = torch.cat([args[3][None], args[2][:-1]])
    ref = tfl.lstm_bwd_plain(args[0], args[1], args[2], c_prev, *args[4:])
    for name, got, want in zip(("dz", "dh0", "dc0"), _emulate(*args), ref):
        _assert_scaled_close(got, want.double().numpy(), TOL_F32, name)


@pytest.mark.parametrize("Tn,Bn,Hn", SHAPES, ids=SHAPE_IDS)
def test_bwd_resident_f32_arithmetic_matches_the_jax_kernel(Tn, Bn, Hn):
    """The emulated resident body against the JAX package's backward
    kernel (``_run_lstm_bwd``, Pallas interpreted, unpadded) on the same
    residuals and seeds, within 2e-4 x max(1, max |x|), at the same
    shapes."""
    args = _inputs(Tn, Bn, Hn, torch.float32, 300 + Tn + Bn + Hn)
    eps, gates, cs, c0, rw, pw, dh_T, dc_T = (a.numpy() for a in args)
    c_prev = np.concatenate([c0[None], cs[:-1]])
    ref = jpk._run_lstm_bwd(*map(jnp.asarray, (eps, gates, cs, c_prev, rw,
                                               pw, dh_T, dc_T)), True)
    for name, got, want in zip(("dz", "dh0", "dc0"), _emulate(*args), ref):
        _assert_scaled_close(got, want, TOL_F32, name)


@pytest.mark.parametrize("Tn,Bn,Hn", [(50, 32, 256), (4, 3, 420)],
                         ids=["char_rnn_window", "widest_bf16"])
def test_bwd_resident_bf16_arithmetic_holds_step_by_step(Tn, Bn, Hn):
    """bf16: each emulated step of the resident body, from the carries the
    previous step returned, within four bf16 ulps of 1.0 of the plain step
    from the same carries (scaled by max(1, max |x|)), as the card holds
    the kernel; at the char-RNN's window and at K3's widest resident H in
    bf16."""
    args = _inputs(Tn, Bn, Hn, torch.bfloat16, 4321 + Hn)
    eps, gates, cs, c0, rw, pw, dh_T, dc_T = args
    c_prev = torch.cat([c0[None], cs[:-1]])
    np_ = lambda a: a.double().numpy()
    dh, dc = np_(dh_T), np_(dc_T)
    for t in reversed(range(Tn)):
        want = tfl.lstm_bwd_plain(
            eps[t:t + 1], gates[t:t + 1], cs[t:t + 1], c_prev[t:t + 1], rw,
            pw, torch.from_numpy(dh).bfloat16(),
            torch.from_numpy(dc).bfloat16())
        dz, dh, dc = _resident_step(np_(eps[t]), np_(gates[t]), np_(cs[t]),
                                    np_(c_prev[t]), np_(rw).T, np_(pw), dh,
                                    dc, "bf16")
        for name, got, w in zip(("dz", "dh", "dc"), (dz, dh, dc), want):
            _assert_scaled_close(got, np_(w.reshape(got.shape)), TOL_BF16,
                                 f"{name} at step {t}")
