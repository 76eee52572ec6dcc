"""The numerics of the tensor-core flash-attention kernels, the forward K4
(``csrc/flash_attn_fwd.cu``) and the backward K5 (``csrc/flash_attn_dq.cu``)
and K6 (``csrc/flash_attn_dkv.cu``), proved on the CPU, where no CUDA
kernel runs.

The kernels do every product of the FA2 backward (s = q k^T, dp = dO v^T,
dq = ds k, dk = ds^T q, dv = p^T dO) on mma.sync tf32 tensor cores with f32
accumulation. Here numpy emulates that arithmetic: the 3xTF32 split product
of f32 inputs as the kernels split (big = x with the low 13 bits cleared,
small = x - big, of which the tensor core reads the top 19 bits) and as
``cvt.rna.tf32.f32`` would (round to nearest, ties away from zero, to a
10-bit mantissa), and for bf16 inputs exact products with p and ds rounded
once. The emulated backward is held against the port's plain f32
backward and against ``jax.grad`` of the JAX package's Pallas kernels in
interpret mode (as tests/test_torch_flash_backward.py runs them), the same
numpy inputs going to all three, at 5e-5 of each gradient's largest |g|
(f32) and 1.6e-2 (bf16, the card tests' tolerances). 1xTF32 misses the f32
tolerance by an order of magnitude, which is why the kernels split.

K4's forward is emulated as the kernel computes it: per KV tile of 32 keys,
s = q k^T and o += p v through the same products, the online softmax's
running max and sum in f32, p rounded to tf32 once for bf16 calls. It is
held against the port's plain forward and the JAX Pallas forward
(interpret mode) at 2e-5 (O) and 1e-4 (lse), the card tests' tolerances;
1xTF32 misses 2e-5 there too.

The fragment layout the kernels rely on (an accumulator tile reused as the
next product's A operand, with the B operand loaded in the permuted k
order) is emulated lane by lane from the PTX fragment definitions.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, _valid_pairs, attention_bwd_plain, attention_dvec,
    flash_attention,
)

TOL_F32 = 5e-5
TOL_BF16 = 1.6e-2
#: the forward's tolerances: O in f32 and in bf16, lse
TOL_FWD_O = 2e-5
TOL_FWD_LSE = 1e-4
#: keys per KV tile of the forward kernel (BK in csrc/flash_attn_fwd.cu)
FWD_BK = 32


def rna_tf32(x):
    """``cvt.rna.tf32.f32``: nearest, ties away from zero, 10-bit mantissa
    (the low 13 bits of the f32 cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def trunc_tf32(x):
    """What the tensor core reads of an f32 register given as tf32: its top
    19 bits (the low 13 cleared, toward zero)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


#: x -> (big, small as the tensor core reads it), the two 3xTF32 splits
SPLITS = {
    "trunc": lambda x: (trunc_tf32(x), trunc_tf32(x - trunc_tf32(x))),
    "rna": lambda x: (rna_tf32(x), rna_tf32(x - rna_tf32(x))),
}


def to_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def matmul(a, b, mode):
    """a @ b as the tensor cores take it, f32 accumulation. ``3xtf32``
    (the kernels' split) and ``3xtf32-rna``: a_small b_big + a_big b_small
    + a_big b_big; ``1xtf32``: both operands rounded once, to nearest;
    ``exact``: operands already exact in tf32."""
    if mode.startswith("3xtf32"):
        split = SPLITS["rna" if mode.endswith("rna") else "trunc"]
        (ab, a_s), (bb, b_s) = split(a), split(b)
        return (a_s @ bb + ab @ b_s) + ab @ bb
    if mode == "1xtf32":
        return rna_tf32(a) @ rna_tf32(b)
    return a @ b


def emulated_bwd(q, k, v, d_out, lse, dvec, valid, mode, round_pds=None):
    """The kernels' backward in numpy f32: every product through
    ``matmul(mode)``; ``round_pds`` rounds p and ds before the second
    products (the bf16 calls)."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    t = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731
    s = matmul(q, t(k), mode) * scale
    ok = valid & (lse > NEG_INF / 2)[..., None]
    with np.errstate(over="ignore"):
        p = np.where(ok, np.exp(s - lse[..., None]), np.float32(0.0))
    dp = matmul(d_out, t(v), mode)
    ds = p * (dp - dvec[..., None])
    if round_pds is not None:
        p, ds = round_pds(p), round_pds(ds)
    return (matmul(ds, k, mode) * scale, matmul(t(ds), q, mode) * scale,
            matmul(t(p), d_out, mode))


def _holes(B, T):
    """chip_smoke.py's "holes" mask: batch 0 has no valid key, batch 1
    loses key 0 (so query 0 has none under causal), keys 130-169 masked."""
    m = np.ones((B, T), np.float32)
    m[0] = 0.0
    m[1, 0] = 0.0
    m[1:, 130:170] = 0.0
    return m


CASES = {"T256-causal": (2, 2, 256, 64, None),
         "T300-causal-holes": (2, 2, 300, 64, "holes")}


def _case(name, dtype):
    """Inputs, the port's plain forward (lse, Dvec) and backward, and the
    pair validity of case ``name`` in ``dtype``."""
    B, H, T, D, mask_kind = CASES[name]
    rng = np.random.default_rng(T + D)
    arrs = [rng.normal(size=(B, H, T, D)).astype(np.float32)
            for _ in range(4)]
    if dtype == "bfloat16":
        arrs = [to_bf16(a) for a in arrs]
    mask = _holes(B, T) if mask_kind == "holes" else None
    tdt = getattr(torch, dtype)
    q, k, v, d_out = (torch.from_numpy(a).to(tdt) for a in arrs)
    m = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention(q, k, v, causal=True, kv_mask=m,
                               return_lse=True)
    dvec = attention_dvec(d_out, out)
    plain = [g.float().numpy() for g in attention_bwd_plain(
        q, k, v, d_out, lse, dvec, causal=True, kv_mask=m)]
    valid = _valid_pairs(B, T, True, m, "cpu").numpy()
    return arrs, mask, lse.numpy(), dvec.numpy(), valid, plain


def _jax_grads(arrs, mask):
    """jax.grad of sum(flash_attention(q, k, v) * d_out) through the Pallas
    kernels in interpret mode, causal: (dq, dk, dv) as f32 numpy."""
    q, k, v, d_out = (jnp.asarray(a) for a in arrs)
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        out = jpa.flash_attention(q, k, v, causal=True, kv_mask=m,
                                  interpret=True)
        return jnp.sum(out * d_out)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k,
                                                                      v)]


def _rel_errs(got, want):
    """max |got - want| over max |want|, per gradient tensor."""
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("mode", ["3xtf32", "3xtf32-rna"])
@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_backward_matches_plain_and_jax(name, mode):
    """3xTF32 products, split as the kernels split (and as round-to-nearest
    would), stay within 5e-5 of each gradient's largest |g| of the plain
    f32 backward and of the JAX Pallas backward; the rows and keys with no
    valid pair stay exactly 0."""
    arrs, mask, lse, dvec, valid, plain = _case(name, "float32")
    got = emulated_bwd(*arrs, lse, dvec, valid, mode)
    assert max(_rel_errs(got, plain)) <= TOL_F32
    assert max(_rel_errs(got, _jax_grads(arrs, mask))) <= TOL_F32
    if mask is not None:
        assert all(np.all(g[0] == 0) for g in got)


@pytest.mark.parametrize("name", list(CASES))
def test_1xtf32_backward_misses_the_f32_tolerance(name):
    """One tf32 product per f32 product (10-bit mantissas) is off by more
    than 5e-5 of the largest |g| in every gradient: p = exp(s - lse)
    inherits s's rounding error, so the kernels split f32 operands. The
    margins are recorded: 1xTF32 lands between 2e-4 and 5e-3, 3xTF32 below
    5e-6 with either split."""
    arrs, _, lse, dvec, valid, plain = _case(name, "float32")
    one = _rel_errs(emulated_bwd(*arrs, lse, dvec, valid, "1xtf32"), plain)
    assert min(one) > TOL_F32
    assert 2e-4 < min(one) and max(one) < 5e-3
    for mode in ("3xtf32", "3xtf32-rna"):
        three = _rel_errs(emulated_bwd(*arrs, lse, dvec, valid, mode), plain)
        assert max(three) < 5e-6


@pytest.mark.parametrize("rounding", ["tf32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_bf16_backward_within_the_bf16_tolerance(name, rounding):
    """bf16 inputs are exact in tf32, so s and dp are exact products. The
    kernels round p and ds to tf32 before the second products; FA2's
    rounding to bf16 would also hold. Both stay within 1.6e-2 of the
    largest |g| of the plain backward, whose grads round to bf16."""
    arrs, _, lse, dvec, valid, plain = _case(name, "bfloat16")
    round_pds = rna_tf32 if rounding == "tf32" else to_bf16
    got = emulated_bwd(*arrs, lse, dvec, valid, "exact", round_pds)
    assert max(_rel_errs([to_bf16(g) for g in got], plain)) <= TOL_BF16


def test_rna_tf32_rounds_to_nearest_ties_away():
    """Ties go away from zero, and the split x = big + small keeps about
    21 bits (3xTF32's accuracy) where one tf32 keeps 11."""
    ulp = 2.0 ** -10   # of tf32 at 1.0
    x = np.array([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, -(1.0 + ulp / 2),
                  1.0 + 3 * ulp / 2, 0.0], np.float32)
    np.testing.assert_array_equal(
        rna_tf32(x), np.array([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp),
                               1.0 + 2 * ulp, 0.0], np.float32))
    r = np.random.default_rng(5).normal(size=1000).astype(np.float32)
    big = rna_tf32(r)
    assert np.all(big.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(big - r) <= 2.0 ** -11 * np.abs(r))
    small = rna_tf32(r - big)
    assert np.all(np.abs(big + small - r) <= 2.0 ** -21 * np.abs(r))


def test_truncating_split_keeps_20_bits():
    """The kernels' split: big is x toward zero in tf32, x - big is exact
    in f32, and the tensor core's read of it (its top 19 bits) leaves
    less than 2^-20 of |x|."""
    r = np.random.default_rng(6).normal(size=1000).astype(np.float32)
    big, small = SPLITS["trunc"](r)
    assert np.all(np.abs(big) <= np.abs(r))
    assert np.all(np.abs(r - big) < 2.0 ** -10 * np.abs(r))
    assert np.all(((r - big) + big) == r)
    assert np.all(np.abs(big + small - r) < 2.0 ** -20 * np.abs(r))


# ---- the forward kernel K4 ------------------------------------------------

def emulated_fwd(q, k, v, valid, mode, round_p=None, bk=FWD_BK):
    """K4's forward in numpy f32: per KV tile of ``bk`` keys, s = q k^T
    through ``matmul(mode)``, the running max m and sum l (over p before
    any rounding), o rescaled and o += p v through ``matmul(mode)``;
    ``round_p`` rounds p before that product (the bf16 calls). A row whose
    m never rose off NEG_INF gets exactly 0 and lse = NEG_INF."""
    B, H, T, D = q.shape
    scale = np.float32(1.0 / math.sqrt(D))
    neg = np.float32(NEG_INF)
    m = np.full((B, H, T), neg, np.float32)
    l = np.zeros((B, H, T), np.float32)
    acc = np.zeros((B, H, T, D), np.float32)
    for k0 in range(0, T, bk):
        kt = slice(k0, k0 + bk)
        ok = np.broadcast_to(valid[..., kt], (B, H, T, min(bk, T - k0)))
        s = matmul(q, np.swapaxes(k[..., kt, :], -1, -2), mode) * scale
        s = np.where(ok, s, neg)
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp(m - m_new)
        p = np.where(ok, np.exp(s - m_new[..., None]), np.float32(0.0))
        l = l * alpha + p.sum(-1, dtype=np.float32)
        if round_p is not None:
            p = round_p(p)
        acc = acc * alpha[..., None] + matmul(p, v[..., kt, :], mode)
        m = m_new
    row_ok = m > NEG_INF / 2
    l_safe = np.maximum(l, np.float32(1e-30))
    out = np.where(row_ok[..., None], acc / l_safe[..., None],
                   np.float32(0.0))
    return out, np.where(row_ok, m + np.log(l_safe), neg)


def _fwd_case(name, dtype):
    """Inputs (f32 arrays, bf16-exact for bf16), the key mask, the pair
    validity and the port's plain forward (O as f32, lse) of case
    ``name``."""
    B, H, T, D, mask_kind = CASES[name]
    rng = np.random.default_rng(T + D + 1)
    arrs = [rng.normal(size=(B, H, T, D)).astype(np.float32)
            for _ in range(3)]
    if dtype == "bfloat16":
        arrs = [to_bf16(a) for a in arrs]
    mask = _holes(B, T) if mask_kind == "holes" else None
    m = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                 for a in arrs),
                               causal=True, kv_mask=m, return_lse=True)
    valid = _valid_pairs(B, T, True, m, "cpu").numpy()
    return arrs, mask, valid, out.float().numpy(), lse.numpy()


def _jax_fwd(q, k, v, mask):
    """(O, lse) of the JAX forward kernel in interpret mode, causal, on the
    unpadded problem: the padding and q pre-scale of
    ``jpa.flash_attention``, then ``_run_fwd``."""
    B, H, T, D = q.shape
    Tp, Dp = jpa._round_up(T, 128), jpa._round_up(D, 128)

    def prep(x):
        x = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, Tp - T),
                                     (0, Dp - D)))
        return x.reshape(B * H, Tp, Dp)

    valid = np.ones((B, T), np.float32) if mask is None else mask
    valid = np.pad(valid, ((0, 0), (0, Tp - T)))
    bias = jnp.repeat(jnp.where(jnp.asarray(valid) > 0, 0.0, jpa.NEG_INF)
                      .astype(jnp.float32), H, axis=0)
    qs = jnp.asarray(q) * (math.sqrt(Dp) / math.sqrt(D))
    out, lse = jpa._run_fwd(prep(qs), prep(k), prep(v), bias, True, True)
    out = np.asarray(out).reshape(B, H, Tp, Dp)[:, :, :T, :D]
    return out, np.asarray(lse).reshape(B, H, Tp)[:, :, :T]


def _fwd_errs(got, want):
    """max |O - O_ref| and max |lse - lse_ref|."""
    return (float(np.abs(got[0] - want[0]).max()),
            float(np.abs(got[1] - want[1]).max()))


@pytest.mark.parametrize("mode", ["3xtf32", "3xtf32-rna"])
@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_forward_matches_plain_and_jax(name, mode):
    """K4's arithmetic (3xTF32 split as the kernel splits it, and as
    round-to-nearest would; online softmax over 32-key tiles) stays within
    2e-5 (O) and 1e-4 (lse) of the plain f32 forward and of the JAX Pallas
    forward; rows with no valid key are exactly 0 with lse = NEG_INF."""
    arrs, mask, valid, out, lse = _fwd_case(name, "float32")
    got = emulated_fwd(*arrs, valid, mode)
    for want in ((out, lse), _jax_fwd(*arrs, mask)):
        err_o, err_lse = _fwd_errs(got, want)
        assert err_o <= TOL_FWD_O and err_lse <= TOL_FWD_LSE
    if mask is not None:
        assert np.all(got[0][0] == 0) and np.all(got[1][0] == NEG_INF)
        assert np.all(got[0][1:, :, 0] == 0)
        assert np.all(got[1][1:, :, 0] == NEG_INF)


@pytest.mark.parametrize("name", list(CASES))
def test_1xtf32_forward_misses_the_f32_tolerance(name):
    """One tf32 product per f32 product misses 2e-5 on O: s's rounding
    (~2^-11 of each term) moves p = exp(s - m) by as much. The margins are
    recorded: 1xTF32 lands between 5e-4 and 2e-3 on O (25-100x the
    tolerance) and misses lse's 1e-4 too; 3xTF32 stays below 2e-6 on both
    with either split."""
    arrs, _, valid, out, lse = _fwd_case(name, "float32")
    err_o, err_lse = _fwd_errs(emulated_fwd(*arrs, valid, "1xtf32"),
                               (out, lse))
    assert TOL_FWD_O < 5e-4 < err_o < 2e-3 and err_lse > TOL_FWD_LSE
    for mode in ("3xtf32", "3xtf32-rna"):
        err_o, err_lse = _fwd_errs(emulated_fwd(*arrs, valid, mode),
                                   (out, lse))
        assert err_o < 2e-6 and err_lse < 2e-6


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_forward_within_the_bf16_tolerance(name):
    """bf16 inputs are exact in tf32, so s is an exact product; the kernel
    rounds p to tf32 once before o += p v. O, rounded to bf16, stays
    within 1.6e-2 of the plain forward's bf16 O, and lse within 1e-4."""
    arrs, _, valid, out, lse = _fwd_case(name, "bfloat16")
    o, l = emulated_fwd(*arrs, valid, "exact", rna_tf32)
    err_o, err_lse = _fwd_errs((to_bf16(o), l), (out, lse))
    assert err_o <= TOL_BF16 and err_lse <= TOL_FWD_LSE


@pytest.mark.parametrize("bk", [8, 32, 128])
def test_forward_online_softmax_is_independent_of_the_tile(bk):
    """Exact products (f64 would do; f32 here): the online softmax over
    tiles of 8, 32 or 128 keys gives the plain forward within 2e-6, so the
    kernel's tile size is free to choose."""
    arrs, _, valid, out, lse = _fwd_case("T300-causal-holes", "float32")
    err_o, err_lse = _fwd_errs(emulated_fwd(*arrs, valid, "exact", bk=bk),
                               (out, lse))
    assert err_o < 2e-6 and err_lse < 2e-6


# ---- the fragment layout, lane by lane (PTX m16n8k8 tf32) ----------------

def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3


def _mma(a_frag, b_frag):
    """D = A B of one m16n8k8 mma.sync from per-lane fragments: a [32, 4]
    (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)) and b [32, 2]
    (b0 (k=t, n=g), b1 (k=t+4, n=g)); returns the [16, 8] product."""
    g, t = _lanes()
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for i, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        A[g + dr, t + dc] = a_frag[:, i]
    for i, dk in enumerate((0, 4)):
        B[t + dk, g] = b_frag[:, i]
    return A @ B


def _acc_frag(C):
    """A [16, 8] accumulator as each lane holds it: c0 (g, 2t), c1
    (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)."""
    g, t = _lanes()
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]], 1)


def test_accumulator_feeds_the_next_product_in_the_permuted_order():
    """flash_mma.cuh ``acc_as_a`` + ``mma_pair_b``: the ds (or p) tile of
    one product, left in registers, is the A operand of ds @ X when
    a = (c0, c2, c1, c3) and B holds rows 2t and 2t+1 of X; the same
    registers with B in plain order give a wrong sum."""
    rng = np.random.default_rng(3)
    P = rng.normal(size=(16, 8))
    X = rng.normal(size=(8, 8))
    g, t = _lanes()
    c = _acc_frag(P)
    a = c[:, [0, 2, 1, 3]]
    permuted = np.stack([X[2 * t, g], X[2 * t + 1, g]], 1)
    np.testing.assert_allclose(_mma(a, permuted), P @ X, rtol=1e-12)
    plain = np.stack([X[t, g], X[t + 4, g]], 1)
    assert not np.allclose(_mma(a, plain), P @ X)


def test_row_fragments_compute_q_k_transpose():
    """``load_a`` (rows r0, r0 + 8, columns c0 + t, c0 + t + 4) and
    ``load_bt`` (X[n0 + g][c0 + t], X[n0 + g][c0 + t + 4]) over the k steps
    of D give the s = q k^T tile, accumulated as C = ``_acc_frag``."""
    rng = np.random.default_rng(4)
    D = 24
    Q = rng.normal(size=(16, D))
    K = rng.normal(size=(8, D))
    g, t = _lanes()
    acc = np.zeros((16, 8))
    for c0 in range(0, D, 8):
        a = np.stack([Q[g, c0 + t], Q[g + 8, c0 + t], Q[g, c0 + t + 4],
                      Q[g + 8, c0 + t + 4]], 1)
        b = np.stack([K[g, c0 + t], K[g, c0 + t + 4]], 1)
        acc += _mma(a, b)
    np.testing.assert_allclose(acc, Q @ K.T, rtol=1e-12)
    np.testing.assert_allclose(_acc_frag(acc), _acc_frag(Q @ K.T),
                               rtol=1e-12)


def test_s_accumulator_feeds_p_v_in_the_permuted_order():
    """K4's chain in one warp: s = q k^T accumulated over the k steps of D
    (``load_a`` / ``load_bt``), its accumulator registers taken as the A
    operand of p v (``acc_as_a``: a = (c0, c2, c1, c3)) and V's rows read
    as ``mma_pair_b`` reads them (rows 2t and 2t + 1 of the 8 keys) give
    (q k^T) v; with V in plain order they do not."""
    rng = np.random.default_rng(10)
    D = 16
    Q = rng.normal(size=(16, D))
    K = rng.normal(size=(8, D))
    Vt = rng.normal(size=(8, 8))
    g, t = _lanes()
    s = np.zeros((16, 8))
    for c0 in range(0, D, 8):
        a = np.stack([Q[g, c0 + t], Q[g + 8, c0 + t], Q[g, c0 + t + 4],
                      Q[g + 8, c0 + t + 4]], 1)
        s += _mma(a, np.stack([K[g, c0 + t], K[g, c0 + t + 4]], 1))
    a = _acc_frag(s)[:, [0, 2, 1, 3]]
    permuted = np.stack([Vt[2 * t, g], Vt[2 * t + 1, g]], 1)
    np.testing.assert_allclose(_mma(a, permuted), (Q @ K.T) @ Vt,
                               rtol=1e-10, atol=1e-12)
    plain = np.stack([Vt[t, g], Vt[t + 4, g]], 1)
    assert not np.allclose(_mma(a, plain), (Q @ K.T) @ Vt)
