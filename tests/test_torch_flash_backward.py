"""The port's flash-attention backward against the JAX package's FA2
backward kernels K5 (``_dq_kernel``) and K6 (``_dkv_kernel``): ``jax.grad``
of the Pallas ``flash_attention`` in interpret mode, as that package's own
tests run it on the CPU.

On the CPU the backward wrappers run their plain version,
``flash_attention_bwd_plain`` (the FA2 recomputation in f32 einsums), so
these tests hold it to the TPU kernels' contract, the same numpy inputs
going to both sides; the CUDA kernels are held against the same plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).
Tolerances are the JAX package's own for these grads
(tests/test_pallas_attention.py): 5e-5, and 1e-4 for T=300; bf16 grads,
rounded to bf16 on both sides, at two bf16 ulps of 1.0 (1.6e-2).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.nn.layers.attention import attention_reference
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, FlashAttentionFunction, attention_dvec, check_bwd_inputs,
    flash_attention, flash_attention_bwd_plain, flash_attention_dkv,
    flash_attention_dq,
)


def _inputs(seed, B, H, T, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32)
            for _ in range(4)]


def _jax_grads(q, k, v, d_out, causal, mask, dtype=jnp.float32):
    """jax.grad of sum(flash_attention(q, k, v) * d_out) through the
    Pallas kernels in interpret mode: (dq, dk, dv) as f32 numpy."""
    m = None if mask is None else jnp.asarray(mask)
    cot = jnp.asarray(d_out, dtype)

    def loss(q, k, v):
        out = jpa.flash_attention(q, k, v, causal=causal, kv_mask=m,
                                  interpret=True)
        return jnp.sum((out * cot).astype(jnp.float32))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, d_out, causal, mask, dtype=torch.float32):
    """The port's plain backward from its own forward: (dq, dk, dv) as f32
    numpy, plus the forward's out."""
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, d_out)]
    m = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention(*t[:3], causal=causal, kv_mask=m,
                               return_lse=True)
    grads = flash_attention_bwd_plain(*t, out, lse, causal=causal, kv_mask=m)
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads], out


def _hole(B, T, lo, hi):
    m = np.ones((B, T), np.float32)
    m[:, lo:hi] = 0.0
    return m


@pytest.mark.parametrize("case", [
    # three 128-row blocks of the TPU kernels: causal block skipping and a
    # masked hole in block 2, in both backward kernels
    dict(B=1, H=2, T=300, D=8, causal=True, mask="hole", tol=1e-4),
    # T and D off every tile edge, no causal skip
    dict(B=2, H=2, T=37, D=24, causal=False, mask=None, tol=5e-5),
    dict(B=2, H=1, T=20, D=16, causal=True, mask="random", tol=5e-5),
    # heads past the register templates: the kernels' wide template
    dict(B=1, H=2, T=20, D=320, causal=True, mask="random", tol=5e-5),
    dict(B=1, H=1, T=24, D=512, causal=False, mask=None, tol=5e-5),
], ids=["T300-causal-hole", "T37-D24-full", "T20-causal-masked",
        "D320-causal-masked", "D512-full"])
def test_plain_backward_matches_jax_kernels(case):
    B, H, T, D = case["B"], case["H"], case["T"], case["D"]
    q, k, v, d_out = _inputs(1, B, H, T, D)
    mask = None
    if case["mask"] == "hole":
        mask = _hole(B, T, 130, 170)
    elif case["mask"] == "random":
        mask = (np.random.default_rng(2).random((B, T)) > 0.3).astype(
            np.float32)
        mask[:, 0] = 1.0
    ref = _jax_grads(q, k, v, d_out, case["causal"], mask)
    got, _ = _port_grads(q, k, v, d_out, case["causal"], mask)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g, r, atol=case["tol"], rtol=case["tol"],
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_zero_valid_key_row_has_exact_zero_grads(causal):
    """Batch 0 has no valid key: its dq, dk and dv are exactly 0 and
    finite on both sides (the lse == NEG_INF gate is a select before the
    product; exp(s - lse) there is inf). The valid batch row matches."""
    q, k, v, d_out = _inputs(3, 2, 2, 12, 8)
    mask = np.ones((2, 12), np.float32)
    mask[0] = 0.0
    ref = _jax_grads(q, k, v, d_out, causal, mask)
    got, _ = _port_grads(q, k, v, d_out, causal, mask)
    for g, r, name in zip(got, ref, "qkv"):
        assert np.all(np.isfinite(g)), f"d{name} not finite"
        assert np.all(g[0] == 0.0) and np.all(r[0] == 0.0), name
        np.testing.assert_allclose(g[1:], r[1:], atol=5e-5, rtol=5e-5,
                                   err_msg=f"d{name} (valid row)")


def test_bf16_inputs_accumulate_in_f32():
    """bf16 q/k/v/dO: the plain backward reads bf16, computes in f32 and
    rounds each grad to bf16 once, as the JAX kernels do (D=8 makes the
    JAX q pre-scale an exact power of two). Grads compared in f32."""
    q, k, v, d_out = _inputs(4, 2, 2, 40, 8)
    mask = _hole(2, 40, 10, 20)
    ref = _jax_grads(q, k, v, d_out, True, mask, dtype=jnp.bfloat16)
    got, out = _port_grads(q, k, v, d_out, True, mask, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g, r, atol=1.6e-2, rtol=1.6e-2,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_reference_autograd(causal):
    """flash_attention is differentiable on the CPU through the
    FlashAttentionFunction (the FA2 backward, not autograd through the
    plain forward): its grads equal autograd through attention_reference
    on rows with valid keys (5e-5), and equal the plain backward bit for
    bit."""
    q, k, v, d_out = (torch.from_numpy(x) for x in _inputs(5, 2, 2, 29, 16))
    mask = torch.ones(2, 29)
    mask[1, 4:9] = 0.0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention(*leaves, causal=causal, kv_mask=mask,
                               return_lse=True)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert not lse.requires_grad
    got = torch.autograd.grad((out * d_out).sum(), leaves)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention_reference(*ref_leaves, causal=causal, mask=mask)
    want = torch.autograd.grad((ref * d_out).sum(), ref_leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)
    plain = flash_attention_bwd_plain(q, k, v, d_out, out.detach(), lse,
                                      causal=causal, kv_mask=mask)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


def test_backward_wrappers_on_cpu_count_nothing():
    """The K5/K6 wrappers run the plain version for CPU tensors and count
    no launch; their parts equal the whole plain backward."""
    q, k, v, d_out = (torch.from_numpy(x) for x in _inputs(6, 1, 2, 24, 8))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    dvec = attention_dvec(d_out, out)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq = flash_attention_dq(q, k, v, d_out, lse, dvec, causal=True)
    dk, dv = flash_attention_dkv(q, k, v, d_out, lse, dvec, causal=True)
    assert (flash_attention_dq.launches,
            flash_attention_dkv.launches) == before
    whole = flash_attention_bwd_plain(q, k, v, d_out, out, lse, causal=True)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), whole))


def test_no_grad_saves_nothing_and_plain_forward_is_unchanged():
    """Serving (torch.no_grad) builds no graph; the forward still equals
    the plain forward bit for bit."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in _inputs(7, 1, 2, 16, 8))
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None and not out.requires_grad
    out2, lse = FlashAttentionFunction.apply(q.detach(), k.detach(),
                                             v.detach(), None, True)
    assert torch.equal(out, out2) and lse.dtype == torch.float32
    assert float(lse.min()) > NEG_INF / 2


@pytest.mark.parametrize("bad", ["d_out_shape", "d_out_dtype", "lse_dtype",
                                 "dvec_shape"])
def test_backward_inputs_outside_the_contract_raise(bad):
    q = torch.zeros(2, 2, 8, 16)
    d_out, lse, dvec = q.clone(), torch.zeros(2, 2, 8), torch.zeros(2, 2, 8)
    if bad == "d_out_shape":
        d_out = torch.zeros(2, 2, 9, 16)
    elif bad == "d_out_dtype":
        d_out = d_out.to(torch.bfloat16)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "dvec_shape":
        dvec = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        check_bwd_inputs(q, q, q, d_out, lse, dvec)
    with pytest.raises(ValueError):
        flash_attention_dq(q, q, q, d_out, lse, dvec)
