"""The port's flash-attention forward (deeplearning4j_tpu_torch.ops.
flash_attention) against the JAX package's Pallas kernel K4
(ops/pallas_attention.py ``_fwd_kernel``), run in interpret mode as that
package's own tests run it on the CPU.

On the CPU the wrapper runs its plain version, so these tests hold the
plain version to the TPU kernel's contract: O, the row log-sum-exp, and
exact zeros / NEG_INF lse for query rows with no valid key. The CUDA
kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, marked ``cuda``, and chip_smoke.py).
Tolerance: atol 2e-5 in f32, the JAX package's own for this kernel
(tests/test_pallas_attention.py).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, check_inputs, flash_attention, flash_attention_plain,
)

ATOL = 2e-5


def _qkv(seed, B=2, H=2, T=24, D=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32)
            for _ in range(3)]


def _jax_fwd(q, k, v, causal, mask, dtype=jnp.float32):
    """(O, lse) of the JAX kernel K4 on the unpadded problem: the same
    padding and q pre-scale as ``flash_attention``, then ``_run_fwd``."""
    B, H, T, D = q.shape
    Tp, Dp = jpa._round_up(T, 128), jpa._round_up(D, 128)

    def prep(x):
        x = jnp.pad(jnp.asarray(x, dtype),
                    ((0, 0), (0, 0), (0, Tp - T), (0, Dp - D)))
        return x.reshape(B * H, Tp, Dp)

    valid = np.ones((B, T), np.float32) if mask is None else mask
    valid = np.pad(valid, ((0, 0), (0, Tp - T)))
    bias = jnp.repeat(jnp.where(jnp.asarray(valid) > 0, 0.0, jpa.NEG_INF)
                      .astype(jnp.float32), H, axis=0)
    qs = jnp.asarray(q, dtype) * (math.sqrt(Dp) / math.sqrt(D))
    out, lse = jpa._run_fwd(prep(qs), prep(k), prep(v), bias, causal, True)
    out = np.asarray(out.astype(jnp.float32)).reshape(B, H, Tp, Dp)
    return out[:, :, :T, :D], np.asarray(lse).reshape(B, H, Tp)[:, :, :T]


def _port(q, k, v, causal, mask, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention(*t, causal=causal, kv_mask=m, return_lse=True)
    return out.float().numpy(), lse.numpy()


def _hole_mask(B, T, lo, hi):
    m = np.ones((B, T), np.float32)
    m[:, lo:hi] = 0.0
    return m


@pytest.mark.parametrize("case", [
    dict(causal=True, T=24, D=8, mask=None),
    dict(causal=False, T=24, D=8, mask=None),
    dict(causal=False, T=20, D=8, mask="random"),
    dict(causal=True, T=20, D=16, mask="random"),
    # T=300 spans three 128-row blocks of the TPU kernel: the online-softmax
    # carry across blocks, causal block skipping and a masked hole in block 2
    dict(causal=True, T=300, D=8, mask="hole"),
], ids=["causal", "full", "masked", "causal-masked", "T300-causal-hole"])
def test_plain_matches_jax_kernel(case):
    q, k, v = _qkv(1, T=case["T"], D=case["D"])
    B, T = q.shape[0], q.shape[2]
    mask = None
    if case["mask"] == "random":
        mask = (np.random.default_rng(2).random((B, T)) > 0.3).astype(
            np.float32)
        mask[:, 0] = 1.0
    elif case["mask"] == "hole":
        mask = _hole_mask(B, T, 130, 170)
    ref_o, ref_lse = _jax_fwd(q, k, v, case["causal"], mask)
    got_o, got_lse = _port(q, k, v, case["causal"], mask)
    np.testing.assert_allclose(got_o, ref_o, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got_lse, ref_lse, atol=ATOL, rtol=ATOL)
    # the public JAX entry point agrees with the padded-kernel helper
    pub = jpa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=case["causal"],
                              kv_mask=None if mask is None
                              else jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(got_o, np.asarray(pub), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_zero_valid_key_rows(causal):
    """Query rows with no valid key: exactly 0 output and lse == NEG_INF,
    on both sides. Batch 0 has no valid key at all; in batch 1 key 0 is
    masked, so under causal masking query row 0 has none either."""
    q, k, v = _qkv(3, B=2, H=2, T=12, D=8)
    mask = np.ones((2, 12), np.float32)
    mask[0] = 0.0
    mask[1, 0] = 0.0
    ref_o, ref_lse = _jax_fwd(q, k, v, causal, mask)
    got_o, got_lse = _port(q, k, v, causal, mask)
    assert np.all(got_o[0] == 0.0) and np.all(ref_o[0] == 0.0)
    assert np.all(got_lse[0] == np.float32(NEG_INF))
    assert np.all(ref_lse[0] == np.float32(NEG_INF))
    if causal:
        assert np.all(got_o[1, :, 0] == 0.0)
        assert np.all(got_lse[1, :, 0] == np.float32(NEG_INF))
    np.testing.assert_allclose(got_o, ref_o, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got_lse, ref_lse, atol=ATOL, rtol=ATOL)


def test_bf16_inputs_accumulate_in_f32():
    """bf16 q/k/v: the plain version reads bf16, computes in f32 and
    returns O in bf16 (lse f32), as the JAX kernel does. O is compared at
    two bf16 ulps of 1.0, lse at 1e-5 (both sides reduce the same bf16
    inputs in f32; D=8 makes the JAX pre-scale an exact power of two)."""
    q, k, v = _qkv(4, T=40, D=8)
    mask = _hole_mask(2, 40, 10, 20)
    ref_o, ref_lse = _jax_fwd(q, k, v, True, mask, dtype=jnp.bfloat16)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out, lse = flash_attention(*t, causal=True,
                               kv_mask=torch.from_numpy(mask),
                               return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), ref_o, atol=1.6e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    ref, _ = flash_attention_plain(q, k, v, causal=True)
    assert flash_attention.launches == before
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bad", ["D129", "float16", "shape", "mask", "T0"])
def test_inputs_outside_the_contract_raise(bad):
    q = torch.zeros(2, 2, 8, 16)
    k, v, mask = q.clone(), q.clone(), None
    if bad == "D129":
        q = k = v = torch.zeros(1, 1, 4, 129)
    elif bad == "float16":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "shape":
        k = torch.zeros(2, 2, 9, 16)
    elif bad == "mask":
        mask = torch.ones(2, 9)
    elif bad == "T0":
        q = k = v = torch.zeros(2, 2, 0, 16)
    with pytest.raises(ValueError):
        check_inputs(q, k, v, mask)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_mask=mask)
