"""Flash-attention forward: the port of the JAX package's
``ops/pallas_attention.py`` forward (``_fwd_kernel`` via ``_run_fwd``).

``flash_attention`` is the one entry point. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/flash_attn_fwd.cu`` (built with nvcc on
first use, see ``cuda_build``) and counts the launch in
``flash_attention.launches``; a launch it cannot make raises. On CPU
tensors it runs ``flash_attention_plain``, the same contract in explicit
f32 einsums, which the tests hold against the JAX kernel and the card
holds the CUDA kernel against.

Contract (the TPU kernel's): q, k, v ``[B, H, T, D]`` (self-attention:
one T), ``kv_mask`` ``[B, T]`` key validity (> 0 = valid), scale
1/sqrt(D), causal masking. Returns O in q's dtype and, on request, the
row log-sum-exp ``lse`` ``[B, H, T]`` in f32. A query row with no valid
key gets exactly 0 output and ``lse == NEG_INF``. Types: float32, or
bfloat16 with f32 accumulation; head dims up to 128.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.cuda_build import load_library

NEG_INF = -1e30
MAX_HEAD_DIM = 128
#: dtype codes of the C entry point
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(q, k, v, kv_mask=None) -> None:
    """Raise ValueError on inputs outside the kernel's contract (the same
    check on every device, so a CPU run refuses what the card would)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, H, T, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, _, T, D = q.shape
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {D} outside the kernel's 1..{MAX_HEAD_DIM}")
    if T < 1:
        raise ValueError("flash_attention needs T >= 1")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, T):
        raise ValueError(
            f"kv_mask must be [B, T] = {(B, T)}, got {tuple(kv_mask.shape)}")
    devs = {x.device for x in (q, k, v) + (() if kv_mask is None
                                           else (kv_mask,))}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          kv_mask: Optional[torch.Tensor] = None):
    """The kernel's contract in explicit f32 einsums. Returns
    ``(out in q's dtype, lse f32)``."""
    B, H, T, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(D))
    valid = torch.ones((B, 1, T, T), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = valid & (kv_mask > 0)[:, None, None, :]
    if causal:
        valid = valid & torch.ones((T, T), dtype=torch.bool,
                                   device=q.device).tril()
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l_safe[..., None]
    # a row with no valid key never raises m off NEG_INF (its p are all
    # exp(0) = 1, so l is no test): zero output, NEG_INF lse
    row_ok = m > NEG_INF / 2
    out = torch.where(row_ok[..., None], out, 0.0)
    lse = torch.where(row_ok, m + torch.log(l_safe), NEG_INF)
    return out.to(q.dtype), lse


def _kernel():
    lib = load_library("flash_attn_fwd")
    fn = lib.dl4j_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, kv_mask):
    fn = _kernel()
    B, H, T, D = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    mask = (None if kv_mask is None
            else kv_mask.to(torch.float32).contiguous())
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B * H, H, T, D,
                 int(causal), _KERNEL_DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attn_fwd kernel launch failed with CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype})")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """softmax(q k^T / sqrt(D), causal, kv_mask) v: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. ``return_lse`` also
    returns the row log-sum-exp ``[B, H, T]`` (f32)."""
    check_inputs(q, k, v, kv_mask)
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, causal, kv_mask)
    elif q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal=causal,
                                         kv_mask=kv_mask)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return (out, lse) if return_lse else out


#: kernel launches made by this process (plain-version calls do not count)
flash_attention.launches = 0
