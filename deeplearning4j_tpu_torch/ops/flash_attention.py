"""Flash attention: the port of the JAX package's ``ops/pallas_attention.py``
forward (``_fwd_kernel`` via ``_run_fwd``, K4) and its FlashAttention-2
backward (``_dq_kernel`` K5 and ``_dkv_kernel`` K6 via ``_run_bwd``).

``flash_attention`` is the one entry point. It runs through
``FlashAttentionFunction`` (a ``torch.autograd.Function``, the counterpart
of the JAX ``custom_vjp``) on every device. On CUDA tensors the forward
launches the hand-written Hopper kernel ``csrc/flash_attn_fwd.cu`` and the
backward ``csrc/flash_attn_dq.cu`` and ``csrc/flash_attn_dkv.cu`` (built
with nvcc on first use, see ``cuda_build``); each wrapper counts its
launches (``flash_attention.launches``, ``flash_attention_dq.launches``,
``flash_attention_dkv.launches``), and a launch it cannot make raises. On
CPU tensors the same Function runs the plain versions,
``flash_attention_plain`` and ``flash_attention_bwd_plain``: the same
contracts in explicit f32 einsums, which the tests hold against the JAX
kernels and the card holds the CUDA kernels against. The backward is the
FA2 recomputation, never autograd through the plain forward. Under
``torch.no_grad()`` (serving) nothing is saved for a backward.

Contract (the TPU kernels'): q, k, v ``[B, H, T, D]`` (self-attention:
one T), ``kv_mask`` ``[B, T]`` key validity (> 0 = valid), scale
1/sqrt(D), causal masking. Returns O in q's dtype and, on request, the
row log-sum-exp ``lse`` ``[B, H, T]`` in f32 (natural log). A query row
with no valid key gets exactly 0 output and ``lse == NEG_INF``. The
backward takes ``Dvec = rowsum(dO * O)`` in f32 from the forward's O,
recomputes ``p = exp(s - lse)`` gated to 0 (a select, before any product)
where ``lse <= NEG_INF / 2``, ``ds = p (dp - Dvec)``, and returns
``dq = ds k / sqrt(D)``, ``dk = ds^T q / sqrt(D)``, ``dv = p^T dO`` in the
input dtype: a row with no valid key gets exactly 0 dq and adds nothing
to dk/dv. The mask gets no gradient. Types: float32, or bfloat16 with f32
accumulation; any head dim D >= 1, on every device. The kernels keep a
row's accumulators in registers up to ``MAX_HEAD_DIM`` (templates of 32,
64, 128 and 256 columns); a wider head runs their wide template, which
splits the output columns into chunks of 256 across blocks and sums
``q k^T`` (and ``dO v^T``) over the whole head chunk by chunk.

``flash_ok`` is the JAX package's gate for its Pallas kernel, kept so the
attention layer runs a kernel at every shape where the reference does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.analysis.steprecord import note_launch
from deeplearning4j_tpu_torch.ops.cuda_build import load_library

NEG_INF = -1e30
#: the widest head dim whose output row one block holds in registers (the
#: kernels' widest register template); wider heads run the wide template,
#: which splits the output columns into chunks of this width across blocks
MAX_HEAD_DIM = 256
#: dtype codes of the C entry point
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_ok(T: int, D: int = 128, vmem_budget: int = 6 * 2 ** 20) -> bool:
    """The reference's test for running its Pallas kernel: the K and V
    panels of one (batch, head), T and D each padded to 128, f32, fit a
    6 MiB VMEM budget. The port's kernels stream K and V, so they have no
    such limit; the layer sends a head wider than ``MAX_HEAD_DIM`` to
    them (their wide template) wherever this passes, and to blockwise
    attention, as the reference does, wherever it fails."""
    Tp, Dp = -(-T // 128) * 128, -(-D // 128) * 128
    return 2 * Tp * Dp * 4 <= vmem_budget


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
    if D < 1:
        raise ValueError(f"flash_attention needs a head dim >= 1, got {D}")
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


def _valid_pairs(B, T, causal, kv_mask, device):
    """[B, 1, T, T] bool: (query, key) pairs the contract attends over."""
    valid = torch.ones((B, 1, T, T), dtype=torch.bool, device=device)
    if kv_mask is not None:
        valid = valid & (kv_mask > 0)[:, None, None, :]
    if causal:
        valid = valid & torch.ones((T, T), dtype=torch.bool,
                                   device=device).tril()
    return valid


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          kv_mask: Optional[torch.Tensor] = None):
    """The forward kernel's contract in explicit f32 einsums. Returns
    ``(out in q's dtype, lse f32)``."""
    B, H, T, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(D))
    s = torch.where(_valid_pairs(B, T, causal, kv_mask, q.device), s,
                    NEG_INF)
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


def attention_dvec(d_out, out):
    """``Dvec = rowsum(dO * O)`` ``[B, H, T]`` f32, from the forward's O:
    computed outside the backward kernels, as the JAX package does."""
    return (d_out.float() * out.float()).sum(dim=-1)


def attention_bwd_plain(q, k, v, d_out, lse, dvec, *, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None,
                        want_dq: bool = True, want_dkv: bool = True):
    """The FA2 recomputation in explicit f32 einsums from ``lse`` and
    ``dvec``: ``(dq, dk, dv)`` in the input dtype, None for a part not
    asked for (the plain version of K5 alone, or of K6 alone)."""
    B, H, T, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), d_out.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    # the gate is a select before any product: exp(s - lse) on a row with
    # lse = NEG_INF is inf, and inf * 0 would be NaN
    ok = _valid_pairs(B, T, causal, kv_mask, q.device) \
        & (lse > NEG_INF / 2)[..., None]
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - dvec[..., None])
    dq = dk = dv = None
    if want_dq:
        dq = (torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale).to(q.dtype)
    if want_dkv:
        dk = (torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale).to(k.dtype)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, d_out, out, lse, *,
                              causal: bool = False,
                              kv_mask: Optional[torch.Tensor] = None):
    """The backward kernels' contract in explicit f32 einsums, from the
    forward's ``out`` and ``lse``. Returns ``(dq, dk, dv)``."""
    return attention_bwd_plain(q, k, v, d_out, lse,
                               attention_dvec(d_out, out), causal=causal,
                               kv_mask=kv_mask)


def flash_fwd_flops(B, H, T, D) -> int:
    """K4's FLOPs: its plain version's two products, ``q k^T`` and
    ``p v``, over every (query, key) pair (a causal call too), as
    ``FlopCounterMode`` counts ``flash_attention_plain``."""
    return 4 * B * H * T * T * D


def flash_dq_flops(B, H, T, D) -> int:
    """K5's FLOPs, as the counter counts ``attention_bwd_plain(...,
    want_dkv=False)``: the recompute of ``s``, ``dp`` and ``dq``."""
    return 6 * B * H * T * T * D


def flash_dkv_flops(B, H, T, D) -> int:
    """K6's FLOPs, as the counter counts ``attention_bwd_plain(...,
    want_dq=False)``: the recompute of ``s``, ``dp``, ``dk`` and ``dv``."""
    return 8 * B * H * T * T * D


def _kernel(name: str, n_ptr: int):
    """The C entry ``dl4j_<name>`` of ``csrc/<name>.cu``: ``n_ptr``
    pointers, then (BH, H, T, D, causal, dtype) and the stream."""
    fn = getattr(load_library(name), f"dl4j_{name}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(name, n_ptr, ptrs, q, causal):
    """Launch kernel ``name`` on q's device and stream; raise on a CUDA
    error (a refused launch never runs, so it must not pass silently)."""
    B, H, T, D = q.shape
    fn = _kernel(name, n_ptr)
    with torch.cuda.device(q.device):
        err = fn(*ptrs, B * H, H, T, D, int(causal), _KERNEL_DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype})")


def _mask_f32(kv_mask):
    return (None if kv_mask is None
            else kv_mask.to(torch.float32).contiguous())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, causal, kv_mask):
    B, H, T, D = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    mask = _mask_f32(kv_mask)
    _call("flash_attn_fwd", 6, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                _ptr(mask), out.data_ptr(), lse.data_ptr()],
          q, causal)
    flash_attention.launches += 1
    note_launch("flash_attn_fwd", "kernel", flash_fwd_flops(B, H, T, D),
                q, k, v)
    return out, lse


def check_bwd_inputs(q, k, v, d_out, lse, dvec, kv_mask=None) -> None:
    """``check_inputs`` plus the backward's own tensors: ``d_out`` like q,
    ``lse`` and ``dvec`` ``[B, H, T]`` f32, all on one device."""
    check_inputs(q, k, v, kv_mask)
    if d_out.shape != q.shape or d_out.dtype != q.dtype:
        raise ValueError(
            f"d_out must match q ({tuple(q.shape)} {q.dtype}), got "
            f"{tuple(d_out.shape)} {d_out.dtype}")
    want = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("dvec", dvec)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {want} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in (q, d_out, lse, dvec)}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")


def _bwd_launch(name, q, k, v, d_out, lse, dvec, causal, kv_mask, outs):
    """Launch backward kernel ``name`` writing ``outs`` (CUDA only)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not "
                         f"{q.device.type}")
    ins = [t.contiguous() for t in (q, k, v)] + [_mask_f32(kv_mask)] \
        + [t.contiguous() for t in (d_out, lse, dvec)]
    _call(name, len(ins) + len(outs), [_ptr(t) for t in ins + list(outs)],
          q, causal)


def flash_attention_dq(q, k, v, d_out, lse, dvec, *, causal: bool = False,
                       kv_mask: Optional[torch.Tensor] = None):
    """dq of the FA2 backward: the K5 kernel (``csrc/flash_attn_dq.cu``)
    for CUDA tensors, the plain version for CPU tensors."""
    check_bwd_inputs(q, k, v, d_out, lse, dvec, kv_mask)
    if q.device.type == "cpu":
        note_launch("flash_attn_dq", "plain", flash_dq_flops(*q.shape),
                    q, k, v, d_out)
        return attention_bwd_plain(q, k, v, d_out, lse, dvec, causal=causal,
                                   kv_mask=kv_mask, want_dkv=False)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_attn_dq", q, k, v, d_out, lse, dvec, causal, kv_mask,
                (dq,))
    flash_attention_dq.launches += 1
    note_launch("flash_attn_dq", "kernel", flash_dq_flops(*q.shape),
                q, k, v, d_out)
    return dq


def flash_attention_dkv(q, k, v, d_out, lse, dvec, *, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None):
    """(dk, dv) of the FA2 backward: the K6 kernel
    (``csrc/flash_attn_dkv.cu``) for CUDA tensors, the plain version for
    CPU tensors."""
    check_bwd_inputs(q, k, v, d_out, lse, dvec, kv_mask)
    if q.device.type == "cpu":
        note_launch("flash_attn_dkv", "plain", flash_dkv_flops(*q.shape),
                    q, k, v, d_out)
        return attention_bwd_plain(q, k, v, d_out, lse, dvec, causal=causal,
                                   kv_mask=kv_mask, want_dq=False)[1:]
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    _bwd_launch("flash_attn_dkv", q, k, v, d_out, lse, dvec, causal, kv_mask,
                (dk, dv))
    flash_attention_dkv.launches += 1
    note_launch("flash_attn_dkv", "kernel", flash_dkv_flops(*q.shape),
                q, k, v, d_out)
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """The JAX ``_flash_core`` custom VJP: forward K4 (or its plain
    version), backward ``Dvec`` then K5 and K6 (or the plain backward).
    Outputs ``(out, lse)``; lse carries no gradient, nor does the mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "cuda":
            out, lse = _launch(q, k, v, causal, kv_mask)
        else:
            note_launch("flash_attn_fwd", "plain", flash_fwd_flops(*q.shape),
                        q, k, v)
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             kv_mask=kv_mask)
        # kept only when a backward can run (grad mode on, an input
        # requiring grad): autograd drops them otherwise
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out, _d_lse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dvec = attention_dvec(d_out, out)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_attention_dq(q, k, v, d_out, lse, dvec,
                                    causal=ctx.causal, kv_mask=kv_mask)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_attention_dkv(q, k, v, d_out, lse, dvec,
                                         causal=ctx.causal, kv_mask=kv_mask)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """softmax(q k^T / sqrt(D), causal, kv_mask) v: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors, differentiable in
    q, k and v. ``return_lse`` also returns the row log-sum-exp
    ``[B, H, T]`` (f32)."""
    check_inputs(q, k, v, kv_mask)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    out, lse = FlashAttentionFunction.apply(q, k, v, kv_mask, causal)
    return (out, lse) if return_lse else out


#: kernel launches made by this process (plain-version calls do not count)
flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
