"""Fused LSTM inference: the port of the JAX package's
``ops/pallas_kernels.py`` forward-only path (``_lstm_fwd_infer_kernel`` via
``_run_lstm_fwd_infer``, reached through ``_fused_lstm_core``'s primal).

``lstm_recurrence`` is the time-major core. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/lstm_fwd_infer.cu`` (built with nvcc on
first use, see ``cuda_build``) and counts the launch in
``lstm_recurrence.launches``; a launch it cannot make raises. On CPU
tensors it runs ``lstm_recurrence_plain``, the same contract as a plain
step loop in f32, which the tests hold against the JAX kernel and the card
holds the CUDA kernel against. ``fused_lstm`` wraps the core for a
batch-major ``[B, T, F]`` sequence: the input projection ``x @ W + b`` is
one ``torch.matmul`` outside the kernel, as in the JAX package.

Contract (the TPU kernel's): ``xz [T, B, 4H]`` (= x@W+b, gate blocks
i, f, g, o), ``rw [H, 4H]``, peepholes ``pw [3, H]`` (rows i, f, o; all
zeros = no peepholes), carries ``h0, c0 [B, H]``. Per step
``z = xz[t] + h @ rw``; i and f read ``c_prev`` through their peepholes,
o reads ``c_new``; ``forget_bias`` is added to f's pre-activation at every
step. Returns ``(hs [T, B, H], h_T, c_T)``. Forward only: the training
kernels K2/K3 and their backward come with slice 4 (ROADMAP A3), so both
entry points raise ``NotImplementedError`` on every device when grad mode
is on and an input requires grad (the kernel's output would otherwise
carry no gradient, silently). Types: float32, or bfloat16
with f32 arithmetic; the carry (h, c) is rounded to the input type after
every step, as the TPU kernel's VMEM carry in that type is. No padding:
the JAX package pads H to 128 and B to 8 with zero gate blocks, which is
exact, so the unpadded math is the contract and the kernel masks its own
tails. Any B >= 1, T >= 1 and 1 <= H <= ``MAX_HIDDEN``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.cuda_build import load_library

#: the widest H the kernel launches at: its block keeps two buffers of h
#: and one of c (3H floats) and 3 x 4 x 256 partial sums in shared memory,
#: within the 48 KB a block gets by default (a wider H fails to launch)
MAX_HIDDEN = (48 * 1024 // 4 - 3 * 4 * 256) // 3
#: dtype codes of the C entry point
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def refuse_grad(*tensors) -> None:
    """Raise when autograd would need this kernel's backward, which is
    not ported yet (the CPU refuses what the card would)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the fused LSTM is forward-only: its training kernels K2/K3 and "
            "their backward come with slice 4 (ROADMAP A3, LSTM training); "
            "run it under torch.no_grad()")


def check_inputs(xz, rw, pw, h0, c0) -> None:
    """Raise ValueError on inputs outside the kernel's contract (the same
    check on every device, so a CPU run refuses what the card would)."""
    if xz.dim() != 3 or xz.shape[-1] % 4:
        raise ValueError(f"xz must be [T, B, 4H], got {tuple(xz.shape)}")
    T, B, H4 = xz.shape
    H = H4 // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"lstm_recurrence needs T, B, H >= 1, got "
                         f"T={T}, B={B}, H={H}")
    if H > MAX_HIDDEN:
        raise ValueError(f"hidden size {H} above the kernel's {MAX_HIDDEN}")
    want = {"rw": (H, H4), "pw": (3, H), "h0": (B, H), "c0": (B, H)}
    for name, t in zip(want, (rw, pw, h0, c0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    args = (xz, rw, pw, h0, c0)
    if xz.dtype not in _KERNEL_DTYPES or any(t.dtype != xz.dtype
                                             for t in args):
        raise ValueError(
            "lstm_recurrence takes float32 or bfloat16 inputs of one "
            f"dtype, got {[str(t.dtype) for t in args]}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("lstm_recurrence takes contiguous tensors")
    devs = {t.device for t in args}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")


def lstm_recurrence_plain(xz, rw, pw, h0, c0, *, forget_bias: float = 0.0):
    """The kernel's contract as a plain step loop in f32. Returns
    ``(hs, h_T, c_T)`` in xz's dtype."""
    dt = xz.dtype
    H = rw.shape[0]
    xzf, rwf, pwf = xz.float(), rw.float(), pw.float()
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(xz.shape[0]):
        z = xzf[t] + h @ rwf
        zi, zf, zg, zo = z.split(H, dim=-1)
        i = torch.sigmoid(zi + c * pwf[0])
        f = torch.sigmoid(zf + c * pwf[1] + forget_bias)
        g = torch.tanh(zg)
        c_new = f * c + i * g
        o = torch.sigmoid(zo + c_new * pwf[2])
        h_new = o * torch.tanh(c_new)
        # the carry lives in the input dtype (a no-op for f32)
        h, c = h_new.to(dt).float(), c_new.to(dt).float()
        hs.append(h)
    hs = torch.stack(hs).to(dt)
    return hs, hs[-1], c.to(dt)


def _kernel():
    lib = load_library("lstm_fwd_infer")
    fn = lib.dl4j_lstm_fwd_infer
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xz, rw, pw, h0, c0, forget_bias):
    fn = _kernel()
    T, B, H4 = xz.shape
    H = H4 // 4
    hs = torch.empty((T, B, H), dtype=xz.dtype, device=xz.device)
    cT = torch.empty((B, H), dtype=xz.dtype, device=xz.device)
    with torch.cuda.device(xz.device):
        err = fn(xz.data_ptr(), rw.data_ptr(), pw.data_ptr(), h0.data_ptr(),
                 c0.data_ptr(), hs.data_ptr(), cT.data_ptr(), T, B, H,
                 float(forget_bias), _KERNEL_DTYPES[xz.dtype],
                 torch.cuda.current_stream(xz.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_fwd_infer kernel launch failed with CUDA error {err} "
            f"(xz {tuple(xz.shape)} {xz.dtype})")
    lstm_recurrence.launches += 1
    return hs, hs[-1], cT


def lstm_recurrence(xz, rw, pw, h0, c0, *, forget_bias: float = 0.0):
    """The LSTM recurrence over time-major ``xz``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    ``(hs [T, B, H], h_T, c_T)``."""
    refuse_grad(xz, rw, pw, h0, c0)
    check_inputs(xz, rw, pw, h0, c0)
    if xz.device.type == "cuda":
        return _launch(xz, rw, pw, h0, c0, forget_bias)
    if xz.device.type == "cpu":
        return lstm_recurrence_plain(xz, rw, pw, h0, c0,
                                     forget_bias=forget_bias)
    raise ValueError(f"lstm_recurrence runs on cuda or cpu, not "
                     f"{xz.device.type}")


#: kernel launches made by this process (plain-version calls do not count)
lstm_recurrence.launches = 0


def fused_lstm(x, w, rw, b, pw: Optional[torch.Tensor], h0, c0, *,
               forget_bias: float = 0.0):
    """Fused LSTM over a batch-major ``[B, T, F]`` sequence: the input
    projection as one matmul, then the recurrence. ``pw`` is the flat
    ``[3H]`` peephole vector (rows i, f, o) or None for none. Returns
    ``(ys [B, T, H], h_T [B, H], c_T [B, H])``."""
    refuse_grad(x, w, rw, b, pw, h0, c0)
    B, T, F = x.shape
    H = rw.shape[0]
    pw = (torch.zeros((3, H), dtype=x.dtype, device=x.device) if pw is None
          else pw.reshape(3, H))
    xz = (x.reshape(B * T, F) @ w + b).reshape(B, T, 4 * H)
    xz = xz.transpose(0, 1).contiguous()          # time-major
    hs, hT, cT = lstm_recurrence(xz, rw.contiguous(), pw.contiguous(),
                                 h0.contiguous(), c0.contiguous(),
                                 forget_bias=float(forget_bias))
    return hs.transpose(0, 1), hT, cT
