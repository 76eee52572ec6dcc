"""Fused LSTM: the port of the JAX package's ``ops/pallas_kernels.py``
recurrence kernels and their custom VJP (``_fused_lstm_core``).

Three hand-written Hopper kernels, each built with nvcc on first use (see
``cuda_build``) and each counting its launches on its wrapper:

- K1 ``csrc/lstm_fwd_infer.cu`` (``_lstm_fwd_infer_kernel``), the
  inference recurrence, counted in ``lstm_recurrence.launches``;
- K2 ``csrc/lstm_fwd_train.cu`` (``_lstm_fwd_kernel``): K1's recurrence,
  also saving the gates and cells for the backward; wrapper
  ``lstm_fwd_train``;
- K3 ``csrc/lstm_bwd.cu`` (``_lstm_bwd_kernel``): the reverse-time
  sweep; wrapper ``lstm_bwd``.

K1 and K2 share two bodies (``csrc/lstm_common.cuh``), and the C entry
picks one from (H, dtype) alone, the same on every call: the resident
body wherever RW's slices fit the shared memory of a cluster of 8 CTAs
(H <= ``RESIDENT_MAX_HIDDEN``: 312 in f32, 424 in bf16), else the
streaming body, up to ``MAX_HIDDEN``. The resident body keeps RW on chip
for all T steps, split by hidden unit across the cluster, one cluster per
4 batch rows, and exchanges h through distributed shared memory with one
cluster barrier a step; the streaming body reads RW from L2 every step,
one block per batch row. K3 has the mirror image of both bodies, picked
the same way up to its own limit (``BWD_RESIDENT_MAX_HIDDEN``: 312 in
f32, 420 in bf16) wherever every CTA of the cluster owns a unit (not
below 8, nor at H = 9-14, 17-21, 25-28, 33-35, 41-42 or 49, where
ceil(H / 8) units a CTA leave the last CTA none): each CTA keeps the rows of RW^T for its units' four
gate columns of dz, sums its partial dh_prev over them for every k, and
sends each partial to the CTA that owns k through distributed shared
memory, where the 8 partials are added in rank order. ``launch_plan``
asks the built library which body a launch of any of the three takes. A
cluster launch the card refuses raises, as any refused launch does.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors
it runs the plain version of the same contract (``lstm_recurrence_plain``,
``lstm_fwd_train_plain``, ``lstm_bwd_plain``: f32 step loops), which the
tests hold against the JAX kernels and the card holds the CUDA kernels
against.

``FusedLSTMFunction`` is the custom VJP: its forward runs K2 when grad
mode is on and an input requires grad, else K1 (as JAX's primal does);
its backward runs K3, then ``dRW`` and ``dpw`` as plain matmuls and
reductions. ``lstm_recurrence`` is the time-major core through it, and
``fused_lstm`` wraps the core for a batch-major ``[B, T, F]`` sequence:
the input projection ``x @ W + b`` is one ``torch.matmul`` outside the
kernels, as in the JAX package.

Contract (the TPU kernels'): ``xz [T, B, 4H]`` (= x@W+b, gate blocks
i, f, g, o), ``rw [H, 4H]``, peepholes ``pw [3, H]`` (rows i, f, o; all
zeros = no peepholes), carries ``h0, c0 [B, H]``. Per step
``z = xz[t] + h @ rw``; i and f read ``c_prev`` through their peepholes,
o reads ``c_new``; ``forget_bias`` is added to f's pre-activation at every
step. Types: float32, or bfloat16 with f32 arithmetic; the carries (h, c),
the saved gates and cells, dz and the backward's (dh, dc) carries are
rounded to the input type every step, where the TPU kernels keep them in
outputs or VMEM scratch of that type. No padding: the JAX package pads H
to 128 and B to 8 with zero gate blocks, which is exact, so the unpadded
math is the contract and the kernels mask their own tails. Any B >= 1,
T >= 1 and 1 <= H <= ``MAX_HIDDEN``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.cuda_build import load_library
from deeplearning4j_tpu_torch.profiling.cost import count_kernel_flops

#: the widest H the kernels launch at: K1/K2's streaming body keeps two
#: buffers of h and one of c (3H floats) and 3 x 4 x 256 partial sums in
#: shared memory, within the 48 KB a block gets by default (a wider H fails
#: to launch); K3's streaming body raises its block's limit for its
#: 6H + 3 x 256 floats. Both resident bodies stop well below it.
MAX_HIDDEN = (48 * 1024 // 4 - 3 * 4 * 256) // 3
#: dtype codes of the C entry points
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest H K1/K2's resident body takes, per input type: the largest H
#: whose CTA fits an H100's 227 KB of shared memory (csrc/lstm_common.cuh
#: ``resident_smem_bytes``): its slice of RW, [Hp, 4U] in the input type,
#: two h buffers [4, Hp] and the partial sums [8, 4, 4U] in f32, with
#: U = ceil(H / 8) units a CTA and Hp = H rounded up to a multiple of 32
RESIDENT_MAX_HIDDEN = {torch.float32: 312, torch.bfloat16: 424}
#: the widest H K3's resident body takes, per input type: the largest H
#: whose CTA fits 227 KB (csrc/lstm_bwd.cu ``bwd_resident_smem_bytes``):
#: its rows of RW^T, [NCp, Hp] in the input type (NCp = 4U padded to a
#: multiple of 16, Hp = H padded to even), dz [4, NCp], the partial sums
#: [4, 4, Hp] and two receive buffers [2, 8, 4, U] in f32, and the
#: buffers' two mbarriers
BWD_RESIDENT_MAX_HIDDEN = {torch.float32: 312, torch.bfloat16: 420}


def _check_tensors(what: str, tensors: dict, dtype) -> None:
    """Raise ValueError unless every tensor has its shape, ``dtype``, is
    contiguous and all lie on one device. ``tensors``: name -> (tensor,
    shape)."""
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    args = [t for t, _ in tensors.values()]
    if dtype not in _KERNEL_DTYPES or any(t.dtype != dtype for t in args):
        raise ValueError(
            f"{what} takes float32 or bfloat16 inputs of one "
            f"dtype, got {[str(t.dtype) for t in args]}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{what} takes contiguous tensors")
    devs = {t.device for t in args}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")
    dev = args[0].device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")


def check_inputs(xz, rw, pw, h0, c0) -> None:
    """Raise ValueError on forward inputs outside the kernels' contract
    (the same check on every device, so a CPU run refuses what the card
    would)."""
    if xz.dim() != 3 or xz.shape[-1] % 4:
        raise ValueError(f"xz must be [T, B, 4H], got {tuple(xz.shape)}")
    T, B, H4 = xz.shape
    H = H4 // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"lstm_recurrence needs T, B, H >= 1, got "
                         f"T={T}, B={B}, H={H}")
    if H > MAX_HIDDEN:
        raise ValueError(f"hidden size {H} above the kernel's {MAX_HIDDEN}")
    _check_tensors("lstm_recurrence", {
        "xz": (xz, (T, B, H4)), "rw": (rw, (H, H4)), "pw": (pw, (3, H)),
        "h0": (h0, (B, H)), "c0": (c0, (B, H))}, xz.dtype)


def check_bwd_inputs(eps, gates, cs, c0, rw, pw, dh_T, dc_T) -> None:
    """Raise ValueError on backward inputs outside K3's contract: eps and
    cs ``[T, B, H]``, gates ``[T, B, 4H]``, rw ``[H, 4H]``, pw ``[3, H]``,
    c0, dh_T and dc_T ``[B, H]``."""
    if gates.dim() != 3 or gates.shape[-1] % 4:
        raise ValueError(f"gates must be [T, B, 4H], got "
                         f"{tuple(gates.shape)}")
    T, B, H4 = gates.shape
    H = H4 // 4
    if T < 1 or B < 1 or H < 1 or H > MAX_HIDDEN:
        raise ValueError(f"lstm_bwd needs T, B >= 1 and 1 <= H <= "
                         f"{MAX_HIDDEN}, got T={T}, B={B}, H={H}")
    _check_tensors("lstm_bwd", {
        "eps": (eps, (T, B, H)), "gates": (gates, (T, B, H4)),
        "cs": (cs, (T, B, H)), "c0": (c0, (B, H)), "rw": (rw, (H, H4)),
        "pw": (pw, (3, H)), "dh_T": (dh_T, (B, H)),
        "dc_T": (dc_T, (B, H))}, gates.dtype)


# ------------------------------------------------------------ plain versions

def _plain_steps(xz, rw, pw, h0, c0, forget_bias):
    """The forward recurrence in f32, one step at a time: yields each
    step's gates (i, f, g, o) and its (h, c) carry rounded to xz's dtype
    (held as f32)."""
    dt = xz.dtype
    H = rw.shape[0]
    xzf, rwf, pwf = xz.float(), rw.float(), pw.float()
    h, c = h0.float(), c0.float()
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
        yield (i, f, g, o), h, c


def lstm_recurrence_plain(xz, rw, pw, h0, c0, *, forget_bias: float = 0.0):
    """K1's contract as a plain step loop in f32. Returns
    ``(hs, h_T, c_T)`` in xz's dtype."""
    hs = []
    for _, h, c in _plain_steps(xz, rw, pw, h0, c0, forget_bias):
        hs.append(h)
    hs = torch.stack(hs).to(xz.dtype)
    return hs, hs[-1], c.to(xz.dtype)


def lstm_fwd_train_plain(xz, rw, pw, h0, c0, *, forget_bias: float = 0.0):
    """K2's contract as a plain step loop in f32: K1's recurrence, also
    returning the post-activation gates ``[T, B, 4H]`` (i, f, g, o) and
    the cells ``[T, B, H]``. Returns ``(hs, gates, cs)`` in xz's dtype."""
    hs, gates, cs = [], [], []
    for g4, h, c in _plain_steps(xz, rw, pw, h0, c0, forget_bias):
        hs.append(h)
        gates.append(torch.cat(g4, dim=-1))
        cs.append(c)
    dt = xz.dtype
    return (torch.stack(hs).to(dt), torch.stack(gates).to(dt),
            torch.stack(cs).to(dt))


def lstm_bwd_plain(eps, gates, cs, c_prev, rw, pw, dh_T, dc_T):
    """K3's contract as a plain reverse step loop in f32, with the JAX
    kernel's arguments (``c_prev[t]`` = ``cs[t-1]``, ``c0`` at t = 0).
    Returns ``(dz [T, B, 4H], dh0, dc0)`` in eps's dtype; dz and the
    (dh, dc) carries are rounded to it every step, and dh_prev is summed
    from the rounded dz."""
    dt = eps.dtype
    H = rw.shape[0]
    rwt = rw.float().t()
    pi, pf, po = pw.float()
    dh, dc = dh_T.float(), dc_T.float()
    dz = [None] * eps.shape[0]
    for t in reversed(range(eps.shape[0])):
        i, f, g, o = gates[t].float().split(H, dim=-1)
        c_t, cp = cs[t].float(), c_prev[t].float()
        dh = dh + eps[t].float()
        tc = torch.tanh(c_t)
        dzo = dh * tc * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tc * tc) + dzo * po
        dzi = dc * g * i * (1.0 - i)
        dzf = dc * cp * f * (1.0 - f)
        dzg = dc * i * (1.0 - g * g)
        dz[t] = torch.cat([dzi, dzf, dzg, dzo], dim=-1).to(dt).float()
        dc = (dc * f + dzi * pi + dzf * pf).to(dt).float()
        dh = (dz[t] @ rwt).to(dt).float()
    return torch.stack(dz).to(dt), dh.to(dt), dc.to(dt)


def lstm_recurrence_flops(T, B, H) -> int:
    """K1's and K2's FLOPs: their plain versions' one product a step,
    ``h [B, H] @ RW [H, 4H]``, as ``FlopCounterMode`` counts them."""
    return 8 * T * B * H * H


def lstm_bwd_flops(T, B, H) -> int:
    """K3's FLOPs: its plain version's one product a step,
    ``dz [B, 4H] @ RW^T [4H, H]``."""
    return 8 * T * B * H * H


# ------------------------------------------------------------------ kernels

def _entry(name: str, n_ptr: int, n_int: int, with_fb: bool):
    """The C entry ``dl4j_<name>`` of ``csrc/<name>.cu``: ``n_ptr``
    pointers, ``n_int`` ints (T, B, H), the forget bias if ``with_fb``,
    the dtype code and the stream."""
    fn = getattr(load_library(name), f"dl4j_{name}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + ([ctypes.c_float] if with_fb else []) \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(name, fn, tensors, ints, extra, like):
    """Launch on ``like``'s device and current stream; raise on a CUDA
    error (a refused launch never runs, so it must not pass silently)."""
    with torch.cuda.device(like.device):
        err = fn(*[t.data_ptr() for t in tensors], *ints, *extra,
                 _KERNEL_DTYPES[like.dtype],
                 torch.cuda.current_stream(like.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with CUDA error {err} "
            f"({tuple(like.shape)} {like.dtype})")


def _launch(xz, rw, pw, h0, c0, forget_bias):
    """K1 on CUDA tensors: ``(hs, h_T, c_T)``."""
    T, B, H4 = xz.shape
    H = H4 // 4
    hs = torch.empty((T, B, H), dtype=xz.dtype, device=xz.device)
    cT = torch.empty((B, H), dtype=xz.dtype, device=xz.device)
    _call("lstm_fwd_infer", _entry("lstm_fwd_infer", 7, 3, True),
          (xz, rw, pw, h0, c0, hs, cT), (T, B, H), (float(forget_bias),), xz)
    lstm_recurrence.launches += 1
    count_kernel_flops("lstm_fwd_infer", lstm_recurrence_flops(T, B, H))
    return hs, hs[-1], cT


def launch_plan(name: str, B: int, H: int, dtype) -> dict:
    """The launch the C entry of K1 (``name="lstm_fwd_infer"``), K2
    (``"lstm_fwd_train"``) or K3 (``"lstm_bwd"``) makes for B rows of
    hidden size H, as the built library reports it: the body, rows and
    CTAs a cluster, blocks, threads, shared memory and the clusters the
    card holds at once. Builds the library; needs a card."""
    fn = getattr(load_library(name), f"dl4j_{name}_plan")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(B, H, _KERNEL_DTYPES[dtype], out)
    if err != 0:
        raise RuntimeError(f"{name} has no launch for B={B}, H={H}, "
                           f"{dtype}: CUDA error {err}")
    return dict(body="resident" if out[0] else "streaming",
                rows_per_cluster=out[0], cluster=out[1], blocks=out[2],
                threads=out[3], smem_bytes=out[4],
                max_active_clusters=out[5])


def lstm_fwd_train(xz, rw, pw, h0, c0, *, forget_bias: float = 0.0):
    """The training forward: the K2 kernel for CUDA tensors, the plain
    version for CPU tensors. Returns ``(hs, gates, cs)``; c_T is
    ``cs[-1]``."""
    check_inputs(xz, rw, pw, h0, c0)
    if xz.device.type == "cpu":
        return lstm_fwd_train_plain(xz, rw, pw, h0, c0,
                                    forget_bias=forget_bias)
    T, B, H4 = xz.shape
    H = H4 // 4
    hs, cs = (torch.empty((T, B, H), dtype=xz.dtype, device=xz.device)
              for _ in range(2))
    gates = torch.empty_like(xz)
    _call("lstm_fwd_train", _entry("lstm_fwd_train", 8, 3, True),
          (xz, rw, pw, h0, c0, hs, gates, cs), (T, B, H),
          (float(forget_bias),), xz)
    lstm_fwd_train.launches += 1
    count_kernel_flops("lstm_fwd_train", lstm_recurrence_flops(T, B, H))
    return hs, gates, cs


def lstm_bwd(eps, gates, cs, c0, rw, pw, dh_T, dc_T):
    """The backward sweep: the K3 kernel for CUDA tensors (given rw, it
    passes the transposed copy rw^T the kernel reads), the plain version
    for CPU tensors. Takes c0 where the JAX kernel takes c_prev (= c0
    then cs[:-1]). Returns ``(dz [T, B, 4H], dh0, dc0)``."""
    check_bwd_inputs(eps, gates, cs, c0, rw, pw, dh_T, dc_T)
    if eps.device.type == "cpu":
        c_prev = torch.cat([c0[None], cs[:-1]])
        return lstm_bwd_plain(eps, gates, cs, c_prev, rw, pw, dh_T, dc_T)
    T, B, H4 = gates.shape
    dz = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    _call("lstm_bwd", _entry("lstm_bwd", 11, 3, False),
          (eps, gates, cs, c0, rw.t().contiguous(), pw, dh_T, dc_T, dz, dh0,
           dc0), (T, B, H4 // 4), (), eps)
    lstm_bwd.launches += 1
    count_kernel_flops("lstm_bwd", lstm_bwd_flops(T, B, H4 // 4))
    return dz, dh0, dc0


# ----------------------------------------------------------------- autograd

class FusedLSTMFunction(torch.autograd.Function):
    """The JAX ``_fused_lstm_core`` custom VJP over time-major inputs.
    ``train`` (grad mode on and an input requiring grad) picks the forward:
    K2, saving ``rw, pw, h0, c0, hs, gates, cs``; otherwise K1, saving
    nothing. Outputs ``(hs, c_T)``: h_T is ``hs[-1]``, taken outside, so
    its cotangent reaches ``hs``'s last step, which is what seeding the
    sweep with it computes. Backward: K3, then ``dRW = h_prev^T dz`` and
    the peepholes' ``dpw`` as plain matmuls and reductions, skipped where
    no gradient is needed; ``dxz`` is dz."""

    @staticmethod
    def forward(ctx, xz, rw, pw, h0, c0, forget_bias, train):
        if not train:
            if xz.device.type == "cuda":
                hs, _, cT = _launch(xz, rw, pw, h0, c0, forget_bias)
            else:
                hs, _, cT = lstm_recurrence_plain(xz, rw, pw, h0, c0,
                                                  forget_bias=forget_bias)
            return hs, cT
        hs, gates, cs = lstm_fwd_train(xz, rw, pw, h0, c0,
                                       forget_bias=forget_bias)
        ctx.save_for_backward(rw, pw, h0, c0, hs, gates, cs)
        return hs, cs[-1].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_hs, g_cT):
        rw, pw, h0, c0, hs, gates, cs = ctx.saved_tensors
        # an unused output's cotangent is None; hs's comes back as the
        # transposed view of the batch-major output
        g_hs = torch.zeros_like(hs) if g_hs is None else g_hs.contiguous()
        g_cT = torch.zeros_like(c0) if g_cT is None else g_cT.contiguous()
        dz, dh0, dc0 = lstm_bwd(g_hs, gates, cs, c0, rw, pw,
                                torch.zeros_like(h0), g_cT)
        T, B, H = hs.shape
        need = ctx.needs_input_grad
        drw = dpw = None
        if need[1]:
            h_prev = torch.cat([h0[None], hs[:-1]])
            drw = h_prev.reshape(T * B, H).t() @ dz.reshape(T * B, 4 * H)
        if need[2]:
            c_prev = torch.cat([c0[None], cs[:-1]])
            dpw = torch.stack([(c_prev * dz[..., :H]).sum((0, 1)),
                               (c_prev * dz[..., H:2 * H]).sum((0, 1)),
                               (cs * dz[..., 3 * H:]).sum((0, 1))])
        return (dz if need[0] else None, drw, dpw,
                dh0 if need[3] else None, dc0 if need[4] else None,
                None, None)


def lstm_recurrence(xz, rw, pw, h0, c0, *, forget_bias: float = 0.0):
    """The LSTM recurrence over time-major ``xz``, differentiable in every
    input: K1 when nothing needs a gradient, K2 then K3 in backward when
    something does (their plain versions on CPU tensors). Returns
    ``(hs [T, B, H], h_T, c_T)``."""
    check_inputs(xz, rw, pw, h0, c0)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xz, rw, pw, h0, c0))
    hs, cT = FusedLSTMFunction.apply(xz, rw, pw, h0, c0, float(forget_bias),
                                     train)
    return hs, hs[-1], cT


#: kernel launches made by this process (plain-version calls do not count)
lstm_recurrence.launches = 0       # K1
lstm_fwd_train.launches = 0        # K2
lstm_bwd.launches = 0              # K3


def fused_lstm(x, w, rw, b, pw: Optional[torch.Tensor], h0, c0, *,
               forget_bias: float = 0.0):
    """Fused LSTM over a batch-major ``[B, T, F]`` sequence: the input
    projection as one matmul, then the recurrence. ``pw`` is the flat
    ``[3H]`` peephole vector (rows i, f, o) or None for none. Returns
    ``(ys [B, T, H], h_T [B, H], c_T [B, H])``, differentiable in every
    input."""
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
