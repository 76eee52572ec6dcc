#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc; builds the
port's kernels from csrc/ on first use. Phases, each printing JSON lines:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions, kernel build time;
2. kernels — the flash-attention forward kernel against its plain PyTorch
   version on the card in five cases, with kernel / plain / SDPA times and
   the card's bound at the GPT slice's shape;
3. slice — the full-width GPT decoder (vocab 96, T 256, d_model 512,
   8 heads, 8 layers, f32, seeded random weights) on the card through
   ``ComputationGraph.output`` (with and without a key mask) and
   ``greedy_generate``, checked against the same net on the CPU, with
   its times and a torch.profiler breakdown of one forward and of 16
   decode steps;
4. a ``{"kernels": [...]}`` summary line;
5. last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line. It imports no JAX. Without a CUDA device it exits 2 and prints no
result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.gpt import gpt_decoder, greedy_generate
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.cuda_build import build_libraries
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_attention_plain,
)

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12       # CUDA cores, no tensor cores: the kernel's path

# Tolerances. f32: the kernel and the plain version differ only in the
# order of the f32 sums (the JAX package's own flash tolerance is 2e-5).
# bf16: O is rounded to bf16 on both sides, so two bf16 ulps of 1.0.
TOL_F32 = 2e-5
TOL_BF16_O = 1.6e-2
TOL_LSE = 1e-4
# the slice on the card vs the same net on the CPU: f32 GEMMs in another
# order through 8 layers (TF32 off), probabilities of a 96-way softmax
TOL_SLICE = 1e-4

SLICE = dict(vocab_size=96, seq_len=256, d_model=512, n_heads=8, n_layers=8)
SEED = 1234


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=5) -> float:
    """Median host time of ``fn`` ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_profile(fn, top=6):
    """One traced run of ``fn`` under torch.profiler: the wall time, the
    summed time of the CUDA kernels, their share of the wall time (the
    card's busy share; the trace itself slows the host, so it reads
    low), the kernel count and the kernels that took the most time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return dict(wall_ms=wall_us / 1e3, kernel_ms=busy_us / 1e3,
                busy_share=busy_us / wall_us,
                kernel_launches=sum(e.count for e in kernels),
                top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                     for e in kernels[:top]])


def flash_bound_ms(B, H, T, D, dtype, causal, mask):
    """Least time for the kernel's work on an H100: each input read once
    and each output written once over HBM, against the multiply-adds of
    q k^T and p v over the (query, key) pairs this input needs, at the
    peak rate of the kernel's arithmetic (f32 CUDA cores)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * H * T * D * es + B * H * T * 4
    if mask is None:
        valid = torch.ones(B, T)
    else:
        nbytes += B * T * 4
        valid = (mask > 0).float().cpu()
    per_key = (T - torch.arange(T)).float() if causal else torch.full(
        (T,), float(T))
    pairs = H * float((valid * per_key).sum())
    flops = 4.0 * D * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def kernel_case(name, B, H, T, D, causal, dtype, mask_kind, timed=False):
    g = torch.Generator().manual_seed(SEED + T + D)
    q, k, v = (torch.randn(B, H, T, D, generator=g).to("cuda", dtype)
               for _ in range(3))
    mask = None
    if mask_kind == "holes":       # batch 0: no valid key; batch 1: key 0
        mask = torch.ones(B, T)    # masked (query 0 has none under causal)
        mask[0] = 0.0
        mask[1, 0] = 0.0
        mask[1:, 130:170] = 0.0
    elif mask_kind == "half":
        mask = (torch.rand(B, T, generator=g) < 0.5).float()
    if mask is not None:
        mask = mask.cuda()
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    err_o = float((out.float() - ref.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol_o = TOL_F32 if dtype == torch.float32 else TOL_BF16_O
    rec = dict(phase="kernel", kernel="flash_attn_fwd", case=name,
               shape=[B, H, T, D], causal=causal, dtype=str(dtype),
               mask=mask_kind, max_abs_err_o=err_o, tol_o=tol_o,
               max_abs_err_lse=err_lse, tol_lse=TOL_LSE)
    if mask_kind == "holes":
        rows_ok = bool(torch.all(out[0] == 0) and torch.all(lse[0] == NEG_INF)
                       and torch.all(out[1:, :, 0] == 0)
                       and torch.all(lse[1:, :, 0] == NEG_INF))
        rec["no_valid_key_rows_exact"] = rows_ok
        check(rows_ok, f"case {name}: rows with no valid key are not "
                       "exactly 0 / NEG_INF")
    bound, bound_by, flops, nbytes = flash_bound_ms(B, H, T, D, dtype,
                                                    causal, mask)
    rec.update(bound_ms=bound, bound_by=bound_by, flops=flops, bytes=nbytes)
    if timed:
        rec["ms"] = cuda_ms(lambda: flash_attention(
            q, k, v, causal=causal, kv_mask=mask))
        rec["plain_ms"] = cuda_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, kv_mask=mask))
        # yardstick only: the port never calls SDPA
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)) if mask is None else None
        rec["achieved_tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    emit(rec)
    check(err_o <= tol_o, f"case {name}: O differs by {err_o} > {tol_o}")
    check(err_lse <= TOL_LSE,
          f"case {name}: lse differs by {err_lse} > {TOL_LSE}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_libraries(["flash_attn_fwd"])
    build_s = time.perf_counter() - t0
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_build_s=build_s))

    # ---- 2. kernels against their plain versions ---------------------------
    a = kernel_case("a_slice", 32, 8, 256, 64, True, torch.float32, None,
                    timed=True)
    kernel_case("b_T300_masked", 2, 8, 300, 64, True, torch.float32,
                "holes")
    kernel_case("c_D8_full", 4, 8, 256, 8, False, torch.float32, None)
    kernel_case("d_bf16", 32, 8, 256, 64, True, torch.bfloat16, None)
    kernel_case("e_slice_half_keys", 32, 8, 256, 64, True, torch.float32,
                "half", timed=True)

    # ---- 3. the slice: full-width GPT serving on the card ------------------
    conf = gpt_decoder(**SLICE)
    net = ComputationGraph(conf, device="cuda").init()
    cpu = ComputationGraph(gpt_decoder(**SLICE), device="cpu").init()
    B, T, V, L = 32, SLICE["seq_len"], SLICE["vocab_size"], \
        SLICE["n_layers"]
    rng = np.random.default_rng(SEED)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    lengths = rng.integers(T // 4, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 12, 27, 40)]
    n_new = 32

    flash_attention.launches = 0
    probs = net.output(x)
    torch.cuda.synchronize()
    launches_plain = flash_attention.launches
    probs_m = net.output(x, mask=mask)
    torch.cuda.synchronize()
    launches_masked = flash_attention.launches - launches_plain
    tokens = [greedy_generate(net, p, n_new) for p in prompts]
    main_path_launches = flash_attention.launches

    check(launches_plain == L and launches_masked == L,
          f"flash kernel launches per forward {launches_plain}, "
          f"{launches_masked} != n_layers {L}")
    check(tuple(probs.shape) == (B, T, V), f"output shape {probs.shape}")
    check(bool(torch.isfinite(probs).all() and torch.isfinite(probs_m).all()),
          "non-finite probabilities")
    sums = probs.sum(-1)
    sums_m = probs_m.sum(-1)
    mask_t = torch.from_numpy(mask).cuda()
    err_sum = float((sums - 1).abs().max())
    err_sum_m = float((sums_m - mask_t).abs().max())
    check(err_sum < 1e-5 and err_sum_m < 1e-5,
          f"probabilities do not sum to 1 (masked rows to 0): {err_sum}, "
          f"{err_sum_m}")
    ref = cpu.output(x)
    ref_m = cpu.output(x, mask=mask)
    err_cpu = float((probs.cpu() - ref).abs().max())
    err_cpu_m = float((probs_m.cpu() - ref_m).abs().max())
    cpu_tokens = [greedy_generate(cpu, p, n_new) for p in prompts]
    emit(dict(phase="slice", config=SLICE, params=net.num_params(),
              batch=[B, T, V], flash_launches_per_forward=[
                  launches_plain, launches_masked],
              max_abs_err_vs_cpu=err_cpu, max_abs_err_vs_cpu_masked=err_cpu_m,
              tol=TOL_SLICE, prob_sum_err=err_sum,
              prob_sum_err_masked=err_sum_m,
              prompt_lens=[len(p) for p in prompts], new_tokens=n_new,
              tokens_equal_cpu=tokens == cpu_tokens))
    check(err_cpu <= TOL_SLICE and err_cpu_m <= TOL_SLICE,
          f"card vs CPU output differs: {err_cpu}, {err_cpu_m}")
    check(tokens == cpu_tokens, f"greedy tokens differ: {tokens} vs "
                                f"{cpu_tokens}")

    fwd_ms = host_ms(lambda: net.output(x))
    fwd_m_ms = host_ms(lambda: net.output(x, mask=mask))
    gen1 = host_ms(lambda: greedy_generate(net, prompts[2], 1))
    gen_n = host_ms(lambda: greedy_generate(net, prompts[2], n_new))
    emit(dict(phase="slice_timing", forward_ms=fwd_ms,
              forward_tokens_per_s=B * T / (fwd_ms * 1e-3),
              forward_masked_ms=fwd_m_ms,
              attention_kernel_share_of_forward=L * a["ms"] / fwd_ms,
              prefill_plus_first_token_ms=gen1,
              decode_ms_per_step=(gen_n - gen1) / (n_new - 1),
              peak_mem_bytes=torch.cuda.max_memory_allocated()))

    _, decode = net.decode_fns()
    caches = net.init_decode_cache(1)
    x1 = torch.zeros((1, 1, V), device="cuda")
    x1[0, 0, 3] = 1.0
    emit(dict(phase="profile", window="output() of the [32, 256, 96] batch",
              **device_profile(lambda: net.output(x))))
    emit(dict(phase="profile", window="16 decode steps, 1 row",
              **device_profile(lambda: [decode(
                  net.params, net.states, caches, x1,
                  torch.tensor([60 + i], device="cuda"))
                  for i in range(16)])))

    # ---- 4. summary of every ported kernel ---------------------------------
    emit({"kernels": [dict(
        name="flash_attn_fwd", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="deeplearning4j_tpu/ops/pallas_attention.py:72",
        launches=main_path_launches, max_abs_err=a["max_abs_err_o"],
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
