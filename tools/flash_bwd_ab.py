#!/usr/bin/env python3
"""Time the port's flash-attention backward kernels K5 (dq) and K6 (dk/dv)
against other builds of the same two sources, in one process on one card,
in turns (other, this, this, other), beside SDPA's backward.

    git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C <dir>
    python3 tools/flash_bwd_ab.py \
        --other parent=<dir>/deeplearning4j_tpu_torch/csrc

Each ``--other NAME=DIR`` names a directory holding a ``flash_attn_dq.cu``
and ``flash_attn_dkv.cu`` (and the headers they include); it is compiled
with the port's nvcc flags into ``--build`` under its own library names
and called through the same C entry points as this checkout's kernels,
with the same inputs: B=32, H=8, T=256, D=64, causal, f32 (the GPT training
slice's shape), and the same with padded rows (lengths 64-256). Each
version is held against the plain backward first. Prints one JSON line per
case (every round's times and their medians) and the card's name and power
limit. Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deeplearning4j_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, NVCC_FLAGS, build_libraries, find_nvcc, load_library,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    attention_bwd_plain, attention_dvec, flash_attention,
)

NAMES = ("flash_attn_dq", "flash_attn_dkv")


def build_others(others: dict, out: Path) -> dict:
    """nvcc every other version's two sources into ``out``, all at once;
    ``others`` maps a name to its source directory."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {(v, n): subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(out / f"lib{v}_{n}.so"),
         str(src / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, src in others.items() for n in NAMES}
    for (v, n), p in procs.items():
        log = p.communicate()[0]
        (out / f"lib{v}_{n}.so.log").write_text(log)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v} {n}:\n{log[-4000:]}")
    return {v: {n: ctypes.CDLL(str(out / f"lib{v}_{n}.so")) for n in NAMES}
            for v in others}


def entry(lib, name):
    fn = getattr(lib, f"dl4j_{name}")
    n_ptr = 8 if name == "flash_attn_dq" else 9
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn, iters, warmup=3) -> float:
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


def case(name, libs, padded, rounds, iters, seed=1234):
    B, H, T, D = 32, 8, 256, 64
    g = torch.Generator().manual_seed(seed)
    q, k, v, d_out = (torch.randn(B, H, T, D, generator=g).cuda()
                      for _ in range(4))
    mask = None
    if padded:
        lengths = torch.randint(64, T + 1, (B,), generator=g)
        lengths[0] = T
        mask = (torch.arange(T)[None, :] < lengths[:, None]).float().cuda()
    out, lse = flash_attention(q, k, v, causal=True, kv_mask=mask,
                               return_lse=True)
    dvec = attention_dvec(d_out, out)
    ref = attention_bwd_plain(q, k, v, d_out, lse, dvec, causal=True,
                              kv_mask=mask)
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (q, k, v)] + [
        None if mask is None else mask.data_ptr()] + [
        t.data_ptr() for t in (d_out, lse, dvec)]
    shape = [B * H, H, T, D, 1, 0, stream]
    rec = dict(case=name, shape=[B, H, T, D], causal=True, dtype="float32",
               mask="padded rows, lengths 64-256" if padded else None)
    runs = {}
    for ver, ver_libs in libs.items():
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(q), torch.empty_like(q)
        f_dq = entry(ver_libs["flash_attn_dq"], "flash_attn_dq")
        f_dkv = entry(ver_libs["flash_attn_dkv"], "flash_attn_dkv")

        def run_dq(f=f_dq, o=dq):
            assert f(*ins, o.data_ptr(), *shape) == 0

        def run_dkv(f=f_dkv, a=dk, b=dv):
            assert f(*ins, a.data_ptr(), b.data_ptr(), *shape) == 0
        run_dq()
        run_dkv()
        torch.cuda.synchronize()
        rec[f"max_rel_err_{ver}"] = max(
            float((a - r).abs().max() / r.abs().max())
            for a, r in zip((dq, dk, dv), ref))
        runs[ver] = (run_dq, run_dkv)
    times = {f"{ver}_{part}": [] for ver in libs for part in ("dq", "dkv")}
    times["sdpa_bwd"] = []
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), d_out)
    for _ in range(rounds):
        for other in (v for v in libs if v != "this"):
            for ver in (other, "this", "this", other):
                for part, fn in zip(("dq", "dkv"), runs[ver]):
                    times[f"{ver}_{part}"].append(cuda_ms(fn, iters))
        if mask is None:   # yardstick only: the port never calls SDPA
            times["sdpa_bwd"].append(cuda_ms(sdpa_fwd_bwd, iters)
                                     - cuda_ms(sdpa_fwd, iters))
    rec["ms"] = times
    rec["median_ms"] = {k: float(np.median(v)) for k, v in times.items()
                        if v}
    med = rec["median_ms"]
    rec["dq_plus_dkv_ms"] = {v: med[f"{v}_dq"] + med[f"{v}_dkv"]
                             for v in libs}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="NAME=DIR: a directory with another "
                         "flash_attn_dq.cu and flash_attn_dkv.cu")
    ap.add_argument("--build", type=Path, default=BUILD_DIR / "other",
                    help="where the other builds go")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    others = {name: Path(src) for name, _, src in
              (spec.partition("=") for spec in args.other)}
    build_libraries(list(NAMES))
    libs = {**build_others(others, args.build),
            "this": {n: load_library(n) for n in NAMES}}
    recs = [case("slice", libs, False, args.rounds, args.iters),
            case("slice_padded", libs, True, args.rounds, args.iters)]
    print(json.dumps(dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
                          summary={r["case"]: r["dq_plus_dkv_ms"]
                                   for r in recs})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
