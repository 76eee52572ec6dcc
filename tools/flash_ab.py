#!/usr/bin/env python3
"""Time the port's flash-attention kernels, the forward K4 and the backward
K5 (dq) and K6 (dk/dv), against other builds of the same three sources, in
one process on one card, in turns (other, this, this, other), beside SDPA's
forward and backward.

    git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C <dir>
    python3 tools/flash_ab.py \
        --other parent=<dir>/deeplearning4j_tpu_torch/csrc

Each ``--other NAME=DIR`` names a directory holding a ``flash_attn_fwd.cu``,
``flash_attn_dq.cu`` and ``flash_attn_dkv.cu`` (and the headers they
include); each is compiled with the port's nvcc flags into ``--build``
under its own library name and called through the same C entry points as
this checkout's kernels, with the same inputs: B=32, H=8, T=256, D=64,
causal, f32 (the GPT slice's shape; ``--shape B,H,T,D`` for another),
and the same with padded rows (lengths 64-T). Each version is held against the plain forward (O 2e-5,
lse 1e-4) or the plain backward (5e-5 of each gradient's largest |g|)
first, and the run fails if one is off. Inputs, tolerances and the
timing (each kernel's device time in a profiler trace) are chip_smoke.py's.
Prints one JSON line per kernel and case (every round's times and their
medians) and the card's name and power limit. Needs a CUDA card and nvcc;
imports no JAX.
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

from chip_smoke import (  # noqa: E402
    TOL_F32, TOL_GRAD_F32, TOL_LSE, attention_d_out, attention_inputs,
    device_ms,
)
from deeplearning4j_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, NVCC_FLAGS, build_libraries, find_nvcc, load_library,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    attention_bwd_plain, attention_dvec, flash_attention,
    flash_attention_plain,
)

#: each kernel's C entry takes this many pointers before its int arguments
N_PTR = {"flash_attn_fwd": 6, "flash_attn_dq": 8, "flash_attn_dkv": 9}
NAMES = tuple(N_PTR)


def build_others(others: dict, out: Path) -> dict:
    """nvcc every other version's sources into ``out``, all at once;
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
    fn.argtypes = [ctypes.c_void_p] * N_PTR[name] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def inputs(shape, padded):
    """q, k, v, dO of ``shape`` (B, H, T, D), f32, and the padded rows' key
    mask (or None), as chip_smoke.py makes them."""
    shape = (*shape, torch.float32)
    q, k, v, mask = attention_inputs(*shape, "padded" if padded else None)
    return q, k, v, attention_d_out(*shape), mask


def in_turns(runs, rounds, iters, library=None):
    """Each part's time of every version, other, this, this, other for
    each other version, ``rounds`` times; ``library`` (name, fn) is timed
    once a round beside them."""
    times = {f"{ver}_{part}": [] for ver in runs for part in runs[ver]}
    if library is not None:
        times[library[0]] = []
    for _ in range(rounds):
        for other in (v for v in runs if v != "this"):
            for ver in (other, "this", "this", other):
                for part, fn in runs[ver].items():
                    times[f"{ver}_{part}"].append(device_ms(fn, iters))
        if library is not None:   # yardstick only: the port never calls it
            times[library[0]].append(library[1]())
    return times


def record(rec, times):
    rec["ms"] = times
    rec["median_ms"] = {k: float(np.median(v)) for k, v in times.items()
                        if v}
    print(json.dumps(rec), flush=True)
    return rec


def fwd_case(name, libs, shape, padded, rounds, iters):
    """K4 of every version against the plain forward, then in turns."""
    q, k, v, _, mask = inputs(shape, padded)
    B, H, T, D = q.shape
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True, kv_mask=mask)
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (q, k, v)] + [
        None if mask is None else mask.data_ptr()]
    dims = [B * H, H, T, D, 1, 0, stream]
    rec = dict(kernel="flash_attn_fwd", case=name, shape=[B, H, T, D],
               causal=True, dtype="float32",
               mask="padded rows, lengths 64-T" if padded else None)
    runs = {}
    for ver, ver_libs in libs.items():
        out, lse = torch.empty_like(q), torch.empty_like(ref_lse)
        fn = entry(ver_libs["flash_attn_fwd"], "flash_attn_fwd")

        def run(f=fn, o=out, s=lse):
            assert f(*ins, o.data_ptr(), s.data_ptr(), *dims) == 0
        run()
        torch.cuda.synchronize()
        err_o = float((out - ref).abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        rec[f"max_abs_err_o_{ver}"] = err_o
        rec[f"max_abs_err_lse_{ver}"] = err_lse
        if not (err_o <= TOL_F32 and err_lse <= TOL_LSE):
            raise AssertionError(f"{ver} K4 differs from the plain forward: "
                                 f"O {err_o}, lse {err_lse}")
        runs[ver] = {"fwd": run}
    library = None if mask is not None else ("sdpa_fwd", lambda: device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        iters))
    return record(rec, in_turns(runs, rounds, iters, library))


def bwd_case(name, libs, shape, padded, rounds, iters):
    """K5 and K6 of every version against the plain backward, from this
    checkout's K4 out and lse, then in turns."""
    q, k, v, d_out, mask = inputs(shape, padded)
    B, H, T, D = q.shape
    out, lse = flash_attention(q, k, v, causal=True, kv_mask=mask,
                               return_lse=True)
    dvec = attention_dvec(d_out, out)
    ref = attention_bwd_plain(q, k, v, d_out, lse, dvec, causal=True,
                              kv_mask=mask)
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (q, k, v)] + [
        None if mask is None else mask.data_ptr()] + [
        t.data_ptr() for t in (d_out, lse, dvec)]
    dims = [B * H, H, T, D, 1, 0, stream]
    rec = dict(kernel="flash_attn_dq+flash_attn_dkv", case=name,
               shape=[B, H, T, D], causal=True, dtype="float32",
               mask="padded rows, lengths 64-T" if padded else None)
    runs = {}
    for ver, ver_libs in libs.items():
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(q), torch.empty_like(q)
        f_dq = entry(ver_libs["flash_attn_dq"], "flash_attn_dq")
        f_dkv = entry(ver_libs["flash_attn_dkv"], "flash_attn_dkv")

        def run_dq(f=f_dq, o=dq):
            assert f(*ins, o.data_ptr(), *dims) == 0

        def run_dkv(f=f_dkv, a=dk, b=dv):
            assert f(*ins, a.data_ptr(), b.data_ptr(), *dims) == 0
        run_dq()
        run_dkv()
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max() / r.abs().max())
                  for a, r in zip((dq, dk, dv), ref))
        rec[f"max_rel_err_{ver}"] = err
        if not err <= TOL_GRAD_F32:
            raise AssertionError(f"{ver} K5/K6 differ from the plain "
                                 f"backward by {err} of the largest |g|")
        runs[ver] = {"dq": run_dq, "dkv": run_dkv}
    library = None
    if mask is None:
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), d_out)
        library = ("sdpa_bwd", lambda: device_ms(sdpa_fwd_bwd, iters)
                   - device_ms(sdpa_fwd, iters))
    rec = record(rec, in_turns(runs, rounds, iters, library))
    med = rec["median_ms"]
    rec["dq_plus_dkv_ms"] = {v: med[f"{v}_dq"] + med[f"{v}_dkv"]
                             for v in libs}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="NAME=DIR: a directory with another "
                         "flash_attn_fwd.cu, flash_attn_dq.cu and "
                         "flash_attn_dkv.cu")
    ap.add_argument("--build", type=Path, default=BUILD_DIR / "other",
                    help="where the other builds go")
    ap.add_argument("--shape", default="32,8,256,64",
                    help="B,H,T,D of the inputs (causal, f32)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device; nothing was run", file=sys.stderr)
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
    summary = {}
    shape = tuple(int(x) for x in args.shape.split(","))
    for padded, case in ((False, "slice"), (True, "slice_padded")):
        f = fwd_case(case, libs, shape, padded, args.rounds, args.iters)
        b = bwd_case(case, libs, shape, padded, args.rounds, args.iters)
        summary[case] = dict(
            fwd=f["median_ms"],
            dq_plus_dkv=b["dq_plus_dkv_ms"],
            sdpa_bwd=b["median_ms"].get("sdpa_bwd"))
    print(json.dumps(dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
                          summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
