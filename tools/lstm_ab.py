#!/usr/bin/env python3
"""Time the port's LSTM kernels, K1 (inference) and K2 (training forward),
or K3 (the backward sweep) with ``--kernel bwd``, against other builds of
the same sources, in one process on one card, in turns (other, this,
this, other), beside cuDNN's LSTM.

    git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C <dir>
    python3 tools/lstm_ab.py [--kernel bwd] \
        --other parent=<dir>/deeplearning4j_tpu_torch/csrc

Each ``--other NAME=DIR`` names a directory holding an
``lstm_fwd_infer.cu`` and ``lstm_fwd_train.cu`` (``lstm_bwd.cu`` for
``--kernel bwd``; and the headers they include); each is compiled with
the port's nvcc flags into ``--build`` and called through its own C entry
points. ``--rows 2,8`` also times this
checkout's sources built with ``-DDL4J_LSTM_RES_ROWS=n``: the resident
body with n batch rows a cluster in place of its 4. Shapes: the
char-RNN's, K1 at T=64, B=32, H=256 and K2 at its tBPTT window T=50, f32
(``--shape T,B,H`` for K1's, with K2 at T=50); K3 at the window, T=50,
on K2's residuals of the same weights, beside cuDNN's backward
(forward + backward minus forward). Each version is held against the
plain version (K1/K2 1e-5, K3 2e-4, scaled by max(1, max |x|)) first, and
the run fails if one is off. Inputs, tolerances and the timing (each kernel's
device time in a profiler trace) are chip_smoke.py's. Prints one JSON
line per kernel (every round's times and their medians) and the card's
name and power limit.

    python3 tools/lstm_ab.py --phases

instead shows where a step of K1's resident body spends its time: it
builds ``csrc/lstm_fwd_infer.cu`` with ``-DDL4J_LSTM_PHASES`` (the phase
clock is compiled out otherwise), runs it at the char-RNN's shape (T=64
and T=1) with 4 batch rows a cluster (and each of ``--rows``), and
prints the clock64 cycles
of each phase (the product h @ rw_slice, the block barrier after it, the
gates, the DSMEM exchange with the step's stores, the cluster barrier),
summed over the steps by thread 0 of the first CTA, per step, and the
card's SM clock. With ``--kernel bwd`` it does the same for K3's resident
body (``csrc/lstm_bwd.cu``) at T=50 and T=1: the product dz @ rw^T's
rows, its two block barriers, dz and the dc carry with the step's stores,
the DSMEM exchange of the partial sums, the wait for the last step's
partials. Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (  # noqa: E402
    SEED, TOL_K2_F32, TOL_K3_F32, TOL_LSTM_F32, cudnn_training_ms,
    device_ms, lstm_inputs,
)
from deeplearning4j_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, CSRC_DIR, NVCC_FLAGS, build_libraries, find_nvcc,
    load_library,
)
from deeplearning4j_tpu_torch.ops.fused_lstm import (  # noqa: E402
    fused_lstm, launch_plan, lstm_bwd_plain, lstm_fwd_train,
    lstm_fwd_train_plain, lstm_recurrence_plain,
)
from flash_ab import in_turns, record  # noqa: E402

#: each kernel's C entry takes this many pointers before its int arguments
N_PTR = {"lstm_fwd_infer": 7, "lstm_fwd_train": 8, "lstm_bwd": 11}
#: the kernels each ``--kernel`` times
NAMES = {"fwd": ("lstm_fwd_infer", "lstm_fwd_train"), "bwd": ("lstm_bwd",)}
#: the resident bodies' step phases, in the order their phase clock sums
#: them (csrc/lstm_common.cuh PhaseClock)
PHASES = {"fwd": ("product", "block_barrier", "gates", "exchange_and_stores",
                  "cluster_barrier"),
          "bwd": ("product", "block_barriers", "dz", "exchange_and_stores",
                  "partials_wait")}


def build_others(others: dict, out: Path, names) -> dict:
    """nvcc every other version's sources of the kernels ``names`` into
    ``out``, all at once; ``others``: name -> (source directory, extra
    nvcc flags). Returns name -> {kernel: library}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {(v, n): subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, *flags, "-o",
         str(out / f"lib{v}_{n}.so"), str(src / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, (src, flags) in others.items() for n in names}
    for (v, n), p in procs.items():
        log = p.communicate()[0]
        (out / f"lib{v}_{n}.so.log").write_text(log)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v} {n}:\n{log[-4000:]}")
    return {v: {n: ctypes.CDLL(str(out / f"lib{v}_{n}.so")) for n in names}
            for v in others}


def entry(lib, name):
    """The C entry: pointers, T, B, H, the forget bias (K1, K2), dtype,
    stream."""
    fn = getattr(lib, f"dl4j_{name}")
    fb = [] if name == "lstm_bwd" else [ctypes.c_float]
    fn.argtypes = ([ctypes.c_void_p] * N_PTR[name] + [ctypes.c_int] * 3
                   + fb + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rows_flags(r: int) -> list:
    return [f"-DDL4J_LSTM_RES_ROWS={r}"]


def case(name, vers, T, B, H, rounds, iters):
    """K1 (``lstm_fwd_infer``) or K2 of every version against its plain
    version, then in turns, beside cuDNN (no peepholes, so none here;
    input GEMM included on its side, so the record also times this
    checkout's kernel with it)."""
    (xz, rw, pw, h0, c0), src = lstm_inputs(T, B, H, torch.float32, False,
                                            False, library=True)
    fb = 1.0
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (xz, rw, pw, h0, c0)]
    if name == "lstm_fwd_infer":
        hs_r, _, c_r = lstm_recurrence_plain(xz, rw, pw, h0, c0,
                                             forget_bias=fb)
        refs, tol = (hs_r, c_r), TOL_LSTM_F32
    else:
        refs, tol = lstm_fwd_train_plain(xz, rw, pw, h0, c0,
                                         forget_bias=fb), TOL_K2_F32
    rec = dict(kernel=name, shape=dict(T=T, B=B, H=H), dtype="float32",
               plan=launch_plan(name, B, H, torch.float32))
    runs = {}
    for ver, ver_libs in vers.items():
        fn = entry(ver_libs[name], name)
        outs = [torch.empty_like(r) for r in refs]

        def run(f=fn, o=outs):
            assert f(*ins, *[t.data_ptr() for t in o], T, B, H, fb, 0,
                     stream) == 0
        run()
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
                  for a, r in zip(outs, refs))
        rec[f"max_scaled_err_{ver}"] = err
        if not err <= tol:
            raise AssertionError(f"{ver} {name} differs from its plain "
                                 f"version by {err}")
        runs[ver] = {"kernel": run}
    # yardstick only (the port never calls cuDNN): gate order i, f, g, o
    # as in the port; the forget bias folds into cuDNN's input bias. In
    # training (K2) the weights require grad on both sides
    train = name == "lstm_fwd_train"
    x, w, b = src
    lstm = torch.nn.LSTM(x.shape[-1], H, batch_first=True).cuda()
    lstm.train(train)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w.t())
        lstm.weight_hh_l0.copy_(rw.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_ih_l0[H:2 * H] += fb
        lstm.bias_hh_l0.zero_()
    ws = [a.clone().requires_grad_(train) for a in (w, rw, b)]

    def cudnn():
        with torch.set_grad_enabled(train):
            return lstm(x, (h0[None], c0[None]))

    def ours_with_gemm():
        with torch.set_grad_enabled(train):
            return fused_lstm(x, *ws, None, h0, c0, forget_bias=fb)
    rec["this_kernel_plus_input_gemm_ms"] = device_ms(ours_with_gemm, iters)
    library = ("cudnn_lstm_with_input_gemm", lambda: device_ms(cudnn, iters))
    return record(rec, in_turns(runs, rounds, iters, library))


def bwd_case(vers, T, B, H, rounds, iters):
    """K3 of every version against its plain version on K2's residuals
    (this checkout's K2; peepholes, zero seeds as on the training path),
    then in turns, beside cuDNN's backward (no peepholes; its input and
    weight gradients), which the record also holds against this
    checkout's K3 with the dRW and dW GEMMs."""
    name = "lstm_bwd"
    (xz, rw, pw, h0, c0), _ = lstm_inputs(T, B, H, torch.float32, True,
                                          False)
    _, gates, cs = lstm_fwd_train(xz, rw, pw, h0, c0, forget_bias=1.0)
    g = torch.Generator().manual_seed(SEED + 7 * T + B + H)
    eps = torch.randn(T, B, H, generator=g).cuda()
    dh_T, dc_T = torch.zeros(B, H, device="cuda"), torch.zeros(
        B, H, device="cuda")
    rwT = rw.t().contiguous()
    refs = lstm_bwd_plain(eps, gates, cs, torch.cat([c0[None], cs[:-1]]),
                          rw, pw, dh_T, dc_T)
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (eps, gates, cs, c0, rwT, pw, dh_T, dc_T)]
    rec = dict(kernel=name, shape=dict(T=T, B=B, H=H), dtype="float32",
               plan=launch_plan(name, B, H, torch.float32))
    runs = {}
    for ver, ver_libs in vers.items():
        fn = entry(ver_libs[name], name)
        outs = [torch.empty_like(r) for r in refs]

        def run(f=fn, o=outs):
            assert f(*ins, *[t.data_ptr() for t in o], T, B, H, 0,
                     stream) == 0
        run()
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
                  for a, r in zip(outs, refs))
        rec[f"max_scaled_err_{ver}"] = err
        if not err <= TOL_K3_F32:
            raise AssertionError(f"{ver} {name} differs from its plain "
                                 f"version by {err}")
        runs[ver] = {"kernel": run}
    rec.update(cudnn_training_ms(B, T, H, g, h0, c0, rw, pw, 1.0))
    library = ("cudnn_lstm_backward", lambda: cudnn_training_ms(
        B, T, H, g, h0, c0, rw, pw, 1.0)["library_ms_bwd"])
    return record(rec, in_turns(runs, rounds, iters, library))


def phases(out: Path, rows_list, kernel: str) -> None:
    """K1 (``kernel="fwd"``) or K3 (``"bwd"``) built with its phase
    clock: cycles per step of each phase, at the char-RNN's shape, with
    each of ``rows_list`` batch rows a cluster, T = 64 (K3: 50) and 1."""
    name = "lstm_fwd_infer" if kernel == "fwd" else "lstm_bwd"
    libs = build_others({f"phases_rows{r}": (
        CSRC_DIR, ["-DDL4J_LSTM_PHASES", *rows_flags(r)])
        for r in rows_list}, out, (name,))
    stream = torch.cuda.current_stream().cuda_stream
    B, H = 32, 256
    for rows in rows_list:
        lib = libs[f"phases_rows{rows}"][name]
        fn = entry(lib, name)
        read = lib.dl4j_lstm_phases_read
        for T in ((64, 1) if kernel == "fwd" else (50, 1)):
            (xz, rw, pw, h0, c0), _ = lstm_inputs(T, B, H, torch.float32,
                                                  True, False)
            if kernel == "fwd":
                outs = [torch.empty(T, B, H, device="cuda"),
                        torch.empty(B, H, device="cuda")]
                ptrs = [t.data_ptr() for t in (xz, rw, pw, h0, c0, *outs)]
                extra = [1.0]
            else:
                _, gates, cs = lstm_fwd_train(xz, rw, pw, h0, c0)
                eps = torch.randn(T, B, H, device="cuda")
                seeds = [torch.zeros_like(h0), torch.zeros_like(c0)]
                rwT = rw.t().contiguous()
                outs = [torch.empty_like(gates), torch.empty_like(h0),
                        torch.empty_like(c0)]
                ptrs = [t.data_ptr() for t in (eps, gates, cs, c0, rwT, pw,
                                               *seeds, *outs)]
                extra = []
            for _ in range(3):   # the last launch's counts are read
                assert fn(*ptrs, T, B, H, *extra, 0, stream) == 0
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 6)()
            assert read(buf) == 0
            print(json.dumps(dict(
                kernel=name, shape=dict(T=T, B=B, H=H),
                rows_per_cluster=rows,
                cycles_per_step={p: buf[i] / buf[5]
                                 for i, p in enumerate(PHASES[kernel])})),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd",
                    help="fwd: K1 and K2; bwd: K3")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: a directory with another "
                         "lstm_fwd_infer.cu and lstm_fwd_train.cu "
                         "(lstm_bwd.cu for --kernel bwd)")
    ap.add_argument("--rows", default="",
                    help="comma-separated batch rows a cluster of the "
                         "resident body to build this checkout with and "
                         "time too (its own is 4)")
    ap.add_argument("--build", type=Path, default=BUILD_DIR / "other_lstm",
                    help="where the other builds go")
    ap.add_argument("--shape", default="64,32,256",
                    help="T,B,H of K1's inputs (f32); K2 and K3 run "
                         "T=50")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--phases", action="store_true",
                    help="time the resident body's step phases instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lstm_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = [int(r) for r in args.rows.split(",") if r]
    if args.phases:
        phases(args.build.parent / "phases", [4, *rows], args.kernel)
        return 0
    others = {name: (Path(src), []) for name, _, src in
              (spec.partition("=") for spec in args.other)}
    others.update({f"this_rows{r}": (CSRC_DIR, rows_flags(r))
                   for r in rows})
    names = NAMES[args.kernel]
    build_libraries(["lstm_fwd_train", *names])
    vers = {**build_others(others, args.build, names),
            "this": {n: load_library(n) for n in names}}
    T, B, H = (int(v) for v in args.shape.split(","))
    summary = {}
    if args.kernel == "bwd":
        rec = bwd_case(vers, 50, B, H, args.rounds, args.iters)
        summary["lstm_bwd"] = dict(
            rec["median_ms"], shape=rec["shape"], plan=rec["plan"],
            this_kernel_plus_weight_grad_gemms_ms=rec[
                "kernel_plus_weight_grad_gemms_ms"])
    for name, t in (() if args.kernel == "bwd" else
                    (("lstm_fwd_infer", T), ("lstm_fwd_train", 50))):
        rec = case(name, vers, t, B, H, args.rounds, args.iters)
        summary[name] = dict(rec["median_ms"], shape=rec["shape"],
                             plan=rec["plan"],
                             this_kernel_plus_input_gemm_ms=rec[
                                 "this_kernel_plus_input_gemm_ms"])
    print(json.dumps(dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
                          summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
