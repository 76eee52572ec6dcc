"""analyze: the umbrella command over the port's analysis layers (the JAX
package's ``tools/analyze.py``).

    python -m deeplearning4j_tpu_torch.analysis.analyze [paths]
    python -m deeplearning4j_tpu_torch.analysis.analyze --layer lockcheck
    python -m deeplearning4j_tpu_torch.analysis.analyze --json
    python -m deeplearning4j_tpu_torch.analysis.analyze --list-layers
    python -m deeplearning4j_tpu_torch.analysis.analyze --device cpu

The layers, by what they look at:

    graphcheck  model CONFIGS       (before a build)  self-check
    torchlint   SOURCE, captured    (AST)             sweep + self-check
    lockcheck   SOURCE, threaded    (AST)             sweep + self-check
    shardcheck  RECORDED steps      (one real step)   self-check
    postmortem  DIAGNOSTIC BUNDLES  (the watchdog's)  self-check

Each step runs its layer's own command line (``python -m
deeplearning4j_tpu_torch.<module>``) in a subprocess, so a crash in one
layer cannot take the others down; the steps run side by side and are
reported in the order above. The sweeps lint ``paths`` (default: the
port's package). shardcheck's self-check starts two gloo ranks on the card
(``python -m deeplearning4j_tpu_torch.analysis.ranks self-check``) unless
``--device cpu`` asks for the CPU; the other layers need no device.

Exit codes (the JAX package's lattice):
    0  every selected layer clean
    1  findings survived suppression in at least one sweep
    2  a self-check failed or a layer crashed: nothing the analyzer said
       this run can be trusted, which outranks findings

``--json`` prints one report object (each step with its exit code, its
output and its seconds).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = str(Path(__file__).resolve().parents[1])
ROOT = str(Path(PKG).parent)
_A = "deeplearning4j_tpu_torch.analysis."

# layer -> [(step, argv after "python -m" from the sweep paths and the
# device)]; a sweep exits 1 on findings (-> 1), a self-check nonzero only
# when the analyzer itself is broken (-> 2)
LAYERS = {
    "graphcheck": [
        ("self-check", lambda paths, device: [_A + "graphcheck",
                                              "--self-check"]),
    ],
    "torchlint": [
        ("sweep", lambda paths, device: [_A + "torchlint"] + paths),
        ("self-check", lambda paths, device: [_A + "torchlint",
                                              "--self-check"]),
    ],
    "lockcheck": [
        ("sweep", lambda paths, device: [_A + "lockcheck"] + paths),
        ("self-check", lambda paths, device: [_A + "lockcheck",
                                              "--self-check"]),
    ],
    # the ranks of shardcheck's self-check, started by a launcher that
    # imports no torch (analysis/ranks.py)
    "shardcheck": [
        ("self-check", lambda paths, device: [_A + "ranks", "self-check"]
         + (["--device", device] if device else [])),
    ],
    # not a source sweep: a synthetic diagnostic bundle round-tripped
    # through assemble -> atomic write -> load -> summarize, so a broken
    # post-mortem pipeline fails here before a real stall needs it
    "postmortem": [
        ("self-check", lambda paths, device: [
            "deeplearning4j_tpu_torch.profiling.postmortem",
            "--self-check"]),
    ],
}


def _env() -> dict:
    """This process's environment with the checkout on ``PYTHONPATH``."""
    parts = [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(parts))
    return env


def run_step(layer: str, step: str, argv: list) -> dict:
    """One step in a subprocess; its record."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + argv, cwd=ROOT,
                          env=_env(), capture_output=True, text=True)
    return {"layer": layer, "step": step, "rc": proc.returncode,
            "output": (proc.stdout + proc.stderr).rstrip(),
            "seconds": time.perf_counter() - t0}


def run_layers(layers, paths, device=None) -> tuple:
    """Every step of ``layers``, side by side; (unified exit code, the
    step records in layer order)."""
    steps = [(layer, step, build(paths, device))
             for layer in layers for step, build in LAYERS[layer]]
    with ThreadPoolExecutor(max_workers=len(steps)) as pool:
        records = list(pool.map(lambda s: run_step(*s), steps))
    rc = 0
    for r in records:
        if r["rc"] != 0:
            # a broken self-check outranks findings everywhere
            rc = max(rc, 2 if r["step"] == "self-check" else 1)
    return rc, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.analyze",
        description="The port's analysis layers in one command.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files / directories for the source sweeps "
                         "(default: the port's package)")
    ap.add_argument("--layer", action="append", choices=sorted(LAYERS),
                    help="run only this layer (repeatable; default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print one JSON report object instead of text")
    ap.add_argument("--list-layers", action="store_true",
                    help="print the layer table and exit")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where shardcheck's self-check runs (default: "
                         "the card)")
    args = ap.parse_args(argv)

    if args.list_layers:
        for layer, steps in LAYERS.items():
            print(f"{layer:<12} {', '.join(step for step, _ in steps)}")
        return 0
    layers = [l for l in LAYERS if l in (args.layer or LAYERS)]
    paths = args.paths or [PKG]
    t0 = time.perf_counter()
    rc, records = run_layers(layers, paths, args.device)
    verdict = {0: "clean", 1: "findings", 2: "self-check-failure"}[rc]
    if args.as_json:
        print(json.dumps({"verdict": verdict, "exit_code": rc,
                          "layers": layers, "steps": records,
                          "seconds": time.perf_counter() - t0}, indent=2))
    else:
        for r in records:
            print(f"-- {r['layer']} {r['step']} --")
            if r["output"]:
                print(r["output"])
        print(f"analyze: {verdict}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
