"""Start a shardcheck job on gloo ranks: the ``--self-check`` or the
``--contracts`` of ``analysis/shardcheck.py``, each rank a ``python -m
deeplearning4j_tpu_torch.analysis.shardcheck --rank-job`` process.

    python -m deeplearning4j_tpu_torch.analysis.ranks self-check [--device cpu]
    python -m deeplearning4j_tpu_torch.analysis.ranks contracts [--device cpu]

This module imports no torch, so the ranks start at once. The umbrella
(``analysis/analyze.py``) runs shardcheck's self-check through it: its
longest step then pays one torch import (each rank's), where ``shardcheck
--self-check`` pays two (its own, to resolve the device, then each
rank's). Every rank runs on the card (``--device cuda``, the default; a
rank without one exits 2) or on the CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spawn(job: str, device: str, world: int = 2,
          timeout: float = 900.0) -> int:
    """Run ``job`` ("self-check" or "contracts") on ``world`` gloo ranks,
    every one on ``device`` ("cuda" or "cpu"); returns the worst exit
    code. Rank 0's report goes to stdout."""
    with tempfile.TemporaryDirectory(prefix="shardcheck-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        if device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        procs = [subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis."
             "shardcheck", "--rank-job", job, str(r), str(world), init,
             device], cwd=str(ROOT), env=env,
            stdout=None if r == 0 else subprocess.DEVNULL)
            for r in range(world)]
        rcs = []
        try:
            for p in procs:
                rcs.append(p.wait(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(rcs) if len(rcs) == world else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.ranks",
        description="run shardcheck's self-check or contracts on two "
                    "gloo ranks")
    ap.add_argument("job", choices=("self-check", "contracts"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    return spawn(args.job, args.device)


if __name__ == "__main__":
    sys.exit(main())
