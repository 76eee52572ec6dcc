"""Per-phase training telemetry (the JAX package's
``optimize/training_stats.py``).

An analog of the Spark tier's ParameterAveragingTrainingMasterStats
(ref: deeplearning4j-scaleout/spark/dl4j-spark/src/main/java/org/
deeplearning4j/spark/impl/paramavg/stats/ParameterAveragingTrainingMasterStats.java
— 456 LoC timing split/repartition/fit/aggregate/broadcast behind a
``collectTrainingStats`` flag, exportable as charts). Here the phases are the
ones an MFU hunt on a chip actually needs:

- ``data_wait``   host blocked on the iterator for the next batch —
                  the INPUT STALL: ``export()`` surfaces its total as
                  the top-level ``input_stall_s`` field (the same
                  number every bench rung record carries), so
                  input-bound vs compute-bound time is one comparison
- ``shard``       host->device placement (the batch copy to the card)
- ``step``        device step wall time (the caller synchronizes per
                  step, like the reference's fit timing: telemetry is
                  not free)
- ``listener``    TrainingListener callbacks
- ``checkpoint``  saver/serializer work recorded by whoever performs it

``ParallelTrainer(collect_training_stats=True)`` records ``shard``,
``step``, ``listener`` and ``data_wait`` itself (``parallel/trainer.py``,
synchronizing the card each step); any other training loop wraps its
iterator in ``timed_iter`` and its steps in ``phase("step")``, and reads
``export()`` afterwards.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, Optional

PHASES = ("data_wait", "shard", "step", "listener", "checkpoint")


def maybe_phase(stats: Optional["TrainingStats"], name: str):
    """``stats.phase(name)`` or a no-op context when telemetry is off —
    keeps call sites single-path instead of if/else-duplicated."""
    from contextlib import nullcontext
    return stats.phase(name) if stats is not None else nullcontext()


class TrainingStats:
    """Cumulative per-phase timings with min/max/count, plus the wall-clock
    span they were collected over."""

    def __init__(self):
        self.phases: Dict[str, dict] = {}
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._cost: Optional[dict] = None

    # ------------------------------------------------------------- recording
    def record(self, phase: str, seconds: float) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            # the span starts when the first timed phase STARTED, so the
            # very first record's own duration is inside the span
            self._t0 = now - seconds
        self._t_last = now
        p = self.phases.setdefault(
            phase, {"total_s": 0.0, "count": 0,
                    "min_s": float("inf"), "max_s": 0.0})
        p["total_s"] += seconds
        p["count"] += 1
        p["min_s"] = min(p["min_s"], seconds)
        p["max_s"] = max(p["max_s"], seconds)

    @contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t)

    def timed_iter(self, iterable, phase: str = "data_wait"):
        """Wrap an iterator so the host time blocked in ``next()`` is
        recorded — with async prefetch this should be ~0."""
        it = iter(iterable)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.record(phase, time.perf_counter() - t)
            yield item

    def set_cost(self, cost: Optional[dict]) -> None:
        """Attach a step's cost (a dict with ``flops_per_step`` and
        ``peak_flops_per_chip``). ``export()`` then reports it and, when
        the ``step`` phase has samples, derives ``analytic_mfu`` from the
        measured mean step time."""
        self._cost = cost

    # --------------------------------------------------------------- exports
    def input_stall_s(self) -> float:
        """Total host seconds blocked waiting on the iterator for the
        next batch (the ``data_wait`` phase — ``fit`` records it around
        every ``next()`` via ``timed_iter``). ~0 when the input
        pipeline keeps ahead of the step; the chip-starvation measure
        otherwise."""
        p = self.phases.get("data_wait")
        return p["total_s"] if p else 0.0

    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return self._t_last - self._t0

    def total_phase_s(self) -> float:
        return sum(p["total_s"] for p in self.phases.values())

    def export(self) -> dict:
        wall = self.wall_s()
        out = {"wall_s": wall, "phases": {}}
        for name, p in self.phases.items():
            out["phases"][name] = dict(
                p, mean_s=p["total_s"] / max(p["count"], 1),
                fraction=(p["total_s"] / wall) if wall > 0 else 0.0)
        out["covered_fraction"] = (
            self.total_phase_s() / wall if wall > 0 else 0.0)
        out["input_stall_s"] = self.input_stall_s()
        if self._cost:
            out["cost_analysis"] = dict(self._cost)
            step = self.phases.get("step")
            flops = self._cost.get("flops_per_step")
            peak = self._cost.get("peak_flops_per_chip")
            mean_s = step["total_s"] / step["count"] if step and \
                step["count"] else 0.0
            if mean_s > 0 and flops and peak and peak > 0:
                # model FLOPs utilization: achieved FLOP/s over the peak
                out["analytic_mfu"] = flops / (mean_s * peak)
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.export(), indent=indent, sort_keys=True)

    def summary(self) -> str:
        """One line per phase, largest first (the reference exports the
        same data as HTML charts; the dashboard's system tab renders
        ``export()``)."""
        wall = self.wall_s()
        lines = [f"wall {wall:.3f}s, phases cover "
                 f"{100.0 * self.total_phase_s() / wall if wall else 0:.1f}%"]
        for name, p in sorted(self.phases.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            frac = p["total_s"] / wall if wall else 0.0
            lines.append(
                f"  {name:<10} {p['total_s']:8.3f}s {100 * frac:5.1f}%  "
                f"n={p['count']:<5} mean={p['total_s'] / p['count']:.4f}s "
                f"max={p['max_s']:.4f}s")
        return "\n".join(lines)
