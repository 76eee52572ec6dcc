"""Iteration/training listeners (the JAX package's
``optimize/listeners.py``).

Ref: optimize/api/{IterationListener,TrainingListener}.java (invoked from
BaseOptimizer.gradientAndScore, ref: optimize/solvers/BaseOptimizer.java:160)
and the built-ins in optimize/listeners/: ScoreIterationListener,
PerformanceListener (samples/sec, batches/sec), CollectScoresIterationListener.
The containers call ``iteration_done`` after each optimizer step (reading
``score_value`` there waits for the step), and a ``TrainingListener``'s
epoch hooks from ``fit``.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple


logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int, score: float) -> None:
        pass


class TrainingListener(IterationListener):
    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass

    def on_backward_pass(self, model) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Log score every N iterations (ref: ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            logger.info("Score at iteration %d is %s", iteration, score)


class PerformanceListener(IterationListener):
    """Throughput reporting: samples/sec, batches/sec, iteration ms
    (ref: optimize/listeners/PerformanceListener.java:24-97)."""

    def __init__(self, frequency: int = 1, report_score: bool = False):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._last_time: Optional[float] = None
        self.history: List[Tuple[int, float, float]] = []  # (iter, samples/s, batches/s)

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        # under fit(scan_window=N) the window's N steps run back to back
        # and the events fire afterwards in a burst; the container reports
        # the window wall time so throughput amortizes per step instead of
        # reading the (meaningless) burst cadence
        win = getattr(model, "last_scan_window", None)
        dt_iter = None
        if win and win.get("n"):
            dt_iter = win["wall_s"] / win["n"]
        elif self._last_time is not None:
            # _last_time advances on EVERY event, so the span is exactly
            # one iteration; frequency only gates how often we report
            dt_iter = now - self._last_time
        if dt_iter is not None and iteration % self.frequency == 0:
            batch = getattr(model, "last_batch_size", None) or 0
            sps = batch / dt_iter if dt_iter > 0 else float("inf")
            bps = 1.0 / dt_iter if dt_iter > 0 else float("inf")
            self.history.append((iteration, sps, bps))
            msg = (f"iteration {iteration}: {sps:.1f} samples/sec, "
                   f"{bps:.2f} batches/sec, {1e3 * dt_iter:.1f} ms/iter")
            if self.report_score:
                msg += f", score {score}"
            logger.info(msg)
        self._last_time = now


class CollectScoresIterationListener(IterationListener):
    """Record (iteration, score) pairs
    (ref: CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))

class ComposableIterationListener(TrainingListener):
    """Dispatch to a collection of listeners as one
    (ref: ComposableIterationListener.java). Subclasses TrainingListener
    and forwards every hook so wrapped TrainingListeners still receive
    epoch callbacks (containers isinstance-check the TOP-level listener)."""

    def __init__(self, *listeners: IterationListener):
        self.listeners: List[IterationListener] = list(listeners)

    @property
    def collects_gradients(self) -> bool:
        # containers scan top-level listeners for this flag when deciding
        # whether the train step must emit gradients — forward the union
        return any(getattr(l, "collects_gradients", False)
                   for l in self.listeners)

    def iteration_done(self, model, iteration, score):
        for l in self.listeners:
            l.iteration_done(model, iteration, score)

    def _fan(self, hook, *args):
        for l in self.listeners:
            if isinstance(l, TrainingListener):
                getattr(l, hook)(*args)

    def on_epoch_start(self, model):
        self._fan("on_epoch_start", model)

    def on_epoch_end(self, model):
        self._fan("on_epoch_end", model)

    def on_forward_pass(self, model, activations):
        self._fan("on_forward_pass", model, activations)

    def on_gradient_calculation(self, model):
        self._fan("on_gradient_calculation", model)

    def on_backward_pass(self, model):
        self._fan("on_backward_pass", model)


class ParamAndGradientIterationListener(IterationListener):
    """Per-iteration parameter/update magnitude statistics
    (ref: ParamAndGradientIterationListener.java — mean magnitudes,
    min/max, optionally written tab-separated to a file). Reads the
    container's ``last_grads`` when a gradient-collecting listener (e.g.
    StatsListener) made the train step emit them; otherwise reports
    param stats only."""

    collects_gradients = True  # ask the train step to output grads

    def __init__(self, frequency: int = 1, output_file: Optional[str] = None):
        self.frequency = max(1, frequency)
        self.output_file = output_file
        self.history: List[dict] = []
        if output_file:
            with open(output_file, "w") as f:
                f.write("iteration\tscore\tparam_mean_mag\tparam_max\t"
                        "grad_mean_mag\tgrad_max\n")

    @staticmethod
    def _stats(tree) -> Tuple[float, float]:
        from deeplearning4j_tpu_torch.nn.updater import tree_leaves
        total, count, mx = 0.0, 0, 0.0
        for x in tree_leaves(tree):
            if not (hasattr(x, "shape") and x.numel()):
                continue
            a = x.detach().abs().float()  # per-leaf running reduction:
            total += float(a.sum())       # no param-sized concatenated copy
            count += a.numel()
            mx = max(mx, float(a.max()))
        return (total / count if count else 0.0), mx

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency:
            return
        pm, px = self._stats(model.params)
        grads = getattr(model, "last_grads", None)
        gm, gx = self._stats(grads) if grads is not None else (float("nan"),) * 2
        rec = {"iteration": iteration, "score": float(score),
               "param_mean_mag": pm, "param_max": px,
               "grad_mean_mag": gm, "grad_max": gx}
        self.history.append(rec)
        if self.output_file:
            with open(self.output_file, "a") as f:
                f.write(f"{iteration}\t{score}\t{pm}\t{px}\t{gm}\t{gx}\n")
        logger.info("iter %d param |w| mean %.3e max %.3e; grad mean %.3e",
                    iteration, pm, px, gm)
