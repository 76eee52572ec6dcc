"""What the two containers share in training (the JAX package's
``nn/netcommon.py`` and the training-step helpers of its containers): the
lazily read score, the gradient of a loss over a params container (under
the precision policy), remat of one layer call, the refusal of the
training settings whose paths are not ported (layerwise pretraining), the
flat parameter vector both containers read and write in place, the
listeners, the divergence sentinel's guarded update, ``fit(scan_window >
1)`` and the evaluation loops."""

from __future__ import annotations

import contextlib
import hashlib
import struct
import time
from typing import Any, Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn.conf.builder import TrainingConfig
from deeplearning4j_tpu_torch.nn.updater import (
    PrecisionPolicy, Updater, cast_floats, compute_updates,
    precision_value_and_grad, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

#: optimization_algo names the per-batch SGD-family step takes; every
#: other one goes through the line-search solvers
SGD_ALGOS = ("sgd", "stochastic_gradient_descent")


def check_trainable(training: TrainingConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, on a training
    setting whose path is not ported: layerwise pretraining. (The JAX
    package reads ``iterations`` and ``max_num_line_search_iterations``
    in its solvers only, and ``minibatch`` nowhere outside its builder;
    the port does the same.)"""
    if training.pretrain or not training.backprop:
        raise NotImplementedError(
            f"pretrain={training.pretrain}, backprop={training.backprop}: "
            "layerwise pretraining is not ported yet (ROADMAP A7)")


def flat_params(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """``tensors`` raveled and joined into one float32 host vector (bf16
    comes back as float32), copied off the device once."""
    if not tensors:
        return np.zeros(0, np.float32)
    return torch.cat([t.detach().reshape(-1).float()
                      for t in tensors]).cpu().numpy()


@torch.no_grad()
def set_flat_params(tensors: List[torch.Tensor], flat) -> None:
    """Write ``flat`` into ``tensors`` in order, **in place**: each tensor
    keeps its storage (and its address, so a CUDA graph that reads it
    stays valid) and its dtype. The length is checked before anything is
    written, so a wrong one leaves every tensor as it was."""
    total = sum(t.numel() for t in tensors)
    if len(flat) != total:
        raise ValueError(f"Expected {total} params, got {len(flat)}")
    if not tensors:
        return
    src = torch.as_tensor(np.asarray(flat)).to(tensors[0].device)
    pos = 0
    for t in tensors:
        n = t.numel()
        t.copy_(src[pos:pos + n].view(t.shape))
        pos += n


def value_and_grad(loss_fn: Callable, params) -> Tuple[torch.Tensor, Any,
                                                        Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a params
    container (a dict or list of dicts of tensors): ``loss_fn(leaves)``
    returns ``(loss, aux)``, where ``leaves`` are detached copies of the
    params' tensors that require grad. Returns ``(loss detached, aux,
    grads mirroring params)``; an unused param's gradient is zeros."""
    order = []

    def leaf(t):
        order.append(t.detach().requires_grad_())
        return order[-1]

    leaves = tree_map(leaf, params)
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        flat = iter(torch.autograd.grad(loss, order, allow_unused=True))
    grads = tree_map(lambda t: (lambda g: torch.zeros_like(t) if g is None
                                else g)(next(flat)), leaves)
    return loss.detach(), aux, grads


def policy_value_and_grad(loss_fn: Callable, params,
                          training: TrainingConfig):
    """``value_and_grad`` under ``training``'s precision policy
    (``nn/updater.precision_value_and_grad``): the fp32 preset is the
    plain call."""
    return precision_value_and_grad(loss_fn, params,
                                    PrecisionPolicy.of(training),
                                    value_and_grad)


def cast_batch(training: TrainingConfig, batch):
    """A step's (features, labels, feature masks, label masks) with the
    features and feature masks (tensors or name -> tensor dicts) cast to
    the compute dtype under a mixed precision policy: the step boundary's
    cast seam. As it is under fp32."""
    policy = PrecisionPolicy.of(training)
    if not policy.mixed:
        return batch
    features, labels, fmask, lmask = batch
    return (cast_floats(features, policy.compute_dtype), labels,
            cast_floats(fmask, policy.compute_dtype), lmask)


def compute_dtype(training: TrainingConfig, dtype: torch.dtype
                  ) -> torch.dtype:
    """The dtype a training step computes in: the policy's compute dtype
    under a mixed policy, else the net's own ``dtype``."""
    policy = PrecisionPolicy.of(training)
    return getattr(torch, policy.compute_dtype) if policy.mixed else dtype


def remat_call(fn: Callable, rng, *args):
    """``fn(rng, *args)`` under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint``): its activations are not kept but
    recomputed in the backward. ``checkpoint`` restores only the global
    RNG states, and the port draws dropout from the net's own generator,
    so the recompute would draw new masks: instead ``fn`` gets a private
    generator set to ``rng``'s state at the call, in the forward and again
    in the recompute, and ``rng`` is then moved to where that generator
    ended, as if ``fn`` had drawn from it. Outside a gradient (no grad
    mode) ``fn`` runs as it is."""
    if not torch.is_grad_enabled():
        return fn(rng, *args)
    if rng is None:
        return checkpoint(fn, None, *args, use_reentrant=False,
                          preserve_rng_state=False)
    start = rng.get_state()
    end = []

    def replay(*a):
        gen = torch.Generator(device=rng.device)
        gen.set_state(start)
        out = fn(gen, *a)
        if not end:
            end.append(gen.get_state())
        return out

    out = checkpoint(replay, *args, use_reentrant=False,
                     preserve_rng_state=False)
    rng.set_state(end[0])
    return out


def stream_seed(net, index: int, step: int) -> int:
    """A 63-bit seed derived from the net's dropout stream (its
    generator's state), a stream index (a rank, or a global worker) and a
    step: the data-parallel trainers' per-rank streams. Every rank can
    compute every other rank's, so the checkpoint cursor records them."""
    h = hashlib.blake2b(net._rng.get_state().numpy().tobytes(),
                        digest_size=8)
    h.update(struct.pack("<qq", int(index), int(step)))
    return int.from_bytes(h.digest(), "little") >> 1


@contextlib.contextmanager
def derived_stream(net, index: int, gen: torch.Generator) -> Iterator:
    """Within the block the net draws its dropout masks from ``gen``,
    seeded with ``stream_seed(net, index, net.iteration_count)``; the
    net's own generator is left as it was."""
    gen.manual_seed(stream_seed(net, index, net.iteration_count))
    own, net._rng = net._rng, gen
    try:
        yield
    finally:
        net._rng = own


@contextlib.contextmanager
def global_batch_stats(net, sum_over_ranks: Callable) -> Iterator:
    """Within the block a training batch norm of ``net`` normalizes by the
    mean and variance of the global batch: the net's containers hand each
    one ``sum_over_ranks`` (differentiable), through which it sums its
    rows' per-channel sum, sum of squares and count. The data-parallel
    trainer's is a ``parallel.mesh.GlobalBatch``, whose token methods an
    ``MoELayer`` takes its capacity, positions and balancing loss over
    (every layer with ``takes_batch_sum`` gets it). The sum is the net's
    own: a net built afresh never inherits it, even while a thread
    abandoned inside this block (an elastic step stuck on a dead peer)
    never leaves it."""
    saved, net._batch_sum = net._batch_sum, sum_over_ranks
    try:
        yield
    finally:
        net._batch_sum = saved


def batch_sum_kwargs(batch_sum: Callable) -> Callable:
    """``layer -> {"batch_sum": batch_sum}`` for a layer that takes it
    (``{}`` for the rest, and for every layer without a sum). A
    container's forward binds the net's sum once, so remat's recompute
    inside the backward hands the layer the same one."""
    def kwargs(layer) -> dict:
        return ({"batch_sum": batch_sum}
                if batch_sum is not None and layer.takes_batch_sum else {})
    return kwargs


def detach(tree):
    """A container of tensors (None leaves kept) cut from autograd."""
    return tree_map(lambda t: None if t is None else t.detach(), tree)


class NetCommonMixin:
    """``score_value`` (the last minibatch loss as a float; a device value
    is read, and the device synchronized, on first access only), the
    listeners (``set_listeners`` / ``add_listener``; a listener with
    ``collects_gradients`` makes each step keep its gradients in
    ``last_grads``), the divergence sentinel (``set_divergence_sentinel``:
    every step from then on is guarded) and the guarded update."""

    _sentinel = None
    _collect_grads = False
    #: the sum over the ranks a training batch norm takes its statistics
    #: through (``global_batch_stats``); None: this rank's rows alone
    _batch_sum = None
    last_grads = None
    last_input = None
    last_scan_window = None

    _score_raw: Any = float("nan")

    @property
    def score_value(self) -> float:
        if not isinstance(self._score_raw, float):
            self._score_raw = float(self._score_raw)
        return self._score_raw

    @score_value.setter
    def score_value(self, v) -> None:
        self._score_raw = v

    # ------------------------------------------------------------ listeners
    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)
        self._on_listeners_changed()

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)
        self._on_listeners_changed()

    def _on_listeners_changed(self) -> None:
        # a gradient-collecting listener (ParamAndGradientIteration-
        # Listener) needs each step's gradients kept; no one else pays
        # for a param-sized set of tensors held between steps
        self._collect_grads = any(getattr(l, "collects_gradients", False)
                                  for l in self.listeners)

    def _notify_iteration(self) -> None:
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count,
                                    self.score_value)

    def _notify_epoch(self, hook: str) -> None:
        for listener in self.listeners:
            if isinstance(listener, TrainingListener):
                getattr(listener, hook)(self)

    # ------------------------------------------------------------- sentinel
    def set_divergence_sentinel(self, sentinel):
        """Attach (or, with None, detach) a ``DivergenceSentinel``. A
        guarded step keeps the optimizer's count on the device (see
        ``nn/updater``); detaching reads it back once."""
        self._sentinel = sentinel
        if sentinel is None and self.opt_state is not None:
            Updater.host_count(self.opt_state)
        return self

    def _observe_sentinel(self, flag) -> None:
        """Hand the just-completed step's flag to the sentinel (which may
        raise per its policy)."""
        if self._sentinel is not None and flag is not None:
            self._sentinel.observe(flag, self.iteration_count)

    def _update(self, grads, loss, layers) -> Any:
        """Apply one update to the params and the optimizer state in
        place. Under a sentinel the update is guarded: the count lives on
        the device, and where the loss or the gradients are non-finite
        the params, the moments and the count are written back as they
        were (``resilience/sentinel.guarded_in_place``). Returns the
        step's bad flag (a device bool), or None without a sentinel."""
        training = self.conf.training
        if self._sentinel is None:
            compute_updates(self._tx, grads, self.opt_state, self.params,
                            layers, training)
            return None
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            guarded_in_place, nonfinite_flag,
        )
        Updater.device_count(self.opt_state, self.device)
        bad = nonfinite_flag(loss, grads)
        written = tree_leaves(self.params) + [
            self.opt_state["count"]] + [
            t for k, v in self.opt_state.items() if k != "count"
            for t in tree_leaves(v)]
        guarded_in_place(bad, written, lambda: compute_updates(
            self._tx, grads, self.opt_state, self.params, layers, training))
        return bad

    def _guard_tree(self, bad, old, new):
        """``new`` (detached), or ``old`` where the guarded step's ``bad``
        flag is set: the layer states and the tBPTT carries a bad step
        must leave as they were."""
        new = detach(new)
        if bad is None:
            return new
        from deeplearning4j_tpu_torch.resilience.sentinel import _select
        return _select(bad, old, new)


# ---------------------------------------------------------------------------
# scan windows
# ---------------------------------------------------------------------------

def emit_scan_burst(net, losses, n, t0, stats=None):
    """The post-window listener burst: one iteration event per step of the
    window, with that step's loss. The window's losses are read from the
    card once, here. ``net.last_scan_window`` carries {n, wall_s} for the
    burst, so time-based listeners (PerformanceListener) amortize the
    window's wall time per step; try/finally keeps a raising listener
    from leaving it behind."""
    host = losses.detach().float().cpu().numpy()
    net.last_scan_window = {"n": n, "wall_s": time.perf_counter() - t0}
    t_l = time.perf_counter()
    try:
        for i in range(n):
            net.iteration_count += 1
            # listeners reading model.score_value must see THIS
            # iteration's loss, not the window's last one
            net.score_value = float(host[i])
            for listener in net.listeners:
                listener.iteration_done(net, net.iteration_count,
                                        net.score_value)
    finally:
        net.last_scan_window = None
    if stats:
        stats.record("listener", time.perf_counter() - t_l)


class ScanFitMixin:
    """``fit_batches_scan(datasets)`` and ``fit(scan_window=N)`` for both
    containers. The JAX package runs a window as one ``lax.scan`` program;
    the port runs the window's per-batch steps back to back (the same
    steps ``fit_batch`` runs, so the window is bitwise that many
    ``fit_batch`` calls), keeps their losses on the card and reads them
    once, in the listener burst after the window."""

    def _fit_epoch_scan(self, it, scan_window: int) -> None:
        """One epoch's batches grouped into windows; the short tail (and
        any window ``fit_batches_scan`` cannot take) trains per batch."""
        window: list = []
        for batch in it:
            window.append(batch)
            if len(window) == scan_window:
                self.fit_batches_scan(window)
                window = []
        for batch in window:
            self.fit_batch(batch)

    def fit_batches_scan(self, datasets):
        """One optimization step per DataSet as one window. Requirements:
        an SGD-family optimizer, standard backprop, uniform batch shapes,
        no masks, no gradient-collecting listener, no sentinel; anything
        else falls back to the per-batch ``fit_batch`` loop (whose losses
        come back as a host array). Returns the per-step losses, on the
        card for a window."""
        self._check_init()
        datasets = list(datasets)
        if not datasets:
            return np.zeros((0,), np.float32)

        def has_mask(d):
            # DataSet: singular attrs; MultiDataSet: plural lists
            for attr in ("features_mask", "labels_mask",
                         "features_masks", "labels_masks"):
                m = getattr(d, attr, None)
                if isinstance(m, (list, tuple)):
                    if any(x is not None for x in m):
                        return True
                elif m is not None:
                    return True
            return False

        def shape_sig(d):
            f, l = d.features, d.labels
            if isinstance(f, (list, tuple)):  # MultiDataSet
                return (tuple(tuple(x.shape) for x in f),
                        tuple(tuple(y.shape) for y in l))
            return (tuple(f.shape), tuple(l.shape))

        training = self.conf.training
        scannable = (
            training.optimization_algo in SGD_ALGOS
            and training.backprop_type != "truncated_bptt"
            and not self._collect_grads
            # a divergence sentinel needs each step's flag observed (its
            # raise / rollback policies act per step)
            and self._sentinel is None
            and not any(has_mask(d) for d in datasets)
            # a ragged batch (a dataset's short tail) cannot share the
            # window: loop it
            and len({shape_sig(d) for d in datasets}) == 1)
        if not scannable:
            return np.asarray([float(self.fit_batch(d))
                               for d in datasets], np.float32)
        t0 = time.perf_counter()
        losses = torch.stack([self._train_batch(d)[0] for d in datasets])
        self.last_batch_size = datasets[-1].num_examples()
        self.last_grads = None
        self.last_input = datasets[-1].features
        if self.listeners:
            emit_scan_burst(self, losses, len(datasets), t0)
        else:
            self.iteration_count += len(datasets)
        self.score_value = losses[-1]
        return losses


class CostAnalysisMixin:
    """``cost_analysis(batch)`` for both containers: FLOPs and bytes
    accessed of one training step on ``batch``, counted over a real
    forward and backward on the net's device (the kernels by their
    formulas), with the device's peak for an analytic MFU
    (``profiling/cost.train_step_cost``). Leaves the net as it was; call
    it once a batch shape, not a step."""

    def cost_analysis(self, batch, peak=None) -> dict:
        from deeplearning4j_tpu_torch.profiling.cost import train_step_cost
        return train_step_cost(self, batch, peak=peak)


class EvalMixin:
    """The evaluation loops of both containers (ref:
    MultiLayerNetwork.evaluate / evaluateROC:2436 /
    evaluateROCMultiClass:2449 / evaluateRegression): ``output()`` of each
    batch (with its feature mask, so padded steps do not run as data)
    into one evaluator, with the label mask; one drive loop for all
    four."""

    def _drive_eval(self, evaluator, iterator):
        iterator.reset()
        for batch in iterator:
            out = self.output(batch.features, mask=batch.features_mask)
            evaluator.eval(batch.labels, out.float().cpu().numpy(),
                           mask=batch.labels_mask)
        return evaluator

    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._drive_eval(Evaluation(), iterator)

    def evaluate_roc(self, iterator, threshold_steps: int = 100):
        from deeplearning4j_tpu_torch.eval.roc import ROC
        return self._drive_eval(ROC(threshold_steps), iterator)

    def evaluate_roc_multi_class(self, iterator,
                                 threshold_steps: int = 100):
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
        return self._drive_eval(ROCMultiClass(threshold_steps), iterator)

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation,
        )
        return self._drive_eval(RegressionEvaluation(), iterator)
