"""FaultTolerantTrainer: a resumable fit with retry, rollback and a cursor
(the JAX package's ``resilience/trainer.py``).

It wraps a fittable (a ``MultiLayerNetwork`` / ``ComputationGraph``, or a
parallel trainer driving one: ``ParallelTrainer``, ``ParallelWrapper``,
``DelayedSyncTrainer``) and supervises the batch loop:

- **Resume**: ``fit`` asks the CheckpointManager for the latest valid
  checkpoint, restores params, updater and layer states, and continues
  from the cursor's epoch, batch position and generator state.
- **Retry**: transient failures (``FaultInjected``, connection drops,
  timeouts) raised before the step dispatches are retried in place with
  bounded exponential backoff and jitter.
- **Rollback**: when the attached ``DivergenceSentinel`` (policy
  ``rollback``) trips, the last valid checkpoint is reloaded, the
  remaining data order re-randomized and training resumes; after
  ``max_consecutive_rollbacks`` with no checkpoint in between it escalates
  to ``DivergenceError``.
- **Checkpointing**: every ``checkpoint_every`` steps and at each epoch's
  end, through the manager (which rotates old ones).

On a data-parallel group every rank runs its own FaultTolerantTrainer
over the same batches and a sharded manager on one shared directory.
Retries, rollbacks and saves land in the metrics registry
(``resilience_retries_total``, ``resilience_rollbacks_total``, ...) and
as tracer spans.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.atomic import CheckpointError
from deeplearning4j_tpu_torch.resilience.faultinject import FaultInjected
from deeplearning4j_tpu_torch.resilience.manager import (
    CheckpointManager, TrainingCursor,
)
from deeplearning4j_tpu_torch.resilience.sentinel import (
    DivergenceError, DivergenceSentinel, RollbackRequested,
)

logger = logging.getLogger(__name__)

#: exception types treated as transient (retried with backoff). A
#: simulated process death (KilledByFault) is not one of them.
TRANSIENT_ERRORS = (FaultInjected, ConnectionError, TimeoutError)


class FaultTolerantTrainer:
    def __init__(self, net, manager: CheckpointManager, trainer=None,
                 sentinel: Optional[DivergenceSentinel] = None,
                 checkpoint_every: int = 0, max_retries: int = 3,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 max_consecutive_rollbacks: int = 3, seed: int = 0,
                 resume: bool = True):
        self.net = net
        self.manager = manager
        self.target = trainer if trainer is not None else net
        if not hasattr(self.target, "fit_batch"):
            raise TypeError(
                f"{type(self.target).__name__} has no fit_batch(); "
                "FaultTolerantTrainer drives the per-batch seam — wrap "
                "a container or a trainer exposing fit_batch")
        self.sentinel = sentinel
        if sentinel is not None:
            net.set_divergence_sentinel(sentinel)
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.max_retries = max(0, int(max_retries))
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.max_consecutive_rollbacks = max(1, int(
            max_consecutive_rollbacks))
        self.seed = seed
        self.resume = resume
        self._salt = 0   # bumped per rollback: re-randomizes data order
        self._consecutive_rollbacks = 0
        self._jrng = np.random.default_rng(seed ^ 0x5EED)
        reg = get_registry()
        self._c_retries = reg.counter(
            "resilience_retries_total",
            help="transient-failure retries by FaultTolerantTrainer")
        self._c_rollbacks = reg.counter(
            "resilience_rollbacks_total",
            help="checkpoint rollbacks after divergence")

    # ------------------------------------------------------------------- data
    @staticmethod
    def _materialize(data) -> List:
        """Batches as a list: cursor positions index into it and a
        rollback can reshuffle it. An iterator is drained once."""
        from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
        if isinstance(data, DataSetIterator):
            data.reset()
            return [b for b in data]
        if isinstance(data, (list, tuple)):
            return list(data)
        return [data]

    def _reshuffle_tail(self, order: List[int], pos: int,
                        epoch: int) -> List[int]:
        """Re-randomize the remaining data order after a rollback; the
        consumed prefix ``order[:pos]`` stays (cursor positions index
        into it)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) ^ (self._salt * 97))
        tail = order[pos:]
        rng.shuffle(tail)
        return order[:pos] + tail

    # ---------------------------------------------------------------- backoff
    def _backoff(self, attempt: int) -> None:
        delay = min(self.backoff_max,
                    self.backoff_base * (2.0 ** (attempt - 1)))
        # equal jitter over [delay/2, delay): decorrelated, never immediate
        time.sleep(delay * (0.5 + 0.5 * float(self._jrng.random())))

    # ------------------------------------------------------------- checkpoint
    def _save(self, epoch: int, next_pos: int,
              order: Optional[List[int]] = None) -> None:
        cursor = TrainingCursor.of(self.net, epoch=epoch,
                                   data_position=next_pos)
        if order is not None and order != list(range(len(order))):
            # a reshuffled epoch order rides with the cursor, so a restart
            # resumes against the same permutation
            cursor.extra["order"] = list(order)
        self.manager.save(self.net, cursor=cursor)
        # a committed checkpoint is progress: the escalation counts
        # consecutive rollbacks with none in between
        self._consecutive_rollbacks = 0

    @staticmethod
    def _cursor_order(cursor: Optional[TrainingCursor],
                      n: int) -> List[int]:
        saved = (cursor.extra or {}).get("order") if cursor else None
        if (isinstance(saved, list)
                and sorted(int(i) for i in saved) == list(range(n))):
            return [int(i) for i in saved]
        return list(range(n))

    # --------------------------------------------------------------- rollback
    def _rollback(self, cause: RollbackRequested, n_batches: int):
        """Reload the last valid checkpoint; returns (cursor, order) with
        the not-yet-consumed tail of the order re-randomized."""
        self._consecutive_rollbacks += 1
        self._c_rollbacks.inc()
        if self._consecutive_rollbacks > self.max_consecutive_rollbacks:
            raise DivergenceError(
                f"{self._consecutive_rollbacks} consecutive rollbacks "
                f"without a completed checkpoint (last divergence at "
                f"step {cause.step}); escalating", step=cause.step)
        with get_tracer().span("rollback", step=cause.step,
                               attempt=self._consecutive_rollbacks):
            info = self.manager.latest_valid()
            if info is None:
                raise CheckpointError(
                    "rollback requested but no valid checkpoint exists "
                    f"in {self.manager.directory}") from cause
            cursor = self.manager.restore(self.net, info)
        if self.sentinel is not None:
            self.sentinel.reset()   # pending flags describe undone steps
        self._salt += 1
        order = self._reshuffle_tail(
            self._cursor_order(cursor, n_batches),
            cursor.data_position, cursor.epoch)
        logger.warning("rolled back to step %d after divergence at step "
                       "%d (rollback %d/%d)", info.step, cause.step,
                       self._consecutive_rollbacks,
                       self.max_consecutive_rollbacks)
        return cursor, order

    # -------------------------------------------------------------------- fit
    def fit(self, data, epochs: int = 1) -> "FaultTolerantTrainer":
        batches = self._materialize(data)
        if not batches:
            return self
        n = len(batches)
        epoch, pos = 0, 0
        cursor = self.manager.restore(self.net) if self.resume else None
        order = self._cursor_order(cursor, n)
        if cursor is not None:
            epoch, pos = cursor.epoch, cursor.data_position
            logger.info("resumed from checkpoint at step %d "
                        "(epoch %d, batch %d)", cursor.step, epoch, pos)
        else:
            # the anchor: a divergence at step 1 must have a state to
            # roll back to
            self._save(epoch=0, next_pos=0)
        while epoch < epochs:
            if pos >= n:
                epoch, pos, order = epoch + 1, 0, list(range(n))
                continue
            try:
                pos = self._run_epoch_from(batches, order, epoch, pos)
                if self.sentinel is not None:
                    self.sentinel.flush()
                self._save(epoch=epoch + 1, next_pos=0)
                epoch, pos, order = epoch + 1, 0, list(range(n))
            except RollbackRequested as rb:
                cursor, order = self._rollback(rb, n)
                epoch, pos = cursor.epoch, cursor.data_position
        return self

    def _run_epoch_from(self, batches: List, order: List[int],
                        epoch: int, pos: int) -> int:
        """Batches ``order[pos:]`` with retry and periodic checkpoints.
        RollbackRequested propagates to ``fit``. Returns len(order)."""
        net = self.net
        i = pos
        while i < len(order):
            step_id = net.iteration_count + 1
            batch = faultinject.poison_batch(batches[order[i]], step_id)
            attempt = 0
            while True:
                try:
                    faultinject.check_raise(step_id)
                    self.target.fit_batch(batch)
                    break
                except TRANSIENT_ERRORS as e:
                    attempt += 1
                    if attempt > self.max_retries:
                        raise
                    self._c_retries.inc()
                    get_tracer().instant("transient_retry", step=step_id,
                                         attempt=attempt)
                    logger.warning("transient failure at step %d "
                                   "(attempt %d/%d): %s", step_id,
                                   attempt, self.max_retries, e)
                    self._backoff(attempt)
            i += 1
            if (self.checkpoint_every
                    and net.iteration_count % self.checkpoint_every == 0):
                # flush first, so a diverged but lagging flag is not
                # checkpointed as clean progress
                if self.sentinel is not None:
                    self.sentinel.flush()
                self._save(epoch=epoch, next_pos=i, order=order)
        return i
