"""Divergence sentinel (the JAX package's ``resilience/sentinel.py``):
in-step non-finite detection with a host policy.

A NaN loss late in a run is not an exception: it poisons the params, and
every later step computes on garbage. The defence is split across the
device/host boundary:

**In the step** (:func:`nonfinite_flag`, :func:`guard_update` and
:func:`guarded_in_place`, run by every guarded train step): ``bad =
~isfinite(loss) | ~isfinite(sum(grad^2))`` as a bool scalar on the device,
and the old params, optimizer state and layer states selected when it is
set, with ``torch.where`` on the device. The port's update runs in place,
so :func:`guarded_in_place` keeps a copy of the tensors the update writes
and writes the old values back where the flag is set: no host read, and a
non-finite update never lands, whatever the host policy.

**On the host** (:class:`DivergenceSentinel`): the step hands over its
flag. Reading it at once would make the host wait for the step, so the
sentinel starts a copy of the flag into pinned host memory behind the
step, records an event, and reads the copy ``lag`` steps later, when the
step has long finished. Policies:

- ``raise``      - raise :class:`DivergenceError` naming the step;
- ``skip_batch`` - count it (the guard already skipped the update) and
  keep training;
- ``rollback``   - raise :class:`RollbackRequested` for a fault-tolerant
  trainer to reload its last checkpoint (ROADMAP A6).

``lag=0`` reads each flag at once (tests).
"""

from __future__ import annotations

import collections
from typing import Deque, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.updater import tree_leaves, tree_map
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

POLICIES = ("raise", "skip_batch", "rollback")


class DivergenceError(RuntimeError):
    """Non-finite loss/grad-norm under policy='raise'."""

    def __init__(self, message: str, step: int = -1):
        super().__init__(message)
        self.step = step


class RollbackRequested(RuntimeError):
    """Non-finite step under policy='rollback'. A fault-tolerant trainer
    handles it; reaching user code means a rollback sentinel ran outside
    one."""

    def __init__(self, message: str, step: int = -1):
        super().__init__(message)
        self.step = step


def nonfinite_flag(loss, grads) -> torch.Tensor:
    """A bool scalar on the loss's device: the loss or the global sum of
    squared gradients is non-finite. The sum is taken over each tensor's
    f32 norm (one multi-tensor kernel for all of them): a norm overflows
    to inf exactly when its sum of squares does, and overflow is
    divergence here."""
    leaves = [g.float() for g in tree_leaves(grads) if g is not None]
    gsq = (torch.stack(torch._foreach_norm(leaves)).square().sum()
           if leaves else torch.zeros((), device=loss.device))
    return ~(torch.isfinite(loss) & torch.isfinite(gsq))


def host_nonfinite(arr) -> bool:
    """True when ``arr`` (a numpy array or a tensor on any device) carries
    any NaN/Inf. The serving edge uses it to refuse to ship garbage
    predictions (counted as ``serving_nonfinite_outputs_total`` by the
    caller)."""
    if isinstance(arr, torch.Tensor):
        return not bool(torch.isfinite(arr).all())
    return not bool(np.isfinite(np.asarray(arr)).all())


def _select(bad, old_tree, new_tree):
    def pick(o, n):
        if not isinstance(n, torch.Tensor):
            return n
        return torch.where(bad, o, n)
    return tree_map(pick, old_tree, new_tree)


def guard_update(loss, grads, old, new):
    """``old`` / ``new``: containers of one structure (params, optimizer
    state, layer states, carries). Returns ``(selected, bad)``, where
    ``selected`` is ``old`` where the step went non-finite."""
    bad = nonfinite_flag(loss, grads)
    return _select(bad, old, new), bad


def guarded_in_place(bad: torch.Tensor, tensors: Sequence[torch.Tensor],
                     update) -> None:
    """Run ``update()``, which writes ``tensors`` in place, so that it
    lands only where ``bad`` is False: the tensors are copied first and
    written back from the copy under ``torch.where(bad, ...)``. On a bad
    step every tensor is bitwise what it was; nothing is read on the
    host. Tensors of one dtype and device are copied as one flat buffer
    (a concatenation, one select, one multi-tensor copy back), so the
    guard costs a few launches, not a few per tensor."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    saved = {key: torch.cat([t.reshape(-1) for t in group])
             for key, group in groups.items()}
    update()
    with torch.no_grad():
        for key, group in groups.items():
            flat = torch.where(bad, saved[key],
                               torch.cat([t.reshape(-1) for t in group]))
            parts = flat.split([t.numel() for t in group])
            torch._foreach_copy_(group, [p.view(t.shape)
                                         for p, t in zip(parts, group)])


def _stage(flag):
    """A device flag's copy into pinned host memory, started behind the
    step, and the event that marks it done; a host flag as it is."""
    if isinstance(flag, torch.Tensor) and flag.is_cuda:
        host = torch.empty(flag.shape, dtype=flag.dtype, pin_memory=True)
        host.copy_(flag, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return flag, None


class DivergenceSentinel:
    """Host-side flag drain and policy. Attach with
    ``net.set_divergence_sentinel(sentinel)``; the containers' steps are
    guarded from then on."""

    def __init__(self, policy: str = "raise", lag: int = 1):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.lag = max(0, int(lag))
        self._pending: Deque[Tuple[int, object, object]] = \
            collections.deque()
        self._skipped = 0  # this sentinel's skips (the registry counter
        #                    below is process-global and outlives it)
        reg = get_registry()
        self._c_nonfinite = reg.counter(
            "resilience_nonfinite_steps_total",
            help="train steps whose loss/grad-norm went non-finite")
        self._c_skipped = reg.counter(
            "resilience_skipped_batches_total",
            help="batches skipped by the divergence sentinel")

    # ------------------------------------------------------------------ drain
    def observe(self, flag, step: int) -> None:
        """Record the step's flag; act on the flags older than ``lag``.
        May raise per policy, for the step it drained (``lag`` steps
        behind the one just run)."""
        self._pending.append((step, *_stage(flag)))
        while len(self._pending) > self.lag:
            self._handle(*self._pending.popleft())

    def flush(self) -> None:
        """Act on every pending flag (end of epoch / end of fit)."""
        while self._pending:
            self._handle(*self._pending.popleft())

    def reset(self) -> None:
        """Drop pending flags without acting on them (after a rollback
        restored the model, stale flags describe discarded steps)."""
        self._pending.clear()

    @property
    def skipped_batches(self) -> int:
        return self._skipped

    # ----------------------------------------------------------------- policy
    def _handle(self, step: int, flag, done) -> None:
        if done is not None:
            # the copy was queued behind the step: with lag >= 1 the step
            # has finished by now and this returns at once
            done.synchronize()
        if isinstance(flag, torch.Tensor):
            hit = bool(flag.any())
        else:
            hit = bool(np.any(np.asarray(flag)))
        if not hit:
            return
        self._c_nonfinite.inc()
        get_tracer().instant("nonfinite_step", step=step,
                             policy=self.policy)
        if self.policy == "skip_batch":
            self._skipped += 1
            self._c_skipped.inc()
            return
        if self.policy == "rollback":
            raise RollbackRequested(
                f"non-finite loss/grad-norm at step {step} "
                "(policy=rollback)", step=step)
        raise DivergenceError(
            f"non-finite loss/grad-norm at step {step} (policy=raise); "
            "the in-step guard kept the previous params", step=step)
