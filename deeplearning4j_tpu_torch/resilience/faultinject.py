"""Deterministic fault injection (the JAX package's
``resilience/faultinject.py``: the schedule, the hooks of the generation
engine, of a checkpoint's commit, of the Keras gateway and its predict
batching, the replica kinds a gateway consults, and the ``nan`` kind of
a training loop, ``poison_batch``). The trainers' ``raise`` kind, the
broker, input-pipeline and elastic kinds, and the rest of the fleet
kinds, wait for the paths they test (ROADMAP A5.3, A6, A7).

Training fault kind:

- ``nan``              — ``poison_batch(batch, step)`` returns a copy of
  the batch whose first feature is NaN at the scheduled ``step``; the
  divergence sentinel's guard must keep the update from landing.

Gateway fault kinds (the serving edge's chaos seams):

- ``hang_backend``     — the Nth KerasServer model dispatch sleeps
  ``duration`` seconds (a hung card or model); deadline budgets must
  expire and the circuit breaker must count it.
- ``burst``            — declarative burst size for chaos harnesses:
  ``burst_size()`` hands the scheduled ``count`` to the test driver,
  which fires that many concurrent requests.
- ``poison_row``       — NaN-poison the Nth predict request's features
  at the batching seam, so ONE request in a coalesced batch produces a
  nonfinite row block; the per-row sentinel must fail it alone while
  its batchmates are served.
- ``slow_batch``       — the Nth *batched* dispatch stalls ``duration``
  seconds before execution (a hung card under a formed batch);
  deadline-blown members must fail alone, the rest succeed late or on
  their own budget.

Replica fault kinds (a gateway built with a ``replica_rank``):

- ``kill_replica``     — hard-kill replica ``rank`` at its
  ``at_call``-th admitted request: its listener and every established
  connection close abruptly. With ``step`` > 0 the kill fires
  mid-STREAM instead, at the replica's ``step``-th streamed token.
- ``partition_replica``— from replica ``rank``'s ``at_call``-th admitted
  request, suppress ITS heartbeat for ``duration`` seconds (0 = until
  the schedule is cleared) while it keeps serving.
- ``slow_replica``     — replica ``rank``'s ``at_call``-th admitted
  request stalls ``duration`` seconds before dispatch.

Checkpoint fault kind:

- ``truncate_checkpoint`` — tear the ``at_call``-th checkpoint commit.
  ``mode="crash"`` truncates the tmp file and raises ``KilledByFault``
  before the rename (a SIGKILL mid-write: the final path never
  appears). ``mode="torn"`` lets a truncated file land at the final
  path (a torn write that the rename protocol cannot see: checksum
  verification must catch it on restore).

Token-level decode fault kinds:

- ``poison_decode``    — NaN-poison the logits of the ``at_call``-th
  generation request at its ``step``-th decode step. The per-row
  sentinel must fail that request alone MID-STREAM; its decode
  batchmates keep generating unharmed.
- ``evict_cache``      — force a ring-buffer KV eviction at the engine's
  ``at_call``-th decode iteration: the oldest-admitted row is evicted
  exactly as memory pressure would evict it, and must RE-PREFILL from
  its prompt + generated-so-far tokens — never garbage.
- ``evict_page``       — force PAGE-granular eviction at the engine's
  ``at_call``-th decode iteration: the ``rank``-th oldest-admitted row
  (default 0) loses its COLDEST droppable KV page exactly as pool
  pressure would drop it, REPLAYS its recorded tokens from the page
  boundary (emission suppressed) and resumes a bitwise-identical token
  stream (a row with no droppable page falls back to whole-row
  eviction).
- ``corrupt_page_table`` — scribble an out-of-pool physical page id
  into the ``rank``-th oldest row's write slot at the ``at_call``-th
  decode iteration. Host-side validation must fail THAT row with a
  structured ``PAGE_TABLE`` error before the mapping reaches a step.

Faults fire once each; ``at_call`` counters restart whenever a schedule
is armed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

_KINDS = ("nan", "poison_decode", "evict_cache", "evict_page",
          "corrupt_page_table", "truncate_checkpoint", "hang_backend",
          "burst", "poison_row", "slow_batch", "kill_replica",
          "partition_replica", "slow_replica")


class KilledByFault(RuntimeError):
    """A scheduled simulated process death (``truncate_checkpoint``
    crash mode) — NOT retryable: the "process" is gone; a fresh run must
    resume from the last valid checkpoint."""


@dataclass
class Fault:
    """One scheduled fault. ``at_call`` arms it at the Nth request
    (``poison_decode``, ``poison_row``, the replica kinds), dispatch
    (``hang_backend``, ``slow_batch``), commit or decode iteration (the
    others), 1-based; ``step`` is the poisoned request's decode step (or
    a mid-stream ``kill_replica``'s token); ``rank`` the target row's age
    rank (``evict_page``, ``corrupt_page_table``; -1 = the oldest) or the
    target replica; ``mode`` how a ``truncate_checkpoint`` tears its
    commit (``"crash"`` or ``"torn"``); ``duration`` the stall of
    ``hang_backend`` / ``slow_batch`` / ``slow_replica`` and the window
    of ``partition_replica``; ``count`` a ``burst``'s size."""

    kind: str
    step: int = 0
    at_call: int = 1
    rank: int = -1
    mode: str = "crash"
    duration: float = 0.0
    count: int = 0
    fired: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")


@dataclass
class FaultSchedule:
    faults: List[Fault] = field(default_factory=list)

    def pending(self) -> List[Fault]:
        return [f for f in self.faults if not f.fired]


_lock = threading.Lock()
_schedule: Optional[FaultSchedule] = None
_gen_submits = 0
_decode_iters = 0
_page_iters = 0
_pt_iters = 0
_commit_calls = 0
_dispatch_calls = 0
_predict_loads = 0
_batch_dispatches = 0
#: per-replica-rank admitted-request counters (``kill_replica`` /
#: ``partition_replica`` / ``slow_replica`` at_call addressing)
_replica_requests: Dict[int, int] = {}
#: per-replica-rank streamed-token counters (``kill_replica`` with
#: ``step`` > 0 — the mid-stream kill address)
_replica_tokens: Dict[int, int] = {}
#: per-replica-rank heartbeat-suppression windows (``partition_replica``)
_replica_partition_until: Dict[int, float] = {}


def set_schedule(schedule: Optional[FaultSchedule]) -> None:
    """Arm a schedule (or disarm with ``None``). Resets call counters so
    ``at_call`` indices are relative to arming time."""
    global _schedule, _gen_submits, _decode_iters, _page_iters, _pt_iters
    global _commit_calls, _dispatch_calls, _predict_loads, _batch_dispatches
    with _lock:
        _schedule = schedule
        _replica_requests.clear()
        _replica_tokens.clear()
        _replica_partition_until.clear()
        _dispatch_calls = 0
        _predict_loads = 0
        _batch_dispatches = 0
        _gen_submits = 0
        _decode_iters = 0
        _page_iters = 0
        _pt_iters = 0
        _commit_calls = 0


def clear() -> None:
    set_schedule(None)


def active() -> bool:
    return _schedule is not None and bool(_schedule.pending())


def _fire(fault: Fault, **args) -> None:
    fault.fired = True
    get_registry().counter(
        "resilience_faults_injected_total",
        help="faults injected by the chaos harness").inc()
    get_tracer().instant("fault_injected", kind=fault.kind, **args)
    flight_record("faultinject", "fired", fault=fault.kind, **args)


def poison_batch(batch, step: int):
    """``batch`` with NaN-poisoned features if a ``nan`` fault is
    scheduled for ``step``, else ``batch`` unchanged. Works on a DataSet
    (``features`` an array) and a MultiDataSet (a list of arrays); the
    original batch is never mutated."""
    with _lock:
        hit = None
        if _schedule is not None:
            for f in _schedule.pending():
                if f.kind == "nan" and f.step == step:
                    hit = f
                    break
        if hit is None:
            return batch
        _fire(hit, step=step)
    import copy

    def _poison(f):
        a = np.array(f, copy=True)
        if not np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        a.flat[0] = np.nan
        return a

    poisoned = copy.copy(batch)
    feats = batch.features
    if isinstance(feats, (list, tuple)):
        poisoned.features = type(feats)(_poison(f) for f in feats)
    else:
        poisoned.features = _poison(feats)
    return poisoned


def on_generate_submit() -> int:
    """Called by the generation scheduler per submitted request;
    returns the request's 1-based index SINCE THE SCHEDULE WAS ARMED —
    the ``at_call`` address of ``poison_decode``."""
    global _gen_submits
    with _lock:
        _gen_submits += 1
        return _gen_submits


def poison_decode_row(request_index: int, step: int) -> bool:
    """Called by the generation engine per live row per decode step
    with the request's submit index and its own decode-step count
    (1-based). True = the scheduled ``poison_decode`` fault fires: the
    caller replaces that row's probabilities with NaN."""
    with _lock:
        if _schedule is None:
            return False
        for f in _schedule.pending():
            if (f.kind == "poison_decode" and f.at_call == request_index
                    and f.step == step):
                _fire(f, request=request_index, step=step)
                return True
        return False


def check_evict_cache() -> bool:
    """Called by the generation engine once per decode iteration; True
    = a scheduled ``evict_cache`` fault fires on its ``at_call``-th
    iteration since arming, and the engine must force one ring-buffer
    KV eviction."""
    global _decode_iters
    with _lock:
        if _schedule is None:
            return False
        _decode_iters += 1
        for f in _schedule.pending():
            if f.kind == "evict_cache" and f.at_call == _decode_iters:
                _fire(f, iteration=_decode_iters)
                return True
        return False


def check_evict_page() -> Optional[int]:
    """Called by the generation engine once per decode iteration; a
    scheduled ``evict_page`` fault fires on its ``at_call``-th iteration
    since arming (own counter) and returns the target row ordinal
    (``rank``-th oldest-admitted row, default 0). ``None`` = no fault
    due."""
    global _page_iters
    with _lock:
        if _schedule is None:
            return None
        _page_iters += 1
        for f in _schedule.pending():
            if f.kind == "evict_page" and f.at_call == _page_iters:
                _fire(f, iteration=_page_iters, rank=f.rank)
                return max(0, f.rank)
        return None


def check_corrupt_page_table() -> Optional[int]:
    """Called by the generation engine once per decode iteration; a
    scheduled ``corrupt_page_table`` fault fires on its ``at_call``-th
    iteration since arming (own counter) and returns the target row
    ordinal. ``None`` = no fault due."""
    global _pt_iters
    with _lock:
        if _schedule is None:
            return None
        _pt_iters += 1
        for f in _schedule.pending():
            if f.kind == "corrupt_page_table" and f.at_call == _pt_iters:
                _fire(f, iteration=_pt_iters, rank=f.rank)
                return max(0, f.rank)
        return None


def on_checkpoint_commit(tmp: Path, final: Path) -> None:
    """Called by ``atomic.atomic_path`` between fsync and rename.

    crash mode: truncate the tmp file and raise ``KilledByFault`` — the
    rename never happens, the final path never appears (exactly what a
    SIGKILL between write and rename leaves behind).
    torn mode: truncate the tmp file and let the rename proceed — a
    complete-looking file with half its bytes, catchable only by
    checksum verification.
    """
    global _commit_calls
    with _lock:
        if _schedule is None:
            return
        _commit_calls += 1
        hit = None
        for f in _schedule.pending():
            if (f.kind == "truncate_checkpoint"
                    and f.at_call == _commit_calls):
                hit = f
                break
        if hit is None:
            return
        _fire(hit, file=str(final), mode=hit.mode)
    size = tmp.stat().st_size
    with open(tmp, "r+b") as fh:
        fh.truncate(max(size // 2, 1))
    if hit.mode == "crash":
        raise KilledByFault(
            f"simulated SIGKILL mid-checkpoint write of {final}")
    # torn mode: fall through — the caller renames the stump


def on_backend_dispatch(op: str = "") -> None:
    """Called by KerasServer immediately before the model op; a
    scheduled ``hang_backend`` fault stalls this dispatch for
    ``duration`` seconds (the sleep happens OUTSIDE the harness lock —
    a hung backend must not freeze the whole chaos schedule)."""
    global _dispatch_calls
    with _lock:
        hit = None
        if _schedule is not None:
            _dispatch_calls += 1
            for f in _schedule.pending():
                if f.kind == "hang_backend" and f.at_call == _dispatch_calls:
                    hit = f
                    break
            if hit is not None:
                _fire(hit, op=op, dispatch=_dispatch_calls)
    if hit is not None:
        time.sleep(max(0.0, hit.duration))


def poison_predict(features: np.ndarray) -> np.ndarray:
    """Called by KerasServer per loaded predict payload (the batching
    seam); a scheduled ``poison_row`` fault NaN-poisons the Nth
    request's features — so one member of a coalesced batch turns
    nonfinite while its batchmates stay clean. The input array is
    never mutated."""
    global _predict_loads
    with _lock:
        if _schedule is None:
            return features
        _predict_loads += 1
        hit = None
        for f in _schedule.pending():
            if f.kind == "poison_row" and f.at_call == _predict_loads:
                hit = f
                break
        if hit is None:
            return features
        _fire(hit, request=_predict_loads)
    poisoned = np.array(features, copy=True)
    if not np.issubdtype(poisoned.dtype, np.floating):
        poisoned = poisoned.astype(np.float32)
    poisoned.flat[0] = np.nan
    return poisoned


def on_batch_dispatch(key: str = "") -> None:
    """Called by the batching scheduler immediately before executing a
    coalesced batch; a scheduled ``slow_batch`` fault stalls this
    dispatch for ``duration`` seconds (sleep OUTSIDE the harness lock —
    a stalled batch must not freeze the chaos schedule)."""
    global _batch_dispatches
    with _lock:
        hit = None
        if _schedule is not None:
            _batch_dispatches += 1
            for f in _schedule.pending():
                if f.kind == "slow_batch" and f.at_call == _batch_dispatches:
                    hit = f
                    break
            if hit is not None:
                _fire(hit, key=key, dispatch=_batch_dispatches)
    if hit is not None:
        time.sleep(max(0.0, hit.duration))


def burst_size() -> int:
    """Hand a chaos driver the scheduled ``burst`` fault's ``count``
    (0 when none is armed) — the driver fires that many concurrent
    requests."""
    with _lock:
        if _schedule is None:
            return 0
        for f in _schedule.pending():
            if f.kind == "burst":
                _fire(f, count=f.count)
                return int(f.count)
        return 0


def heartbeat_suppressed(rank: Optional[int] = None) -> bool:
    """True while a ``partition_replica`` window for ``rank`` is open:
    the replica's heartbeat write is silently dropped while it keeps
    serving. (The JAX package's host-wide ``partition_host`` window
    waits for the elastic trainer, ROADMAP A6.)"""
    if rank is None:
        return False
    with _lock:
        until = _replica_partition_until.get(int(rank))
        return until is not None and time.monotonic() < until


def on_replica_request(rank: int) -> Tuple[float, bool]:
    """Called by a replica's server per ADMITTED request (probes —
    health/readyz/debug — don't count, so ``at_call`` stays predictable
    under polling). Increments the rank's request counter once and fires
    every replica kind addressed at it:

    - ``slow_replica``      → first element: stall seconds (caller
      sleeps OUTSIDE the harness lock, before dispatch)
    - ``partition_replica`` → opens the rank's heartbeat-suppression
      window (``duration`` seconds, 0 = until cleared)
    - ``kill_replica`` (``step`` == 0) → second element True: the caller
      must hard-kill itself (close listener + connections)

    Returns ``(stall_s, kill)``."""
    rank = int(rank)
    stall = 0.0
    kill = False
    with _lock:
        if _schedule is None:
            return 0.0, False
        n = _replica_requests.get(rank, 0) + 1
        _replica_requests[rank] = n
        for f in _schedule.pending():
            if f.rank != rank or f.at_call != n:
                continue
            if f.kind == "slow_replica":
                _fire(f, rank=rank, request=n, duration=f.duration)
                stall = max(stall, f.duration)
            elif f.kind == "partition_replica":
                _fire(f, rank=rank, request=n, duration=f.duration)
                _replica_partition_until[rank] = (
                    float("inf") if f.duration <= 0
                    else time.monotonic() + f.duration)
            elif f.kind == "kill_replica" and f.step <= 0:
                _fire(f, rank=rank, request=n)
                kill = True
    return stall, kill


def check_kill_replica_token(rank: int) -> bool:
    """Called by a replica's server per streamed generation token
    (before the partial hits the wire): True when a ``kill_replica``
    fault with ``step`` > 0 is addressed at this rank's ``step``-th
    token since arming — the caller hard-kills itself MID-STREAM."""
    rank = int(rank)
    with _lock:
        if _schedule is None:
            return False
        n = _replica_tokens.get(rank, 0) + 1
        _replica_tokens[rank] = n
        for f in _schedule.pending():
            if (f.kind == "kill_replica" and f.rank == rank
                    and f.step > 0 and f.step == n):
                _fire(f, rank=rank, token=n)
                return True
        return False
