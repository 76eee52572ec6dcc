"""Deterministic fault injection (the JAX package's
``resilience/faultinject.py``: the schedule, the hooks of the generation
engine, of a checkpoint's commit, of the Keras gateway and its predict
batching, the replica kinds a gateway consults, and the ``nan`` kind of
a training loop, ``poison_batch``, and the fault-tolerant trainer's
``raise``), the fleet's overload kinds (``flap_replica``,
``load_spike``), the elastic trainer's host kinds, the streaming input
pipeline's kinds (``slow_input``, ``io_error``) and the streaming
broker's wire kinds (``drop_connection``, ``slow_loris``,
``corrupt_frame``).

Training fault kinds:

- ``raise``            — ``check_raise(step)`` raises ``FaultInjected`` (a
  transient host failure: a preemption, a flaky RPC) just before the
  scheduled training ``step`` dispatches; the FaultTolerantTrainer's
  bounded-backoff retry must absorb it.
- ``nan``              — ``poison_batch(batch, step)`` returns a copy of
  the batch whose first feature is NaN at the scheduled ``step``; the
  divergence sentinel's guard must keep the update from landing.

Host fault kinds (``ElasticTrainer``'s seams, consulted before every
step's dispatch):

- ``kill_host``        — ``check_kill(step)`` hard-exits THIS process
  with ``KILL_HOST_EXIT_CODE`` at the scheduled ``step``: no flush, no
  cleanup, nothing a handler could catch (a preemption).
- ``kill_coordinator`` — the same mechanics, armed on the lease holder.
- ``slow_host``        — ``host_step_stall(step)`` returns ``duration``
  seconds this host's ``step`` stalls before dispatch (a straggler:
  its heartbeats keep landing).
- ``rejoin_host``      — ``check_rejoin(step)`` returns the rank a
  replacement host announces itself as (``rank``; -1: the lowest rank
  not in the world); the trainer writes the join request.
- ``partition_host``   — ``check_partition(step)`` opens a window of
  ``duration`` seconds (0: until cleared) in which this process's
  heartbeats do not land while it keeps running.

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

Fleet overload kinds (the autoscaler's and the flap quarantine's seams):

- ``flap_replica``     — replica ``rank`` becomes a crash-looper: each
  of its next ``count`` incarnations (spawns since arming, starting at
  the ``at_call``-th) hard-kills itself ``duration`` seconds AFTER the
  router admits it. ``check_flap_spawn(rank)`` is the per-spawn hook
  ``FleetReplica`` consults at construction; the router's flap
  quarantine is the defense under test.
- ``load_spike``       — declarative burst against the ROUTER:
  ``load_spike_spec()`` hands the scheduled ``count`` (and
  ``duration``, the window to spread it over) to the chaos harness,
  which fires that many concurrent requests.

Input-pipeline fault kinds (``datasets/pipeline.py``'s seams):

- ``slow_input``       — the Nth pipeline ``next()`` stalls ``duration``
  seconds before the consumer dequeues (``on_input_next``); the stall
  must land in ``input_stall_s`` (and ``input_stall_seconds_total``)
  with the open-span stack naming ``input:wait``: a starved trainer is
  a measurement, never a mystery hang.
- ``io_error``         — the Nth reader-worker read attempt raises
  (``on_reader_read``: a flaky object store, a lost NFS mount); the
  pipeline's bounded-backoff retry must absorb it, counted in
  ``input_read_retries_total``, or surface a clean in-order error when
  its retries are spent.

Streaming wire fault kinds (``streaming/ndarray_channel.py``'s seams):

- ``drop_connection``  — at the consumer's Nth recv (``on_stream_recv``)
  close its socket under it; the reconnect / backoff path must recover
  the stream. ``mode="pub"`` targets the publisher's Nth send instead
  (``on_pub_send``: its reconnect path is symmetric but separately
  counted).
- ``slow_loris``       — the Nth ``_send_array`` dribbles its frame
  header byte by byte over ``duration`` seconds (``slow_loris_s``); the
  receiver's header or mid-frame timeout must reclaim its thread.
- ``corrupt_frame``    — corrupt the Nth frame on the wire
  (``corrupt_wire``). ``mode="length"`` rewrites the length header to a
  multi-GB claim, ``mode="crc"`` flips a payload byte (the CRC-32
  trailer must catch it), ``mode="truncate"`` halves the frame (the
  receiver must see a clean truncation error, never a garbage array).

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

Faults fire once each (``flap_replica`` once per incarnation, up to
``count``); ``at_call`` counters restart whenever a schedule is armed.
"""

from __future__ import annotations

import struct
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

_KINDS = ("raise", "nan", "poison_decode", "evict_cache", "evict_page",
          "corrupt_page_table", "truncate_checkpoint", "hang_backend",
          "burst", "poison_row", "slow_batch", "slow_input", "io_error",
          "kill_host", "slow_host",
          "kill_coordinator", "rejoin_host", "partition_host",
          "kill_replica", "partition_replica", "slow_replica",
          "flap_replica", "load_spike", "drop_connection", "slow_loris",
          "corrupt_frame")

#: the exit code of a ``kill_host`` hard exit: distinct, so a launcher can
#: tell a victim that died by the fault from one that died of a bug
KILL_HOST_EXIT_CODE = 117


class FaultInjected(RuntimeError):
    """A scheduled transient fault (retryable by FaultTolerantTrainer)."""


class KilledByFault(RuntimeError):
    """A scheduled simulated process death (``truncate_checkpoint``
    crash mode) — NOT retryable: the "process" is gone; a fresh run must
    resume from the last valid checkpoint."""


@dataclass
class Fault:
    """One scheduled fault. ``at_call`` arms it at the Nth request
    (``poison_decode``, ``poison_row``, the replica kinds), dispatch
    (``hang_backend``, ``slow_batch``), pipeline ``next()``
    (``slow_input``), reader read attempt (``io_error``), consumer recv or
    publisher send (``drop_connection``), wire frame (``slow_loris``,
    ``corrupt_frame``), commit or decode iteration (the others), 1-based; ``step`` is the training step of ``raise``, ``nan``
    and the host kinds, the poisoned request's decode step (or a
    mid-stream ``kill_replica``'s token); ``rank`` the target row's age
    rank (``evict_page``, ``corrupt_page_table``; -1 = the oldest), the
    target replica, or the rank a ``rejoin_host`` joins as; ``mode`` how
    a ``truncate_checkpoint`` tears its commit (``"crash"`` or
    ``"torn"``), a ``drop_connection``'s side (``"pub"``: the
    publisher's) or a ``corrupt_frame``'s corruption (``"length"``,
    ``"crc"``, ``"truncate"``); ``duration`` the stall of a
    ``slow_loris`` frame, of ``hang_backend`` /
    ``slow_batch`` / ``slow_input`` / ``slow_replica`` / ``slow_host``,
    the window of ``partition_replica`` / ``partition_host``, a
    ``flap_replica`` incarnation's life after admission and a
    ``load_spike``'s spread;
    ``count`` a ``burst``'s or ``load_spike``'s size and a
    ``flap_replica``'s incarnations; ``fires`` the incarnations a
    ``flap_replica`` consumed."""

    kind: str
    step: int = 0
    at_call: int = 1
    rank: int = -1
    mode: str = "crash"
    duration: float = 0.0
    count: int = 0
    fired: bool = False
    fires: int = 0

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
_input_nexts = 0
_reader_reads = 0
_recv_calls = 0
_pub_calls = 0
_frame_sends = 0
_loris_sends = 0
#: per-replica-rank admitted-request counters (``kill_replica`` /
#: ``partition_replica`` / ``slow_replica`` at_call addressing)
_replica_requests: Dict[int, int] = {}
#: per-replica-rank streamed-token counters (``kill_replica`` with
#: ``step`` > 0 — the mid-stream kill address)
_replica_tokens: Dict[int, int] = {}
#: the host-wide heartbeat-suppression window (``partition_host``)
_partition_until: Optional[float] = None
#: per-replica-rank heartbeat-suppression windows (``partition_replica``)
_replica_partition_until: Dict[int, float] = {}
#: per-replica-rank spawn counters since arming (``flap_replica``
#: at_call addressing: the Nth incarnation of that rank)
_replica_spawns: Dict[int, int] = {}


def set_schedule(schedule: Optional[FaultSchedule]) -> None:
    """Arm a schedule (or disarm with ``None``). Resets call counters so
    ``at_call`` indices are relative to arming time."""
    global _schedule, _gen_submits, _decode_iters, _page_iters, _pt_iters
    global _commit_calls, _dispatch_calls, _predict_loads, _batch_dispatches
    global _partition_until, _input_nexts, _reader_reads
    global _recv_calls, _pub_calls, _frame_sends, _loris_sends
    with _lock:
        _schedule = schedule
        _partition_until = None
        _replica_requests.clear()
        _replica_tokens.clear()
        _replica_partition_until.clear()
        _replica_spawns.clear()
        _dispatch_calls = 0
        _predict_loads = 0
        _batch_dispatches = 0
        _input_nexts = 0
        _reader_reads = 0
        _recv_calls = 0
        _pub_calls = 0
        _frame_sends = 0
        _loris_sends = 0
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


def check_raise(step: int) -> None:
    """Raise a scheduled transient fault for this training step."""
    with _lock:
        if _schedule is None:
            return
        for f in _schedule.pending():
            if f.kind == "raise" and f.step == step:
                _fire(f, step=step)
                raise FaultInjected(f"injected transient fault at step "
                                    f"{step}")


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


def on_input_next() -> float:
    """Called by the input pipeline's consumer per ``next()``: the stall
    (seconds) a scheduled ``slow_input`` fault injects into this
    (``at_call``-th) call, 0.0 for none. The caller sleeps INSIDE its
    ``input:wait`` span, so the stall is measured as input stall and
    named by the open-span stack."""
    global _input_nexts
    with _lock:
        if _schedule is None:
            return 0.0
        _input_nexts += 1
        for f in _schedule.pending():
            if f.kind == "slow_input" and f.at_call == _input_nexts:
                _fire(f, next=_input_nexts, duration=f.duration)
                return max(0.0, f.duration)
        return 0.0


def on_reader_read(source=None) -> None:
    """Called by the pipeline's reader workers per read ATTEMPT: a
    scheduled ``io_error`` fault raises ``FaultInjected`` on its Nth
    attempt (a flaky object store). The bounded-backoff retry loop sits
    around this call, so consecutive scheduled faults spend the retries
    as a persistent outage would."""
    global _reader_reads
    with _lock:
        if _schedule is None:
            return
        _reader_reads += 1
        for f in _schedule.pending():
            if f.kind == "io_error" and f.at_call == _reader_reads:
                _fire(f, read=_reader_reads, source=str(source)[:120])
                raise FaultInjected(
                    f"injected io_error at reader read {_reader_reads}")


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


def check_kill(step: int) -> None:
    """Called by ElasticTrainer per training step (before dispatch): a
    ``kill_host`` (or ``kill_coordinator``) fault scheduled for ``step``
    hard-exits this process with ``KILL_HOST_EXIT_CODE``: no flush, no
    cleanup, no exception a handler could catch. The ``fault_injected``
    instant and counter land first and die with the process; the
    survivors' detection counters are the record."""
    with _lock:
        hit = None
        if _schedule is not None:
            for f in _schedule.pending():
                if f.kind in ("kill_host", "kill_coordinator") \
                        and f.step == step:
                    hit = f
                    break
            if hit is not None:
                _fire(hit, step=step)
    if hit is not None:
        import os
        import sys
        print(f"faultinject: {hit.kind} at step {step}: os._exit",
              file=sys.stderr, flush=True)
        os._exit(KILL_HOST_EXIT_CODE)


def host_step_stall(step: int) -> float:
    """Called by ElasticTrainer per training step (before dispatch): the
    seconds a ``slow_host`` fault scheduled for ``step`` stalls it (0.0:
    run normally). The caller sleeps in a tracer span of its own; its
    heartbeats keep beating from their thread."""
    with _lock:
        if _schedule is None:
            return 0.0
        for f in _schedule.pending():
            if f.kind == "slow_host" and f.step == step:
                _fire(f, step=step, duration=f.duration)
                return max(0.0, f.duration)
        return 0.0


def check_rejoin(step: int) -> Optional[int]:
    """Called by ElasticTrainer per training step: the rank a
    ``rejoin_host`` fault scheduled for ``step`` joins as (``Fault.rank``;
    -1: the caller picks the lowest rank not in its world), or None. The
    caller writes the join request a real replacement would."""
    with _lock:
        if _schedule is None:
            return None
        for f in _schedule.pending():
            if f.kind == "rejoin_host" and f.step == step:
                _fire(f, step=step, rank=f.rank)
                return int(f.rank)
        return None


def check_partition(step: int) -> None:
    """Called by ElasticTrainer per training step: a ``partition_host``
    fault scheduled for ``step`` opens the host-wide heartbeat
    suppression window (``duration`` seconds; 0: until the schedule is
    cleared). The process keeps running; only its liveness signal
    stops, the signature of a partition rather than a crash."""
    global _partition_until
    with _lock:
        if _schedule is None:
            return
        for f in _schedule.pending():
            if f.kind == "partition_host" and f.step == step:
                _fire(f, step=step, duration=f.duration)
                _partition_until = (float("inf") if f.duration <= 0
                                    else time.monotonic() + f.duration)
                return


def heartbeat_suppressed(rank: Optional[int] = None) -> bool:
    """Consulted by ``HostHeartbeat.beat`` before every write: True while
    the host-wide ``partition_host`` window is open (with or without a
    ``rank``), or a ``partition_replica`` window for ``rank``: the beat
    is dropped while the process keeps running."""
    with _lock:
        now = time.monotonic()
        if _partition_until is not None and now < _partition_until:
            return True
        if rank is None:
            return False
        until = _replica_partition_until.get(int(rank))
        return until is not None and now < until


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


def check_flap_spawn(rank: int) -> Optional[float]:
    """Called by ``FleetReplica`` at construction: when a
    ``flap_replica`` fault targets this rank, this incarnation is the
    ``at_call``-th-or-later spawn since arming, and fires remain (of
    ``count``, default 1), returns the post-ADMISSION kill delay
    (``duration`` seconds): the replica arms a watcher that hard-kills
    it that long after the router admits it. None = live normally.

    Counts once per spawn; the fault disarms (``fired``) when its last
    incarnation is consumed, so the rank's NEXT spawn comes up healthy:
    the crash-loop-then-recover shape the quarantine's release path
    needs."""
    rank = int(rank)
    with _lock:
        if _schedule is None:
            return None
        n = _replica_spawns.get(rank, 0) + 1
        _replica_spawns[rank] = n
        for f in _schedule.faults:
            if f.kind != "flap_replica" or f.rank != rank or f.fired:
                continue
            if n < f.at_call:
                continue
            total = max(1, int(f.count) or 1)
            f.fires += 1
            # every incarnation counts and stamps; fired flips only when
            # the loop is spent
            get_registry().counter(
                "resilience_faults_injected_total",
                help="faults injected by the chaos harness").inc()
            get_tracer().instant("fault_injected", kind="flap_replica",
                                 rank=rank, spawn=n, fire=f.fires)
            flight_record("faultinject", "fired", fault="flap_replica",
                          rank=rank, spawn=n, fire=f.fires)
            if f.fires >= total:
                f.fired = True
            return max(0.0, f.duration)
        return None


def load_spike_spec() -> Optional[dict]:
    """Hand a chaos harness the scheduled ``load_spike`` burst: a
    ``{"count": N, "duration": seconds}`` spec (fires once; None when
    nothing is armed). The harness fires ``count`` concurrent requests
    at the ROUTER, spread over ``duration``."""
    with _lock:
        if _schedule is None:
            return None
        for f in _schedule.pending():
            if f.kind == "load_spike":
                _fire(f, count=f.count, duration=f.duration)
                return {"count": int(f.count),
                        "duration": max(0.0, float(f.duration))}
        return None


def on_stream_recv() -> bool:
    """Called by the streaming consumer before each blocking recv;
    returns True when the scheduled ``drop_connection`` fault fires (the
    caller closes its own socket to simulate the drop). Entries with
    ``mode="pub"`` belong to ``on_pub_send`` and are skipped here."""
    global _recv_calls
    with _lock:
        if _schedule is None:
            return False
        _recv_calls += 1
        for f in _schedule.pending():
            if (f.kind == "drop_connection" and f.mode != "pub"
                    and f.at_call == _recv_calls):
                _fire(f, recv=_recv_calls)
                return True
        return False


def on_pub_send() -> bool:
    """Called by the streaming publisher before each send; returns True
    when a ``drop_connection`` fault with ``mode="pub"`` fires (the
    publisher closes its own socket to simulate a dropped stream)."""
    global _pub_calls
    with _lock:
        if _schedule is None:
            return False
        _pub_calls += 1
        for f in _schedule.pending():
            if (f.kind == "drop_connection" and f.mode == "pub"
                    and f.at_call == _pub_calls):
                _fire(f, send=_pub_calls)
                return True
        return False


def corrupt_wire(frame: bytes) -> bytes:
    """Called by ``_send_array`` with the complete wire frame (length
    word + payload [+ CRC trailer]); a scheduled ``corrupt_frame`` fault
    returns a corrupted frame for its Nth send."""
    global _frame_sends
    with _lock:
        hit = None
        if _schedule is not None:
            _frame_sends += 1
            for f in _schedule.pending():
                if f.kind == "corrupt_frame" and f.at_call == _frame_sends:
                    hit = f
                    break
            if hit is not None:
                _fire(hit, mode=hit.mode, send=_frame_sends)
    if hit is None:
        return frame
    if hit.mode == "length":
        # keep the v2 flag bit if present; claim a multi-GB payload
        (hdr,) = struct.unpack(">Q", frame[:8])
        flag = hdr & (1 << 63)
        return struct.pack(">Q", flag | (1 << 40)) + frame[8:]
    if hit.mode == "crc":
        i = min(8 + max(0, (len(frame) - 8) // 2), len(frame) - 1)
        return frame[:i] + bytes([frame[i] ^ 0xFF]) + frame[i + 1:]
    return frame[:max(9, len(frame) // 2)]  # truncate


def slow_loris_s() -> float:
    """Called by ``_send_array`` per frame; returns the total stall to
    spread over the frame header's bytes when a ``slow_loris`` fault is
    scheduled for this (``at_call``-th) send; 0.0 sends normally."""
    global _loris_sends
    with _lock:
        if _schedule is None:
            return 0.0
        _loris_sends += 1
        for f in _schedule.pending():
            if f.kind == "slow_loris" and f.at_call == _loris_sends:
                _fire(f, duration=f.duration)
                return max(0.0, f.duration)
        return 0.0
