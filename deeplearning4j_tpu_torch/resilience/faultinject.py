"""Deterministic fault injection for the generation engine (the JAX
package's ``resilience/faultinject.py``: the schedule and the engine's
five hooks). The training, network, input-pipeline, elastic and fleet
kinds wait for the paths they test (ROADMAP A5 part 2, A6).

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
from dataclasses import dataclass, field
from typing import List, Optional

from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

_KINDS = ("poison_decode", "evict_cache", "evict_page",
          "corrupt_page_table")


@dataclass
class Fault:
    """One scheduled fault. ``at_call`` arms it at the Nth request
    (``poison_decode``) or decode iteration (the others), 1-based;
    ``step`` is the poisoned request's decode step; ``rank`` the target
    row's age rank (``evict_page``, ``corrupt_page_table``; -1 = the
    oldest)."""

    kind: str
    step: int = 0
    at_call: int = 1
    rank: int = -1
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


def set_schedule(schedule: Optional[FaultSchedule]) -> None:
    """Arm a schedule (or disarm with ``None``). Resets call counters so
    ``at_call`` indices are relative to arming time."""
    global _schedule, _gen_submits, _decode_iters, _page_iters, _pt_iters
    with _lock:
        _schedule = schedule
        _gen_submits = 0
        _decode_iters = 0
        _page_iters = 0
        _pt_iters = 0


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
