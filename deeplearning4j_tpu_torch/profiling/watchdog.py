"""Watchdog heartbeats and the diagnostic bundle (the JAX package's
``profiling/watchdog.py``: its module-level beats and the bundle
assembly the gateway's ``debug`` op serves).

Subsystems call ``beat("serving_decode")`` at their liveness seams (the
decode loop's dispatch, the gateway's admission); ``heartbeat_ages()``
reads how long ago each beat last fired. ``assemble_bundle`` builds the
**diagnostic bundle** — every thread's Python stack
(``sys._current_frames``), every tracer thread's open-span stack, a
metrics-registry snapshot and the flight-recorder tail — in the JAX
package's schema (``format: dl4j-tpu-diagnostic-bundle/v1``), and names
the stall culprit: the deepest open span of the stalest heartbeat's
thread. ``StallWatchdog``, which watches the ages and writes bundles to
disk, waits for ROADMAP A5.3.

``_beats_lock`` guards plain dict state only; bundle assembly runs
outside it.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.profiling.flightrec import get_flightrec
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

__all__ = ["assemble_bundle", "beat", "heartbeat_ages", "clear_beats",
           "BUNDLE_FORMAT"]

BUNDLE_FORMAT = "dl4j-tpu-diagnostic-bundle/v1"

_beats: Dict[str, tuple] = {}           # name -> (monotonic_ts, tid)
_beats_lock = threading.Lock()


def beat(name: str) -> None:
    """Record a liveness heartbeat for subsystem ``name`` (cheap: one
    short lock, one dict write). The tid is kept so a stale heartbeat
    can be attributed to ITS thread's open spans."""
    with _beats_lock:
        _beats[name] = (time.monotonic(), threading.get_ident())


def heartbeat_ages() -> Dict[str, float]:
    """Seconds since each named heartbeat last fired."""
    now = time.monotonic()
    with _beats_lock:
        return {name: now - ts for name, (ts, _tid) in _beats.items()}


def clear_beats() -> None:
    """Forget every heartbeat (tests)."""
    with _beats_lock:
        _beats.clear()


# ------------------------------------------------------ bundle assembly

def _thread_stacks() -> List[Dict[str, Any]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append({
            "tid": tid,
            "name": names.get(tid, "?"),
            "stack": [{"file": fs.filename, "line": fs.lineno,
                       "func": fs.name, "code": fs.line or ""}
                      for fs in traceback.extract_stack(frame)],
        })
    return out


def _find_culprit(stale: Optional[Dict[str, Any]],
                  heartbeats: Dict[str, Dict[str, Any]],
                  open_spans: Dict[str, List[dict]]
                  ) -> Optional[Dict[str, Any]]:
    """Stall culprit = deepest open span of the stale (else stalest)
    heartbeat's thread; falls back to the most recently opened span
    anywhere when that thread has none in flight."""
    if stale:
        subsystem, tid = stale.get("subsystem"), stale.get("tid")
    elif heartbeats:
        subsystem = max(heartbeats, key=lambda n: heartbeats[n]["age_s"])
        tid = heartbeats[subsystem]["tid"]
    else:
        subsystem = tid = None
    if tid is not None:
        stack = open_spans.get(str(tid))
        if stack:
            return {"subsystem": subsystem, "tid": tid,
                    "span": stack[-1]["name"], "via": "stale_thread"}
    deepest, deepest_tid = None, None
    for t, stack in open_spans.items():
        if stack and (deepest is None
                      or stack[-1]["t0_us"] > deepest["t0_us"]):
            deepest, deepest_tid = stack[-1], t
    if deepest is not None:
        return {"subsystem": subsystem, "tid": int(deepest_tid),
                "span": deepest["name"], "via": "deepest_any_thread"}
    return None


def assemble_bundle(reason: str, stale: Optional[Dict[str, Any]] = None,
                    max_tail: int = 512) -> Dict[str, Any]:
    """Build the diagnostic bundle dict. Needs no running watchdog — the
    KerasServer ``debug`` op calls this directly."""
    now = time.monotonic()
    with _beats_lock:
        beats = dict(_beats)
    heartbeats = {name: {"age_s": now - ts, "tid": tid}
                  for name, (ts, tid) in beats.items()}
    tracer = get_tracer()
    open_spans = {str(tid): spans for tid, spans
                  in tracer.open_spans_by_thread().items()}
    rec = get_flightrec()
    bundle: Dict[str, Any] = {
        "format": BUNDLE_FORMAT,
        "reason": reason,
        "written_at_unix": time.time(),
        "pid": os.getpid(),
        "stale": stale,
        "heartbeats": heartbeats,
        "threads": _thread_stacks(),
        "open_spans": open_spans,
        "error_spans": tracer.error_span_stack(),
        "metrics": get_registry().to_dict(),
        "flight_total": rec.total_recorded,
        "flight_tail": rec.tail(max_tail),
    }
    bundle["culprit"] = _find_culprit(stale, heartbeats, open_spans)
    return bundle
