"""Flight recorder: a process-global, bounded, thread-safe ring of
structured events — the black-box tape the post-mortem tooling replays
when a run wedges or dies (the JAX package's ``profiling/flightrec.py``,
whole: it imports no JAX).

Subsystems emit one-line events at their existing seams (step barrier,
admission, drain, lease transitions, prefill/decode dispatch,
faultinject firings) via the module-level ``record()``.  Each event is
``{ts, subsystem, kind, detail}`` with JSON-safe detail values, so the
tail can be embedded verbatim into a diagnostic bundle.

Design notes:
- The ring is a ``collections.deque(maxlen=...)``: appends are O(1) and
  the oldest events fall off silently; ``total_recorded`` keeps the
  lifetime count so truncation is visible (tail length < total means
  the tape wrapped).
- Recording must be safe from ANY thread at ANY seam, including inside
  teardown paths — so ``record()`` takes exactly one short-lived lock
  and never calls back into other subsystems (no tracer, no registry,
  no I/O).
- No torch import: the recorder must be importable from any tool
  without touching a device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "get_flightrec", "set_flightrec", "record"]

_SCALARS = (str, int, float, bool, type(None))


def _jsonable(value: Any) -> Any:
    """Clamp a detail value to a JSON-safe scalar (repr otherwise)."""
    if isinstance(value, _SCALARS):
        return value
    return repr(value)


class FlightRecorder:
    """Bounded ring of ``{ts, subsystem, kind, detail}`` events."""

    def __init__(self, max_events: int = 4096):
        if max_events <= 0:
            raise ValueError(f"max_events must be positive: {max_events}")
        self.max_events = max_events
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max_events)
        self._total = 0

    # ------------------------------------------------------------ record
    def record(self, subsystem: str, kind: str, **detail: Any) -> None:
        event = {
            "ts": time.time(),
            "subsystem": subsystem,
            "kind": kind,
            "detail": {k: _jsonable(v) for k, v in detail.items()},
        }
        with self._lock:
            self._ring.append(event)
            self._total += 1

    # ------------------------------------------------------------- query
    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The most recent ``n`` events, oldest first (all when None)."""
        with self._lock:
            events = list(self._ring)
        if n is not None and n >= 0:
            events = events[-n:] if n else []
        return events

    @property
    def total_recorded(self) -> int:
        """Lifetime event count (> len(tail()) once the ring wrapped)."""
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total = 0


# ------------------------------------------------------ process-global
_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_flightrec() -> FlightRecorder:
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def set_flightrec(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Swap the process-global recorder (tests); returns the previous."""
    global _default
    with _default_lock:
        prev = _default
        _default = rec
        return prev


def record(subsystem: str, kind: str, **detail: Any) -> None:
    """Emit one event into the process-global recorder."""
    get_flightrec().record(subsystem, kind, **detail)
