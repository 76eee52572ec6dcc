"""Watchdog heartbeats (the JAX package's ``profiling/watchdog.py``, its
module-level beats only).

Subsystems call ``beat("serving_decode")`` at their liveness seams (the
decode loop's dispatch); ``heartbeat_ages()`` reads how long ago each
beat last fired. ``StallWatchdog``, which watches these ages and writes a
diagnostic bundle when one goes stale, is not ported yet (ROADMAP A7).

``_beats_lock`` guards plain dict state only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

__all__ = ["beat", "heartbeat_ages", "clear_beats"]

_beats: Dict[str, tuple] = {}           # name -> (monotonic_ts, tid)
_beats_lock = threading.Lock()


def beat(name: str) -> None:
    """Record a liveness heartbeat for subsystem ``name`` (cheap: one
    short lock, one dict write)."""
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
