"""Stall watchdog (the JAX package's ``profiling/watchdog.py``):
heartbeat-fed daemon that turns a silent hang into a diagnostic bundle
on disk.

Subsystems call ``beat("serving_decode")`` at their liveness seams (the
decode loop's dispatch, the gateway's admission, ``"elastic"`` before an
elastic training step's barrier); ``heartbeat_ages()``
reads how long ago each beat last fired. A ``StallWatchdog`` watches
named heartbeats against per-subsystem deadlines; when one goes stale it
writes a **diagnostic bundle** — every thread's Python stack
(``sys._current_frames``), every tracer thread's open-span stack, a
metrics-registry snapshot and the flight-recorder tail — atomically
through ``resilience/atomic.py``, one bundle per stall episode, and
re-arms when the beat recovers. An opt-in ``SIGTERM`` / ``atexit`` path
dumps the same bundle when the process is ended from outside.

The bundle is the JAX package's schema (``format:
dl4j-tpu-diagnostic-bundle/v1``), so its ``tools/postmortem.py`` reads
the port's bundles too; ``assemble_bundle`` names the stall culprit:
the deepest open span of the stalest heartbeat's thread.

Lock discipline: ``_beats_lock`` (module) and ``StallWatchdog._lock``
guard plain dict state only; bundle assembly, file I/O and the
``close()`` join all run outside both locks, so the watchdog cannot
deadlock the process it is diagnosing. ``atomic_write_bytes`` is
imported inside the dump path (``resilience.atomic`` pulls
``faultinject``, which imports back into ``profiling``).
"""

from __future__ import annotations

import atexit
import json
import os
import re
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.profiling.flightrec import get_flightrec
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

__all__ = ["StallWatchdog", "assemble_bundle", "beat", "heartbeat_ages",
           "clear_beats", "BUNDLE_FORMAT"]

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


# --------------------------------------------------------- the watchdog

class StallWatchdog:
    """Daemon monitor: stale heartbeat past its deadline -> bundle on
    disk. One bundle per stall episode (re-arms when the heartbeat
    recovers); ``dump()`` can also be called directly for externally
    detected failures."""

    def __init__(self, bundle_dir: str, interval_s: float = 1.0,
                 exit_dump: bool = False, name: str = "stall-watchdog"):
        self.bundle_dir = bundle_dir
        os.makedirs(bundle_dir, exist_ok=True)
        self.interval_s = interval_s
        self.last_bundle_path: Optional[str] = None
        self._lock = threading.Lock()
        self._watched: Dict[str, float] = {}      # subsystem -> deadline_s
        self._fired: set = set()                  # stall episodes dumped
        self._seq = 0
        self._closed = False
        self._stop = threading.Event()
        self._exit_dump = exit_dump
        self._prev_sigterm = None
        if exit_dump:
            atexit.register(self._on_exit)
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
            except ValueError:        # not the main thread
                self._prev_sigterm = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # --------------------------------------------------------- arm/disarm
    def watch(self, subsystem: str, deadline_s: float) -> None:
        """Start expecting ``beat(subsystem)`` at least every
        ``deadline_s`` seconds (beats once so the clock starts now)."""
        beat(subsystem)
        with self._lock:
            self._watched[subsystem] = float(deadline_s)
            self._fired.discard(subsystem)

    def unwatch(self, subsystem: str) -> None:
        with self._lock:
            self._watched.pop(subsystem, None)
            self._fired.discard(subsystem)

    # ------------------------------------------------------------ monitor
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._check()

    def _check(self) -> None:
        now = time.monotonic()
        with self._lock:
            watched = dict(self._watched)
            fired = set(self._fired)
        with _beats_lock:
            beats = dict(_beats)
        for subsystem, deadline_s in watched.items():
            entry = beats.get(subsystem)
            if entry is None:
                continue
            ts, tid = entry
            age = now - ts
            if age <= deadline_s:
                if subsystem in fired:      # recovered: re-arm
                    with self._lock:
                        self._fired.discard(subsystem)
                continue
            if subsystem in fired:          # already dumped this episode
                continue
            with self._lock:
                self._fired.add(subsystem)
            self.dump(reason="stalled_heartbeat",
                      stale={"subsystem": subsystem, "age_s": age,
                             "deadline_s": deadline_s, "tid": tid})

    # --------------------------------------------------------------- dump
    def dump(self, reason: str,
             stale: Optional[Dict[str, Any]] = None) -> str:
        """Assemble a bundle and write it atomically; returns the path.
        A reader never sees a half-written bundle."""
        bundle = assemble_bundle(reason, stale=stale)
        with self._lock:
            self._seq += 1
            seq = self._seq
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:48]
        path = os.path.join(
            self.bundle_dir, f"bundle-{os.getpid()}-{seq:03d}-{slug}.json")
        data = json.dumps(bundle, indent=2, default=repr).encode()
        # here, not at module top: resilience.atomic -> faultinject ->
        # profiling.metrics would be a load-time cycle
        from deeplearning4j_tpu_torch.resilience.atomic import (
            atomic_write_bytes)
        atomic_write_bytes(path, data)
        get_flightrec().record("watchdog", "bundle_written", reason=reason,
                               path=path)
        with self._lock:
            self.last_bundle_path = path
        return path

    # ---------------------------------------------------------- exit path
    def _on_exit(self) -> None:
        with self._lock:
            closed = self._closed
        if not closed:
            try:
                self.dump(reason="atexit")
            except Exception:       # interpreter teardown: best effort
                pass

    def _on_sigterm(self, signum, frame) -> None:
        try:
            self.dump(reason="sigterm")
        except Exception:
            pass
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    # ------------------------------------------------------------ teardown
    def close(self) -> None:
        """Stop and join the monitor thread; detach the exit hooks. The
        join runs outside every lock."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._thread.join(self.interval_s + 10.0)
        if self._exit_dump:
            atexit.unregister(self._on_exit)
            if self._prev_sigterm is not None:
                try:
                    signal.signal(signal.SIGTERM, self._prev_sigterm)
                except ValueError:
                    pass

    def __enter__(self) -> "StallWatchdog":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
