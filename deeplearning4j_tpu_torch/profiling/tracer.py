"""Thread-safe span tracer exporting Chrome trace-event JSON (the JAX
package's ``profiling/tracer.py``, whole: it imports no JAX).

Spans nest via ``with tracer.span("shard"):`` (per-thread stacks) or run
explicitly via ``begin()``/``end()`` for async work that starts on one
thread and finishes on another (the AsyncDataSetIterator prefetch
pattern). Export is the Chrome trace-event format — ``"X"`` complete
events with microsecond timestamps — which Perfetto and chrome://tracing
open directly; one process = one ``pid``, one thread = one ``tid``.

``open_span_stack()`` returns the names of every span currently in
flight, start-ordered: when something hangs, that stack is the
diagnosis.

A process-global default tracer (``get_tracer()``) is what the serving
engine emits into; the buffer is bounded (oldest events drop, counted)
so a long-running server cannot leak memory into the tracer. Timing is
host wall time (``perf_counter``): a span around unsynchronized CUDA
work measures its launch, not the device's compute — synchronize first
when the device time is the question.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _SpanHandle:
    """Token returned by ``Tracer.begin`` — pass it back to ``end``."""

    __slots__ = ("name", "t0_us", "tid", "args", "closed")

    def __init__(self, name: str, t0_us: float, tid: int, args: dict):
        self.name = name
        self.t0_us = t0_us
        self.tid = tid
        self.args = args
        self.closed = False


class _SpanCtx:
    """Context manager wrapping one begin/end pair (re-entrant safe:
    every ``with`` creates a fresh instance)."""

    __slots__ = ("_tracer", "_handle")

    def __init__(self, tracer: "Tracer", handle: _SpanHandle):
        self._tracer = tracer
        self._handle = handle

    def __enter__(self):
        return self._handle

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            # record the span stack the exception unwound through —
            # `open_span_stack()` is empty by the time an outer handler
            # runs, because these exits already closed the spans
            self._tracer._note_error(self._handle, exc)
        self._tracer.end(self._handle)
        return False


class Tracer:
    """Bounded-buffer span recorder with Chrome trace-event export."""

    def __init__(self, max_events: int = 200_000, enabled: bool = True):
        self.enabled = enabled
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._dropped = 0
        # tid -> open-span stack (list of _SpanHandle, outermost first);
        # a dict (not threading.local) so open_span_stack() can see every
        # thread's in-flight spans — the hang diagnosis requirement
        self._open: Dict[int, List[_SpanHandle]] = {}
        self._error_key: Optional[int] = None
        self._error_stack: List[str] = []
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------ recording
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def begin(self, name: str, **args) -> _SpanHandle:
        """Open a span explicitly (async work); close with ``end()``.
        ``end`` may run on a different thread than ``begin``."""
        tid = threading.get_ident()
        h = _SpanHandle(name, self._now_us(), tid, args)
        if self.enabled:
            with self._lock:
                self._open.setdefault(tid, []).append(h)
        return h

    def end(self, handle: _SpanHandle) -> None:
        if handle.closed or not self.enabled:
            handle.closed = True
            return
        handle.closed = True
        dur = max(self._now_us() - handle.t0_us, 0.0)
        ev = {"name": handle.name, "ph": "X", "ts": handle.t0_us,
              "dur": dur, "pid": os.getpid(), "tid": handle.tid}
        if handle.args:
            ev["args"] = dict(handle.args)
        with self._lock:
            stack = self._open.get(handle.tid)
            if stack and handle in stack:
                stack.remove(handle)
                if not stack:
                    del self._open[handle.tid]
            dropped = self._append_locked(ev)
        self._count_dropped(dropped)

    def _append_locked(self, ev: dict) -> int:
        """Bounded append (caller holds the lock): every event source —
        end/instant/complete — shares the same drop-oldest-half trim.
        Returns how many events this append evicted so the caller can
        publish the count AFTER releasing the lock (the registry has its
        own locks; never nest them under the tracer's)."""
        dropped = 0
        if len(self._events) >= self.max_events:
            # drop the OLDEST half in one go: per-event pop(0) would
            # make the full-buffer steady state quadratic
            self._events = self._events[self.max_events // 2:]
            dropped = self.max_events - len(self._events)
            self._dropped += dropped
        self._events.append(ev)
        return dropped

    def _count_dropped(self, dropped: int) -> None:
        """Publish buffer evictions as ``tracer_events_dropped`` so
        bounded-buffer truncation shows up on the same ``/api/metrics``
        surface as everything else (lazy import: keep this module free
        of load-time dependencies)."""
        if not dropped:
            return
        from deeplearning4j_tpu_torch.profiling.metrics import get_registry
        get_registry().counter(
            "tracer_events_dropped",
            help="trace events evicted from the bounded buffer"
        ).inc(dropped)

    def span(self, name: str, **args) -> _SpanCtx:
        """``with tracer.span("shard"):`` — nested spans stack per
        thread."""
        return _SpanCtx(self, self.begin(name, **args))

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (ph "i")."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "s": "t",
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            dropped = self._append_locked(ev)
        self._count_dropped(dropped)

    def complete(self, name: str, t0_us: float, dur_us: float,
                 **args) -> None:
        """Record an already-measured interval (e.g. a capture duration
        reported after the fact)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": t0_us, "dur": max(dur_us, 0.0),
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            dropped = self._append_locked(ev)
        self._count_dropped(dropped)

    def _note_error(self, handle: _SpanHandle, exc: BaseException) -> None:
        """Called by span contexts as an exception unwinds through them
        (innermost first). One stack per exception object."""
        with self._lock:
            if self._error_key != id(exc):
                self._error_key = id(exc)
                self._error_stack = []
            self._error_stack.append(handle.name)

    # ------------------------------------------------------------ inspection
    def error_span_stack(self) -> List[str]:
        """The span stack the most recent exception unwound through,
        outermost first (the failure-record diagnosis for raises, as
        ``open_span_stack`` is for hangs)."""
        with self._lock:
            return list(reversed(self._error_stack))

    def open_span_stack(self) -> List[str]:
        """Names of every in-flight span, across all threads, ordered by
        start time (outermost/oldest first) — the hang diagnosis."""
        with self._lock:
            live = [h for stack in self._open.values() for h in stack]
        return [h.name for h in sorted(live, key=lambda h: h.t0_us)]

    def open_spans_by_thread(self) -> Dict[int, List[dict]]:
        """Per-thread in-flight spans, outermost first: tid -> list of
        ``{name, t0_us, args}``. The diagnostic-bundle form — the stall
        culprit is the DEEPEST open span of the stale subsystem's
        thread, which the flat ``open_span_stack`` cannot attribute."""
        with self._lock:
            return {tid: [{"name": h.name, "t0_us": h.t0_us,
                           "args": dict(h.args)} for h in stack]
                    for tid, stack in self._open.items() if stack}

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    # --------------------------------------------------------------- export
    def export(self) -> dict:
        """Chrome trace-event JSON object (the ``traceEvents`` wrapper
        form both Perfetto and chrome://tracing accept)."""
        with self._lock:
            events = [dict(e) for e in self._events]
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self._dropped}}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.export(), indent=indent)

    def save(self, path: str) -> str:
        """Write the trace to ``path`` (open it in Perfetto)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
            self._error_key = None
            self._error_stack = []


# ---------------------------------------------------------------------------
# process-global default tracer
# ---------------------------------------------------------------------------

_default = Tracer()
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer the containers and trainers emit into."""
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests, per-run capture). Returns
    the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, tracer
    return prev


def span(name: str, **args) -> _SpanCtx:
    """``with profiling.span("epoch"):`` on the global tracer."""
    return _default.span(name, **args)
