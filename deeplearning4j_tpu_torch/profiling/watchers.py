"""Feeders for the metrics registry: the compile watcher and the
device-memory watermark (the JAX package's ``profiling/watchers.py``).

The port compiles in three places, and each reports through
:func:`report_compile`: an ``nvcc`` build of a kernel library
(``ops/cuda_build.build_libraries``, only when a build runs, not when a
built library loads), a CUDA-graph capture (the serving engine's step
runners, ``keras/generation.py``, and the gateway's predict runners,
``keras/batching.py``), and a ``g++`` build of a host library
(``native_loader.build_native``). ``CompileWatcher.install()`` adds
itself to that hook list and counts and times each compile into the
registry and the span tracer's timeline; ``wrap()`` warns when a watched function is
called with a new argument shape signature.

``DeviceMemoryWatermark`` samples ``torch.cuda.memory_stats`` in a thread
of its own: a bytes-in-use gauge and a ratcheting high watermark.
Without a card both degrade to no-ops.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, get_registry,
)
from deeplearning4j_tpu_torch.profiling.tracer import Tracer, get_tracer

logger = logging.getLogger(__name__)

#: compile kind -> (metric stem, span name)
COMPILE_KINDS = {
    "nvcc": ("nvcc_build", "compile:nvcc"),
    "cuda_graph": ("cuda_graph_capture", "compile:cuda_graph"),
    "gxx": ("native_build", "compile:gxx"),
}

_COMPILE_TIME_BUCKETS = (0.01, 0.05, 0.2, 1.0, 5.0, 20.0, 60.0, 300.0)

#: the listeners each compile is reported to: ``fn(kind, seconds, label)``
_COMPILE_HOOKS: List[Callable[[str, float, str], None]] = []
_HOOKS_LOCK = threading.Lock()


def report_compile(kind: str, seconds: float, label: str = "") -> None:
    """Called where the port compiles (``kind`` one of
    :data:`COMPILE_KINDS`): hands the compile to every installed
    watcher."""
    with _HOOKS_LOCK:
        hooks = list(_COMPILE_HOOKS)
    for hook in hooks:
        hook(kind, float(seconds), label)


class CompileWatcher:
    """Counts and times the port's compiles. Counters
    ``<stem>_total`` and ``<stem>_seconds_total`` for each kind
    (``nvcc_build``, ``cuda_graph_capture``, ``native_build``), a
    ``compile_seconds``
    histogram, and a span on the tracer's timeline a compile.
    ``install()`` and ``uninstall()`` are idempotent. A compile longer
    than ``warn_compile_s`` logs a warning."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 warn_compile_s: float = 30.0):
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        self.warn_compile_s = warn_compile_s
        self._lock = threading.Lock()
        self._wrapped_sigs: Dict[str, set] = {}

    # ------------------------------------------------------------ listeners
    def install(self) -> "CompileWatcher":
        with _HOOKS_LOCK:
            if self._on_compile not in _COMPILE_HOOKS:
                _COMPILE_HOOKS.append(self._on_compile)
        return self

    def uninstall(self) -> None:
        with _HOOKS_LOCK:
            if self._on_compile in _COMPILE_HOOKS:
                _COMPILE_HOOKS.remove(self._on_compile)

    @property
    def installed(self) -> bool:
        with _HOOKS_LOCK:
            return self._on_compile in _COMPILE_HOOKS

    def counts(self) -> Dict[str, float]:
        """``{kind: compiles counted}``."""
        return {kind: self.registry.counter(f"{stem}_total").value
                for kind, (stem, _) in COMPILE_KINDS.items()}

    def _on_compile(self, kind: str, seconds: float, label: str) -> None:
        hit = COMPILE_KINDS.get(kind)
        if hit is None:
            return
        stem, span_name = hit
        self.registry.counter(
            f"{stem}_total", help=f"number of {span_name} events").inc()
        self.registry.counter(
            f"{stem}_seconds_total",
            help=f"cumulative seconds in {span_name}").inc(seconds)
        self.registry.histogram(
            "compile_seconds", help="seconds a compile (nvcc or g++ build, "
            "or CUDA-graph capture)", buckets=_COMPILE_TIME_BUCKETS
        ).observe(seconds)
        # the timeline's span, backdated by the compile's length
        self.tracer.complete(span_name, self.tracer._now_us() - seconds * 1e6,
                             seconds * 1e6, label=label)
        if seconds >= self.warn_compile_s:
            logger.warning("%s %s took %.1fs", span_name, label, seconds)

    # ------------------------------------------------------- recompile guard
    @staticmethod
    def _signature(args, kwargs):
        """Hashable (shape, dtype) tree of the tensor-like leaves; Python
        scalars keep their type."""
        def leaf(x):
            shape = getattr(x, "shape", None)
            if shape is not None:
                return ("arr", tuple(shape), str(getattr(x, "dtype", "?")))
            if isinstance(x, (list, tuple)):
                return tuple(leaf(v) for v in x)
            if isinstance(x, dict):
                return tuple(sorted((k, leaf(v)) for k, v in x.items()))
            return ("py", type(x).__name__)
        return (tuple(leaf(a) for a in args),
                tuple(sorted((k, leaf(v)) for k, v in kwargs.items())))

    def wrap(self, fn, label: str):
        """Wrap a callable: each new argument shape signature after the
        first is counted (``jit_shape_recompiles_total``) and warned once
        (a captured graph or a shape-keyed cache builds anew for it). The
        call itself passes through untouched."""
        def wrapped(*args, **kwargs):
            sig = self._signature(args, kwargs)
            with self._lock:
                seen = self._wrapped_sigs.setdefault(label, set())
                fresh = sig not in seen
                n_seen = len(seen)
                if fresh:
                    seen.add(sig)
            if fresh and n_seen >= 1:
                self.registry.counter(
                    "jit_shape_recompiles_total",
                    help="watched functions called on a new shape "
                         "signature").inc()
                logger.warning(
                    "%s: argument shapes changed (signature #%d): this "
                    "call builds anew", label, n_seen + 1)
            return fn(*args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", label)
        return wrapped


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of ``device`` (the current card by
    default) as ``{"bytes_in_use", "peak_bytes_in_use", ...}``; None on
    the CPU or without a card. Never raises."""
    try:
        import torch
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        ms = dict(torch.cuda.memory_stats(device))
        ms["bytes_in_use"] = int(ms.get("allocated_bytes.all.current", 0))
        ms["peak_bytes_in_use"] = int(ms.get("allocated_bytes.all.peak", 0))
        return ms
    except Exception:  # noqa: BLE001: telemetry must never raise
        return None


class DeviceMemoryWatermark:
    """Device-memory sampler feeding the registry, in a thread of its own
    (``start`` / ``stop``). Gauges ``device_bytes_in_use`` (the latest
    sample) and ``device_bytes_in_use_watermark`` (the largest, ratcheted
    over the samples). ``sample()`` may be called directly."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 0.5, device=None):
        self.registry = registry or get_registry()
        self.interval_s = interval_s
        self.device = device
        self.watermark_bytes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def sample(self) -> Optional[dict]:
        ms = device_memory_stats(self.device)
        if not ms or "bytes_in_use" not in ms:
            return None
        in_use = int(ms["bytes_in_use"])
        # the allocator's own peak since its last reset when it reports
        # one, else the samples' ratchet
        peak = int(ms.get("peak_bytes_in_use", 0)) or in_use
        with self._lock:
            self.watermark_bytes = max(self.watermark_bytes, peak, in_use)
            watermark = self.watermark_bytes
        self.registry.gauge(
            "device_bytes_in_use",
            help="device memory in use (memory_stats probe)").set(in_use)
        self.registry.gauge(
            "device_bytes_in_use_watermark",
            help="high watermark of device memory in use").set_max(
                watermark)
        return ms

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def start(self) -> "DeviceMemoryWatermark":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="device-mem-watermark", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
