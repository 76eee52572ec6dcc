"""Queue and compile-cache helpers of the Keras gateway's schedulers (the
JAX package's ``keras/batching.py``: what the generation engine imports).

- **Priority classes**: ``priority_rank`` / ``priority_insert`` order a
  queue ``interactive`` ahead of ``bulk``, FIFO within a class.
- **Compile cache**: one process-global, budgeted, cross-model LRU of
  per-bucket steps (``CompileCache``). In the JAX package an entry is an
  AOT-compiled XLA executable; in the port it is the generation engine's
  step runner, a CUDA graph captured once per (kind, bucket) on the card
  and the eager step on the CPU. The budget counts entries and the bytes
  each entry reports (a graph's private memory pool).
- **Latency windows**: ``quantile`` and ``_LatencyWindow``, the p50/p99
  gauges (the generation engine's time to first token).

The predict ``BatchScheduler`` itself waits for ROADMAP A5 (part 2).
"""

from __future__ import annotations

import collections
import threading
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.profiling.metrics import get_registry

# sub-second-focused edges for predict latency (the default time
# buckets are compile-scale and would put every predict in one bucket)
PREDICT_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                           0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

#: priority classes for the batch queue: an INTERACTIVE
#: request is inserted ahead of every queued BULK request, so a latency-
#: sensitive predict/generate never waits behind a bulk scorer's
#: backlog. Ordering is stable within a class (FIFO).
PRIORITIES = {"interactive": 0, "bulk": 1}


def priority_rank(priority: str) -> int:
    try:
        return PRIORITIES[priority]
    except KeyError:
        raise ValueError(f"unknown priority {priority!r}; "
                         f"one of {tuple(PRIORITIES)}") from None


def priority_insert(queue, item, *, front_of_class: bool = False) -> None:
    """Insert ``item`` (anything with a ``priority`` rank) into a
    priority-ordered deque: ahead of every lower-priority entry, FIFO
    within its class — the ONE insert discipline both batch queues
    (predict and generate) share. ``front_of_class`` puts the item
    ahead of its own class too (an evicted victim that already waited
    its turn)."""
    if front_of_class:
        idx = next((i for i, q in enumerate(queue)
                    if q.priority >= item.priority), len(queue))
        queue.insert(idx, item)
        return
    if queue and queue[-1].priority > item.priority:
        idx = next(i for i, q in enumerate(queue)
                   if q.priority > item.priority)
        queue.insert(idx, item)
    else:
        queue.append(item)


class CompileCache:
    """Cross-model compile cache with a GLOBAL entry/bytes budget,
    shared by every scheduler in the process: entries are LRU-ordered
    across models, the budget counts entries and the bytes each entry
    reports (``compiled_nbytes``), and evictions land in
    ``serving_compile_cache_evictions_total``. A model evicted from the
    server LRU drops all of its entries at once (``evict_model``)."""

    def __init__(self, max_entries: int = 128,
                 max_bytes: Optional[int] = 512 * 1024 * 1024):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # key -> (value, nbytes)
        self._bytes = 0

    @staticmethod
    def compiled_nbytes(compiled) -> int:
        """Budget-relevant footprint of one cached step: the device
        memory its CUDA graph's private pool took at capture
        (``nbytes``). Eager steps (the CPU) cost 0 bytes (the entry
        budget still bounds them)."""
        return int(getattr(compiled, "nbytes", 0))

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            return entry[0]

    def put(self, key, value, nbytes: int = 0) -> None:
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, int(nbytes))
            self._bytes += int(nbytes)
            while len(self._entries) > 1 and (
                    len(self._entries) > self.max_entries
                    or (self.max_bytes is not None
                        and self._bytes > self.max_bytes)):
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                evicted += 1
            self._publish_locked()
        if evicted:
            get_registry().counter(
                "serving_compile_cache_evictions_total",
                help="per-bucket steps evicted by the cross-model "
                     "compile-cache budget").inc(evicted)

    def _publish_locked(self) -> None:
        reg = get_registry()
        reg.gauge("serving_compile_cache_entries",
                  help="per-bucket steps resident in the cross-model "
                       "compile cache").set(len(self._entries))
        reg.gauge("serving_compile_cache_bytes",
                  help="device bytes of the per-bucket steps resident in "
                       "the cross-model compile cache").set(self._bytes)

    def remove(self, key) -> None:
        """Drop one entry (a put that lost a race with eviction)."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                self._publish_locked()

    def evict_model(self, owner: int, model_key: str) -> None:
        """Drop every entry one scheduler cached for one model key —
        called when the server LRU evicts the model."""
        with self._lock:
            for k in [k for k in self._entries
                      if k[0] == owner and k[1] == model_key]:
                self._bytes -= self._entries.pop(k)[1]
            self._publish_locked()

    def evict_owner(self, owner: int) -> None:
        """Drop every entry a (stopped) scheduler owns — owner serials
        are never reused, so a dead scheduler's executables would
        otherwise sit in the GLOBAL cache until the budget pushes them
        out."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == owner]:
                self._bytes -= self._entries.pop(k)[1]
            self._publish_locked()

    def keys(self) -> List[tuple]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}


_compile_cache_lock = threading.Lock()
_compile_cache: Optional[CompileCache] = None
_owner_serial = 0


def next_cache_owner() -> int:
    """Monotonic owner id for compile-cache keys. ``id(scheduler)``
    would be reused after garbage collection, letting a new scheduler
    hit a dead scheduler's stale executables (compiled against another
    model's shapes)."""
    global _owner_serial
    with _compile_cache_lock:
        _owner_serial += 1
        return _owner_serial


def get_compile_cache() -> CompileCache:
    """The process-global compile cache every scheduler shares — ONE
    budget across models, buckets, and predict/generate kinds."""
    global _compile_cache
    with _compile_cache_lock:
        if _compile_cache is None:
            _compile_cache = CompileCache()
        return _compile_cache


def set_compile_cache(cache: Optional[CompileCache]
                      ) -> Optional[CompileCache]:
    """Swap the global cache (tests / budget reconfiguration); returns
    the previous one."""
    global _compile_cache
    with _compile_cache_lock:
        prev, _compile_cache = _compile_cache, cache
        return prev


def quantile(ordered, q: float) -> float:
    """Nearest-rank quantile of an already-sorted sequence — the ONE
    convention the p50/p99 gauges, ``stats()``, and the bench serve
    rung all share."""
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


class _LatencyWindow:
    """Bounded reservoir of recent latencies; publishes p50/p99 gauges
    on every observation (a scrape of ``/api/metrics`` sees the current
    quantiles without histogram interpolation). The metric family is
    parameterized so the generation scheduler's TTFT window shares the
    machinery (``serving_ttft_*``) with the predict window."""

    # republish the gauges every Nth observation: a per-request sort of
    # the whole reservoir would serialize the serving hot path for
    # quantiles that only matter at scrape cadence
    REFRESH_EVERY = 16

    def __init__(self, maxlen: int = 1024,
                 hist_name: str = "serving_predict_seconds",
                 hist_help: str = "end-to-end predict latency "
                                  "(admission to response), successful "
                                  "requests",
                 gauge_prefix: str = "serving_predict",
                 gauge_what: str = "predict latency"):
        self._lock = threading.Lock()
        self._window = collections.deque(maxlen=maxlen)
        self._since_refresh = 0
        self._hist_name = hist_name
        self._hist_help = hist_help
        self._gauge_prefix = gauge_prefix
        self._gauge_what = gauge_what

    def observe(self, seconds: float) -> None:
        get_registry().histogram(
            self._hist_name, help=self._hist_help,
            buckets=PREDICT_LATENCY_BUCKETS).observe(seconds)
        with self._lock:
            self._window.append(seconds)
            self._since_refresh += 1
            refresh = (self._since_refresh >= self.REFRESH_EVERY
                       or len(self._window) == 1)
            if refresh:
                self._since_refresh = 0
        if refresh:
            self._publish(*self.quantiles())

    def _publish(self, p50: float, p99: float) -> None:
        reg = get_registry()
        reg.gauge(f"{self._gauge_prefix}_p50_ms",
                  help=f"median {self._gauge_what} over the recent "
                       "window (ms)").set(p50 * 1000.0)
        reg.gauge(f"{self._gauge_prefix}_p99_ms",
                  help=f"p99 {self._gauge_what} over the recent window "
                       "(ms)").set(p99 * 1000.0)

    def quantiles(self) -> Tuple[Optional[float], Optional[float]]:
        with self._lock:
            if not self._window:
                return None, None
            ordered = sorted(self._window)
        return quantile(ordered, 0.5), quantile(ordered, 0.99)