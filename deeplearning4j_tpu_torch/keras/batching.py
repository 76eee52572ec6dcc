"""Continuous-batching scheduler for the Keras gateway (the JAX
package's ``keras/batching.py``), with the queue and compile-cache
helpers the generation engine shares.

Predict requests admitted for the same model land in a per-model queue;
a dispatcher thread coalesces them into padded, shape-bucketed batches,
runs ONE captured step per bucket, and splits the result back to
per-request futures with the padding rows dropped.

- **Bucket** = next power-of-two row count up to ``max_batch``; the
  non-batch feature shape and dtype are exact-matched — only
  same-shaped requests coalesce. A request larger than ``max_batch``
  runs alone in its own (still cached) bucket.
- **One step runner per (model, bucket, feature shape)**, the port's
  stand-in for the JAX scheduler's AOT-compiled executables
  (:class:`PredictRunner`): on a CUDA model the container's
  ``_infer_fn()`` is captured once into a ``torch.cuda.CUDAGraph`` over
  a static input buffer and replayed for every batch; params and states
  are read in place, so a ``fit`` (whose updater writes in place) keeps
  every graph valid and current, and a runner whose tensors were
  replaced re-captures first, counted as a compile. On the CPU the
  runner is the eager ``output()`` (the JAX scheduler's "no AOT seam"
  branch): nothing is captured. A capture that fails raises; it never
  gives way to eager execution or to the CPU. Runners live in the
  budgeted cross-model :class:`CompileCache` (an entry's bytes are its
  graph's private pool) and are evicted with the server's LRU model.
- **Deadline-aware flush**: a batch flushes when it is full
  (``reason=full``), when a member's ``deadline_ms`` budget is nearly
  spent (``reason=deadline``), or when ``max_wait_ms`` elapses at low
  load (``reason=idle``).
- **Per-row nonfinite guard**: one poisoned request gets ``NONFINITE``
  alone; its batchmates are served. A *batch-level* failure (a failed
  capture included) re-runs each request ALONE through the model's
  eager ``output()`` — on the same device, through the same kernels —
  counted in ``serving_batch_fallbacks_total``, before any request
  surfaces an error.
- **Priority classes**: ``priority_rank`` / ``priority_insert`` order a
  queue ``interactive`` ahead of ``bulk``, FIFO within a class (the
  predict and the generation queues share them).

Observable: ``serving_batch_size`` histogram,
``serving_batched_requests_total`` / ``serving_batch_flushes_total``
(by flush reason) / ``serving_batch_fallbacks_total`` counters,
``serving_compile_seconds_total`` (capture time), p50/p99 predict
latency gauges (``_LatencyWindow``), and ``serve:batch`` tracer spans.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.sentinel import host_nonfinite
from deeplearning4j_tpu_torch.resilience.service import (
    Deadline, DeadlineExceeded, DrainingError, NonFiniteOutput,
)
from deeplearning4j_tpu_torch.util.math_utils import next_pow_of_2

# row-count edges for the serving_batch_size histogram (requests per
# executed batch — NOT seconds, hence not DEFAULT_TIME_BUCKETS)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# sub-second-focused edges for predict latency (the default time
# buckets are compile-scale and would put every predict in one bucket)
PREDICT_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                           0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

FLUSH_REASONS = ("full", "deadline", "idle")

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


def _default_cache_bytes() -> int:
    """The process-global cache's byte budget: the JAX package's 512 MiB
    (which counts XLA's code and scratch) without a card; on the card a
    quarter of its memory, because an entry's bytes are its graph's
    private pool, every intermediate of the step (a full-width GPT's
    32-row predict graph holds 1.46 GB, ResNet-50's 4.76 GB): 512 MiB
    would evict them as fast as they are captured."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory // 4
    return 512 * 1024 * 1024


def get_compile_cache() -> CompileCache:
    """The process-global compile cache every scheduler shares — ONE
    budget across models, buckets, and predict/generate kinds."""
    global _compile_cache
    with _compile_cache_lock:
        if _compile_cache is None:
            _compile_cache = CompileCache(max_bytes=_default_cache_bytes())
        return _compile_cache


def set_compile_cache(cache: Optional[CompileCache]
                      ) -> Optional[CompileCache]:
    """Swap the global cache (tests / budget reconfiguration); returns
    the previous one."""
    global _compile_cache
    with _compile_cache_lock:
        prev, _compile_cache = _compile_cache, cache
        return prev


def bucket_rows(rows: int) -> int:
    """The padded row count for a ``rows``-row batch: the next power of
    two. The scheduler caps COALESCED rows at ``max_batch`` before
    calling (max_batch is normalized to a power of two, so coalesced
    buckets never exceed it); a single oversize request gets its own
    larger pow2 bucket — it can never coalesce, but its runner is still
    cached."""
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    return next_pow_of_2(rows)


def _pow2_floor(n: int) -> int:
    p = next_pow_of_2(n)
    return p if p == n else p >> 1


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

class _Pending:
    """One queued predict: the request's features, its deadline, and the
    future (event + result/error) its handler thread waits on."""

    __slots__ = ("features", "deadline", "event", "result", "error",
                 "rows", "shape_key", "t0", "priority")

    def __init__(self, features: np.ndarray, deadline: Deadline,
                 priority: int = 0):
        self.features = features
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.rows = int(features.shape[0])
        # only exact non-batch shape + dtype matches may share a batch
        self.shape_key = (tuple(features.shape[1:]), str(features.dtype))
        self.t0 = time.monotonic()
        self.priority = priority


# ----------------------------------------------------------- step runners

#: One process-wide lock around every CUDA-graph capture (the predict
#: runners' and the generation engine's step runners'). A capture sizes
#: its graph's private pool by the change in ``memory_reserved`` and
#: calls ``torch.cuda.synchronize`` and ``empty_cache`` around it: two
#: captures in flight on two threads (two models' dispatchers, a
#: dispatcher and a prewarm thread or the decode loop) would count each
#: other's pools and synchronize the device while the other's stream is
#: capturing. Replays and eager work on other threads need no lock: every
#: capture runs in ``thread_local`` mode, on a stream of its own.
CAPTURE_LOCK = threading.Lock()


def _leaves(tree):
    """The tensors of a nested container of params, states or a page
    pool (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _signature(*trees) -> tuple:
    """Where each tensor a captured step reads lives: its address,
    shape, strides and dtype. A graph replays against addresses, so a
    tensor replaced since the capture shows here as a changed entry."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for tree in trees for t in _leaves(tree))


def _host(y) -> np.ndarray:
    """A model output as a float32 host array (bf16 nets answer in
    float32, as the wire does)."""
    if isinstance(y, torch.Tensor):
        return y.detach().float().cpu().numpy()
    return np.asarray(y)


class PredictRunner:
    """The predict step of one (model, bucket, feature shape), the port's
    stand-in for the JAX scheduler's AOT-compiled executable.

    - **On a CUDA model** the container's ``_infer_fn()`` is captured
      once into a ``torch.cuda.CUDAGraph`` over a static ``[bucket,
      *shape]`` input buffer, warmed up first on a side stream, with
      ``capture_error_mode="thread_local"`` (another thread's CUDA calls
      cannot invalidate it). The graph reads the params and states in
      place. A call copies the padded batch into the static buffer,
      replays the graph and returns a host copy of the output, so the
      next replay cannot overwrite what a caller holds. A call whose
      params or states no longer live where the capture found them
      re-captures first (counted by ``on_capture`` as a compile): a
      graph never replays stale weights. ``nbytes`` is the device memory
      the graph's private pool took at capture. A capture that fails
      raises.
    - **On the CPU** the call is the model's eager ``output()``; nothing
      is captured.

    Calls take ``(model, x)``: ``x`` a numpy batch of ``bucket`` rows;
    the answer is a float32 numpy array. Graph containers answer their
    first output."""

    WARMUP = 2

    def __init__(self, model, bucket: int, shape_key, on_capture=None):
        self.nbytes = 0
        self.on_capture = on_capture
        self.graphed = model.device.type == "cuda"
        self._graph = None
        if not self.graphed:
            return
        shape, _ = shape_key
        self._x = torch.zeros((int(bucket),) + tuple(shape),
                              dtype=model.dtype, device=model.device)
        self.capture(model)

    def _infer(self, fn, model):
        if hasattr(model, "layers"):          # MultiLayerNetwork
            return fn(model.params, model.states, self._x, None)
        name = model.conf.network_inputs[0]   # ComputationGraph
        return fn(model.params, model.states, {name: self._x}, None)[0]

    def capture(self, model) -> None:
        """(Re-)capture the step's graph against ``model``'s tensors."""
        t0 = time.perf_counter()
        dev = model.device
        with CAPTURE_LOCK, torch.no_grad():
            self._graph = None       # release a stale graph's pool first
            fn = model._infer_fn()
            self._x.zero_()
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for _ in range(self.WARMUP):
                    self._infer(fn, model)
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self._out = self._infer(fn, model)
            self._graph = graph
            self._sig = _signature(model.params, model.states)
            self.nbytes = max(0, torch.cuda.memory_reserved(dev) - reserved)
        model._infer_traces += 1
        if self.on_capture is not None:
            self.on_capture(time.perf_counter() - t0)

    def __call__(self, model, x) -> np.ndarray:
        if not self.graphed:
            return _host(model.output(x))
        if _signature(model.params, model.states) != self._sig:
            self.capture(model)              # tensors were replaced
        self._x.copy_(torch.from_numpy(np.ascontiguousarray(x)))
        self._graph.replay()
        return _host(self._out)


class BatchScheduler:
    """Per-server continuous-batching engine. ``submit()`` is called by
    an admitted handler thread (holding its ServiceGuard slot) and
    blocks until the request's rows come back; a per-model dispatcher
    thread forms and executes the batches. The caller resolves the
    model key ONCE at admission and threads it through — eviction or an
    LRU swap can never retarget a queued request."""

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 5.0,
                 deadline_margin_ms: float = 50.0,
                 idle_thread_s: float = 30.0,
                 compile_cache: Optional[CompileCache] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        # buckets are powers of two "up to max_batch": normalize down so
        # no bucket ever exceeds the configured cap
        self.max_batch = _pow2_floor(int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.deadline_margin_s = max(0.0, float(deadline_margin_ms)) / 1000.0
        self.idle_thread_s = idle_thread_s
        self._cond = threading.Condition()
        self._queues: Dict[str, collections.deque] = {}
        self._backends: Dict[str, tuple] = {}  # key -> (model, lock)
        self._dispatchers: Dict[str, threading.Thread] = {}
        # runners live in the budgeted CROSS-MODEL cache (global by
        # default): per-scheduler keys, one process-wide budget
        self._compiled = (compile_cache if compile_cache is not None
                          else get_compile_cache())
        self._cache_owner = next_cache_owner()
        # observed request-size mix: (shape_key, bucket) -> batches
        # executed — the speculative-prewarm signal
        self._bucket_mix: collections.Counter = collections.Counter()
        self._stopping = False
        self._stats_lock = threading.Lock()
        self.compile_s = 0.0
        self.compiles = 0       # runners built + graphs (re-)captured
        self._batch_sizes: collections.Counter = collections.Counter()
        self.latency = _LatencyWindow()

    # ------------------------------------------------------------- metrics
    @staticmethod
    def _flush_counter(reason: str):
        return get_registry().labeled_counter(
            "serving_batch_flushes_total",
            help="batches dispatched, by flush reason").labels(
                reason=reason)

    # -------------------------------------------------------------- submit
    def submit(self, key: str, model, lock: threading.Lock,
               features: np.ndarray, deadline: Deadline,
               priority: str = "interactive") -> np.ndarray:
        """Queue one predict for ``key`` and block until its rows are
        back. Raises the request's own structured error (DEADLINE /
        NONFINITE / the singleton re-execution's failure).
        ``priority``: queue class — an ``interactive`` request is
        inserted ahead of every queued ``bulk`` request."""
        features = np.asarray(features)
        if features.ndim < 1 or features.shape[0] < 1:
            raise ValueError(
                f"predict features must have a leading batch axis with "
                f">= 1 rows, got shape {features.shape}")
        deadline.check("predict enqueue")
        pending = _Pending(features, deadline, priority_rank(priority))
        with self._cond:
            if self._stopping:
                raise DrainingError("batch scheduler stopped")
            # the model/lock pair travels with the KEY, pinned by the
            # caller for the life of this op: a cache swap mid-queue
            # cannot retarget the request
            self._backends[key] = (model, lock)
            queue = self._queues.setdefault(key, collections.deque())
            priority_insert(queue, pending)
            worker = self._dispatchers.get(key)
            if worker is None or not worker.is_alive():
                worker = threading.Thread(
                    target=self._dispatch_loop, args=(key,), daemon=True,
                    name=f"batch-dispatch-{len(self._dispatchers)}")
                self._dispatchers[key] = worker
                worker.start()
            self._cond.notify_all()
        while not pending.event.is_set():
            remaining = deadline.remaining()
            timeout = 5.0 if remaining is None else max(0.0,
                                                        remaining) + 0.05
            if pending.event.wait(timeout):
                break
            # budget gone while the batch is still in flight: report
            # DEADLINE now; the dispatcher completes (and discards) the
            # orphan later. No-deadline requests loop until completion.
            deadline.check("predict batched dispatch")
        if pending.error is not None:
            raise pending.error
        if pending.result is None:  # stop() raced the wait
            raise DrainingError("batch scheduler stopped")
        return pending.result

    # ----------------------------------------------------------- dispatcher
    def _dispatch_loop(self, key: str) -> None:
        idle_until = time.monotonic() + self.idle_thread_s
        while True:
            with self._cond:
                queue = self._queues.get(key)
                while not self._stopping and not queue:
                    left = idle_until - time.monotonic()
                    if left <= 0:
                        # nothing queued for a while: retire the thread
                        # and its empty queue (a later submit recreates
                        # both — without this a long-lived server leaks
                        # a deque per model key ever served)
                        if (self._dispatchers.get(key)
                                is threading.current_thread()):
                            del self._dispatchers[key]
                            if not self._queues.get(key):
                                self._queues.pop(key, None)
                        return
                    self._cond.wait(left)
                    queue = self._queues.get(key)
                if self._stopping:
                    # queue may be None here: stop() can race the idle
                    # retirement above
                    for p in (queue or ()):
                        p.error = DrainingError("batch scheduler stopped")
                        p.event.set()
                    if queue is not None:
                        queue.clear()
                    return
                batch, reason = self._form_batch(queue)
            try:
                self._execute(key, batch, reason)
            except Exception as e:  # noqa: BLE001 — the dispatcher must
                # survive anything: a dead dispatcher would strand every
                # queued request behind a still-alive-looking thread
                for p in batch:
                    if not p.event.is_set():
                        p.error = e
                        p.event.set()
            idle_until = time.monotonic() + self.idle_thread_s

    def _form_batch(self, queue) -> Tuple[List[_Pending], str]:
        """Collect one flushable batch from ``queue`` (held lock).
        Blocks on the condition while the flush conditions say wait."""
        while True:
            head = queue[0]
            batch, rows = [], 0
            for p in queue:
                if p.shape_key != head.shape_key:
                    continue  # different feature shape: a later batch
                if batch and rows + p.rows > self.max_batch:
                    break  # bucket capacity; an oversize HEAD runs alone
                batch.append(p)
                rows += p.rows
            if rows >= self.max_batch:
                reason = "full"
            else:
                now = time.monotonic()
                wait_idle = (head.t0 + self.max_wait_s) - now
                wait_deadline = float("inf")
                for p in batch:
                    remaining = p.deadline.remaining()
                    if remaining is not None:
                        wait_deadline = min(
                            wait_deadline,
                            remaining - self.deadline_margin_s)
                wait = min(wait_idle, wait_deadline)
                if wait > 0:
                    self._cond.wait(wait)
                    if self._stopping:
                        # the outer loop fails the queue; flush nothing
                        return [], "idle"
                    continue  # re-collect: new arrivals may have landed
                reason = "deadline" if wait_deadline < wait_idle else "idle"
            for p in batch:
                queue.remove(p)
            return batch, reason

    # ------------------------------------------------------------ execution
    def _execute(self, key: str, batch: List[_Pending],
                 reason: str) -> None:
        # members whose WHOLE budget is already gone get DEADLINE
        # without paying for execution (their submitters have raised
        # and left). No counter here: the submitter's own
        # deadline.check already counted.
        live = []
        for p in batch:
            if p.deadline.expired():
                p.error = DeadlineExceeded("predict: batch member "
                                           "expired before dispatch")
                p.event.set()
            else:
                live.append(p)
        batch = live
        if not batch:
            return
        with self._cond:
            backend = self._backends.get(key)
        if backend is None:
            # every queued request pins its model, so a missing backend
            # means only orphans remained and the LRU moved on — fail
            # them cleanly instead of KeyError-ing the dispatcher
            for p in batch:
                p.error = DrainingError(f"model {key!r} evicted with "
                                        "only abandoned requests queued")
                p.event.set()
            return
        model, lock = backend
        rows = sum(p.rows for p in batch)
        bucket = bucket_rows(rows)
        shape_key = batch[0].shape_key
        tracer = get_tracer()
        with tracer.span("serve:batch", model=key, size=len(batch),
                         rows=rows, bucket=bucket, reason=reason):
            # slow_batch chaos seam: stall THIS batch (outside every
            # lock — a stalled batch must not freeze the scheduler)
            faultinject.on_batch_dispatch(key)
            x = np.concatenate([p.features for p in batch], axis=0)
            if bucket > rows:
                pad = np.zeros((bucket - rows,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad], axis=0)
            try:
                runner = self._runner(key, model, bucket, shape_key)
                with lock:  # predict and fit on one model never interleave
                    y = runner(model, x)[:rows]
            except Exception:  # noqa: BLE001 — isolate batchmates
                # batch-level failure (a failed capture, a device
                # fault): re-execute each request ALONE before surfacing
                # anything — only a request that fails by itself may
                # charge the caller's circuit breaker
                get_registry().counter(
                    "serving_batch_fallbacks_total",
                    help="batches that fell back to singleton "
                         "re-execution after a batch-level failure").inc()
                self._singleton_fallback(model, lock, batch)
                self._account(batch, reason)
                return
            offset = 0
            for p in batch:
                self._finish_rows(p, y[offset:offset + p.rows])
                offset += p.rows
        self._account(batch, reason)

    def _singleton_fallback(self, model, lock,
                            batch: List[_Pending]) -> None:
        for p in batch:
            try:
                with lock:
                    y = _host(model.output(p.features))
                self._finish_rows(p, y)
            except Exception as e:  # noqa: BLE001 — per-request verdict
                p.error = e
                p.event.set()

    def _finish_rows(self, p: _Pending, y: np.ndarray) -> None:
        """Per-ROW sentinel: a poisoned request fails alone — its
        batchmates' rows are served."""
        if host_nonfinite(y):
            get_registry().counter(
                "serving_nonfinite_outputs_total",
                help="predictions refused because the model output "
                     "carried NaN/Inf").inc()
            p.error = NonFiniteOutput("prediction contains NaN/Inf")
        else:
            p.result = y
        p.event.set()

    def _account(self, batch: List[_Pending], reason: str) -> None:
        reg = get_registry()
        reg.histogram("serving_batch_size",
                      help="requests coalesced per executed batch",
                      buckets=BATCH_SIZE_BUCKETS).observe(len(batch))
        reg.counter("serving_batched_requests_total",
                    help="predict requests served through the "
                         "batching scheduler").inc(len(batch))
        self._flush_counter(reason).inc()
        with self._stats_lock:
            self._batch_sizes[len(batch)] += 1
            rows = sum(p.rows for p in batch)
            self._bucket_mix[(batch[0].shape_key,
                              bucket_rows(rows))] += 1

    # ------------------------------------------------------- compile cache
    def _count_compile(self, elapsed: float) -> None:
        """Count one runner built or graph (re-)captured, and its
        seconds."""
        get_registry().counter(
            "serving_compile_seconds_total",
            help="seconds spent capturing per-bucket predict steps "
                 "(building the eager runner on the CPU)").inc(elapsed)
        with self._stats_lock:
            self.compile_s += elapsed
            self.compiles += 1

    def _runner(self, key: str, model, bucket: int, shape_key):
        """The step runner for (model key, bucket, feature shape) —
        built once, reused until the model is evicted. Runners take
        ``(model, x)`` and re-capture when the model's tensors moved, so
        a fit or an evict-and-reload of the same key can never serve
        stale weights from a cache hit."""
        cache_key = (self._cache_owner, key, bucket, shape_key)
        runner = self._compiled.get(cache_key)
        if runner is not None:
            return runner
        t0 = time.perf_counter()
        runner, nbytes = self._aot_compile(model, bucket, shape_key)
        if not runner.graphed:       # a capture counts itself
            self._count_compile(time.perf_counter() - t0)
        with self._cond:
            current = self._backends.get(key)
            if (current is not None and current[0] is model
                    and not self._stopping):
                # put UNDER the cond: an evict_model racing between the
                # check and the put could otherwise land a stale runner
                # for a gone model (the cache's own lock is a leaf — no
                # path nests it around the cond)
                self._compiled.put(cache_key, runner, nbytes)
            # else: the key was evicted (or swapped to a fresh load)
            # while we captured — serve this batch with the uncached
            # runner and let the next batch capture against the
            # current object, rather than caching for a gone model. A
            # stopped scheduler caches nothing: its stop() released its
            # slice of the global cache, and a capture that outlived the
            # stop's join (a killed replica's dispatcher waiting on
            # CAPTURE_LOCK) must not put a dead owner's pool back
        return runner

    def _aot_compile(self, model, bucket: int, shape_key):
        """Build the (model, bucket, shape) runner: a CUDA graph of the
        container's ``_infer_fn()`` on a CUDA model, its eager
        ``output()`` on the CPU (:class:`PredictRunner`). Returns
        ``(runner, bytes)`` — the bytes (the graph's private pool)
        charge the cross-model compile-cache budget. Unlike the JAX
        scheduler's AOT step, which falls back to jit on any failure, a
        capture that fails raises."""
        runner = PredictRunner(model, bucket, shape_key,
                               on_capture=self._count_compile)
        return runner, CompileCache.compiled_nbytes(runner)

    # ----------------------------------------------------------- prewarming
    def prewarm(self, key: str, model, top: int = 4) -> int:
        """Speculatively build the ``top`` most-observed (feature shape,
        bucket) runners for a freshly loaded model, so the first real
        wave against it pays zero captures. The signal is the
        scheduler's OBSERVED request-size mix across every model it has
        served (traffic shape is a gateway property, not a model
        property). Returns the number of buckets built; call from a
        background thread — captures are slow."""
        with self._stats_lock:
            mix = self._bucket_mix.most_common()
        done = 0
        # pin the backend so _runner may cache against it — but
        # remember OUR insertion: if the server LRU evicts this model
        # while we capture and no request re-registers it, the pin
        # must come back out or the dead model object leaks in
        # _backends forever
        pin = (model, threading.Lock())
        with self._cond:
            if self._stopping:
                return 0
            pinned = key not in self._backends
            if pinned:
                self._backends[key] = pin
        try:
            for (shape_key, bucket), _ in mix:
                if done >= top:
                    break
                cache_key = (self._cache_owner, key, bucket, shape_key)
                if self._compiled.get(cache_key) is not None:
                    continue
                with self._cond:
                    if self._stopping:
                        break
                try:
                    self._runner(key, model, bucket, shape_key)
                except Exception:  # noqa: BLE001 — speculative: another
                    # model's traffic shape may not fit this model; a
                    # real request for a bucket that failed here builds
                    # it again and its failure is its own
                    continue
                done += 1
        finally:
            if pinned:
                with self._cond:
                    if (self._backends.get(key) is pin
                            and not self._queues.get(key)):
                        self._backends.pop(key)
        if done:
            get_registry().counter(
                "serving_prewarmed_buckets_total",
                help="predict buckets captured speculatively from the "
                     "observed request-size mix").inc(done)
        return done

    # ------------------------------------------------------------ lifecycle
    def evict_model(self, key: str) -> None:
        """Drop the runner cache for an evicted model — the cache is
        keyed like the server's LRU and dies with it. Purge and
        backend-pop happen under ONE cond hold so they serialize against
        _runner's check-and-put."""
        with self._cond:
            self._compiled.evict_model(self._cache_owner, key)
            self._backends.pop(key, None)
            if not self._queues.get(key):  # drop the empty deque too
                self._queues.pop(key, None)

    def stop(self, grace_s: float = 5.0) -> None:
        """Fail queued work with DRAINING, wake and join dispatchers;
        release this scheduler's slice of the global compile cache."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            workers = list(self._dispatchers.values())
        for w in workers:
            w.join(grace_s)
        self._compiled.evict_owner(self._cache_owner)

    def stats(self) -> dict:
        """Per-scheduler serve stats: capture seconds and count, the
        batch-size mix, the (shape, bucket) mix and the latency
        quantiles."""
        p50, p99 = self.latency.quantiles()
        with self._stats_lock:
            return {
                "compile_s": round(self.compile_s, 3),
                "compiles": self.compiles,
                "batch_size_mix": {str(k): v for k, v in
                                   sorted(self._batch_sizes.items())},
                "bucket_mix": {f"{s[0]}:{s[1]}:{b}": n for (s, b), n in
                               sorted(self._bucket_mix.items())},
                "p50_ms": None if p50 is None else round(p50 * 1000, 2),
                "p99_ms": None if p99 is None else round(p99 * 1000, 2),
            }
