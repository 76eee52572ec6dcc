"""Keras-backend gateway server (the JAX package's ``keras/server.py``).

Ref: deeplearning4j-keras/.../Server.java:15-22 (py4j GatewayServer
exposing DeepLearning4jEntryPoint to a Python Keras client),
DeepLearning4jEntryPoint.java (fit(model, train dirs, epochs)), and
HDF5MiniBatchDataSetIterator.java (one file per minibatch in a
directory). An external process drives training and inference over a
socket, with a newline-delimited JSON-over-TCP protocol:

    {"op": "fit", "model": <.zip path>, "features_dir": ...,
     "labels_dir": ..., "nb_epoch": N}
    {"op": "predict", "features": <.npy path>}  -> {"predictions": [...]}
    {"op": "evaluate", "features_dir": ..., "labels_dir": ...}
    {"op": "generate", "model": <gpt .zip>, "tokens": [ids...],
     "max_new_tokens": N, "sampling": {"temperature": t, "seed": s}}
    {"op": "health"}  -> {"live": true, "ready": ..., "reasons": [...]}
    {"op": "readyz"}  -> structured readiness (guard state, checks, open
                         breakers, inflight/queued depth, TTFT p99)
    {"op": "debug"}   -> the live diagnostic bundle
    {"op": "shutdown"}

A ``generate`` request may add ``"stream": true``: each generated token
is written as its own ``{"partial": true, "t": tok}`` line the moment
the decode loop produces it, before the final envelope.

Every request may carry ``deadline_ms`` (the server default applies
otherwise; <= 0 disables) and ``priority`` (``interactive`` or
``bulk``). Requests admit through a ``resilience/service.py``
``ServiceGuard``: past the bounded queue they are shed with ``{"error":
"SHED", ...}``, blown budgets return ``DEADLINE``, a per-model circuit
breaker fails fast with ``BREAKER_OPEN`` + ``retry_after_ms`` after
consecutive failures, and a nonfinite prediction is refused
(``NONFINITE``) per row, so one poisoned request never fails its
batchmates.

Predicts go through the continuous-batching scheduler
(``keras/batching.py``): on the card each (model, bucket, feature shape)
runs as one CUDA graph over the container's ``_infer_fn()`` (the
char-RNN's graphs replay the LSTM kernel K1, the GPT's the attention
kernel K4), on the CPU as the eager ``output()``. ``batching=False``
restores the one-request = one-dispatch path. Generations go through the
token-level engine (``keras/generation.py``).

Where the port differs from the JAX gateway:

- ``device=None`` (the default) serves on the card and raises without
  one; ``device="cpu"`` serves on the CPU. The device is handed to
  ``ModelSerializer.restore_model``.
- A ``.zip`` model restores through ``ModelSerializer``; any other model
  path imports through ``KerasModelImport.import_keras_model_and_weights``
  (a Keras ``.h5`` or ``.keras`` file), on the server's device. Batch
  files are ``.npy`` or ``.h5``: an ``.h5`` file holds one array, its
  first dataset under ``/`` in name order, read by the port's own HDF5
  reader (the JAX gateway's ``.h5`` path calls a method its reader lacks
  and raises, ROADMAP C17). ``tuned=`` (an ``autotune.TunedConfig``)
  sets ``max_batch`` to the tuned bucket set's top, as in the JAX
  gateway.
- A ``fit`` answers the last minibatch's ``score_value`` on either
  container (the JAX gateway's ``score()`` takes no data on a
  ``MultiLayerNetwork`` only).
"""

from __future__ import annotations

import collections
import json
import socket
import socketserver
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.keras.batching import BatchScheduler, _host
from deeplearning4j_tpu_torch.keras.generation import GenerationScheduler
from deeplearning4j_tpu_torch.keras.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.keras.keras_import import KerasModelImport
from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.profiling.watchdog import (
    assemble_bundle, beat as watchdog_beat,
)
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.sentinel import host_nonfinite
from deeplearning4j_tpu_torch.resilience.service import (
    BreakerOpen, Deadline, DeadlineExceeded, NonFiniteOutput, ServiceError,
    ServiceGuard, register_guard, unregister_guard,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer


def _load_array(path: Path) -> np.ndarray:
    """A batch file's array: ``.npy``, or an ``.h5`` file's first dataset
    under ``/`` in name order (one array per file)."""
    if path.suffix == ".npy":
        return np.load(path)
    with Hdf5Archive(str(path)) as h5:
        names = sorted(n for k, n in h5.list_children("/") if k == "d")
        if not names:
            raise ValueError(f"{path}: no datasets")
        return h5.read_dataset("/" + names[0])


class HDF5MiniBatchDataSetIterator(DataSetIterator):
    """One file per minibatch, features/labels in parallel directories,
    loaded lazily per next() — the dataset need not fit in RAM
    (ref: HDF5MiniBatchDataSetIterator.java)."""

    def __init__(self, features_dir: str, labels_dir: str):
        self._f_files = sorted(p for p in Path(features_dir).iterdir()
                               if p.suffix in (".npy", ".h5"))
        self._l_files = sorted(p for p in Path(labels_dir).iterdir()
                               if p.suffix in (".npy", ".h5"))
        if len(self._f_files) != len(self._l_files):
            raise ValueError(f"{len(self._f_files)} feature files vs "
                             f"{len(self._l_files)} label files")
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._f_files)

    def next(self) -> DataSet:
        f, l = self._f_files[self._pos], self._l_files[self._pos]
        self._pos += 1
        return DataSet(_load_array(f).astype(np.float32),
                       _load_array(l).astype(np.float32))

    def batch_size(self):
        if not self._f_files:
            return 0
        return int(_load_array(self._f_files[0]).shape[0])


class _DeadlineGatedIterator(DataSetIterator):
    """Wraps a DataSetIterator so a fit/evaluate checks its deadline
    budget before every batch — the "next safe seam": the model's
    parameters are only ever abandoned at a batch boundary, never
    mid-update."""

    def __init__(self, it: DataSetIterator, deadline: Deadline,
                 what: str):
        self._it = it
        self._deadline = deadline
        self._what = what

    def async_supported(self):
        # NEVER let a prefetching iterator wrap this: its thread would
        # drain next() (and every deadline check) ahead of training,
        # turning the per-batch seam into a no-op
        return False

    def reset(self):
        self._it.reset()

    def has_next(self):
        return self._it.has_next()

    def next(self):
        self._deadline.check(self._what)
        return self._it.next()

    def batch_size(self):
        return self._it.batch_size()


class KerasServer:
    """The gateway. A loaded model is cached per model path (bounded
    LRU, ``keep_models``); ``fit`` / ``predict`` / ``evaluate`` operate
    on it under a per-model lock (a concurrent fit and predict on the
    same model must never interleave a half-updated parameter tree).
    Runs in a daemon thread.

    Hardened edge: every op admits through a ``ServiceGuard`` (bounded
    concurrency + queue, load shedding, per-model circuit breaker,
    deadline budgets, graceful ``drain``); the handler socket carries an
    idle/slow-loris timeout so a dribbling client cannot park a thread
    forever.

    ``device``: where models load and run — ``None`` (the default) is the
    card, and the constructor raises without one; ``"cpu"`` runs the
    plain versions. ``tuned``: an ``autotune.TunedConfig`` whose top
    serving bucket becomes ``max_batch`` unless that is given."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_concurrency: int = 4, queue_depth: int = 8,
                 default_deadline_ms: Optional[float] = 300_000.0,
                 max_queue_wait_s: float = 5.0, keep_models: int = 4,
                 breaker_failures: int = 5,
                 breaker_cooldown_base: float = 0.5,
                 breaker_cooldown_max: float = 30.0,
                 breaker_slow_call_s: float = 30.0,
                 io_timeout: float = 60.0, batching: bool = True,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 batch_deadline_margin_ms: float = 50.0,
                 kv_cache_budget_bytes: Optional[int] = None,
                 kv_page_len: Optional[int] = None,
                 prewarm: bool = True,
                 tuned=None,
                 preload: Optional[List[str]] = None,
                 replica_rank: Optional[int] = None,
                 device=None):
        # tuned= (an autotune.TunedConfig): the batching scheduler adopts
        # the tuned serving bucket set, its top bucket the max_batch; an
        # explicit non-default max_batch wins
        if tuned is not None and max_batch == 32:
            max_batch = tuned.serve_max_batch
        self._device = resolve_device(device)
        self._batcher = (BatchScheduler(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            deadline_margin_ms=batch_deadline_margin_ms)
            if batching and max_batch > 0 else None)
        # token-level generation engine: decode row buckets cap at the
        # same max_batch; kv_cache_budget_bytes bounds the block-paged KV
        # POOL (page-granular eviction past it), kv_page_len overrides
        # the per-model page size
        self._gen = GenerationScheduler(
            max_rows=max(1, max_batch),
            cache_budget_bytes=kv_cache_budget_bytes,
            kv_page_len=kv_page_len,
            prewarm_decode_ladder=prewarm)
        self._prewarm = prewarm
        self._models = collections.OrderedDict()  # path -> model (LRU)
        self._model_locks = {}  # path -> per-model op lock
        self._model_pins = {}  # path -> in-flight ops (pinned != evictable)
        self._keep_models = max(1, int(keep_models))
        # handler threads (ThreadingTCPServer) share _models/_last; without
        # the lock a predict that omits 'model' could resolve _last mid-swap
        # from another connection and run against the wrong model
        self._state_lock = threading.Lock()
        # fleet-replica identity: when set, admitted requests
        # consult the kill/partition/slow_replica chaos kinds, and
        # hard_kill() becomes reachable. None = standalone server.
        self._replica_rank = (None if replica_rank is None
                              else int(replica_rank))
        #: optional hook invoked FIRST by hard_kill (the FleetReplica
        #: wires its heartbeat stop here so liveness dies with the
        #: listener, exactly as process death would take both)
        self.on_hard_kill = None
        self._kill_lock = threading.Lock()
        self._killed = False
        # established handler sockets — hard_kill() severs them so
        # clients mid-request see a dead connection, not a late answer
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        # in-flight speculative prewarm threads; readiness ("prewarm"
        # check) requires this back at zero, so a fleet router admits a
        # joiner only after its buckets are captured
        self._prewarm_inflight = 0
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            timeout = io_timeout  # reclaims slow-loris/idle threads

            def setup(self):
                super().setup()
                with outer._conns_lock:
                    outer._conns.add(self.connection)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.connection)
                super().finish()

            def _stream_writer(self):
                """A per-request partial-line writer for streaming
                generate: each generated token goes on the wire as
                ``{"partial": true, "t": tok}`` the moment the decode
                loop produces it. The lock serializes the decode-loop
                writes against the handler's final response; close()
                fences the stream shut (any later token raises into
                ``push_token``, which just unhooks)."""
                lock = threading.Lock()
                state = {"open": True}

                def on_token(tok):
                    if outer._replica_rank is not None and \
                            faultinject.check_kill_replica_token(
                                outer._replica_rank):
                        outer.hard_kill()  # mid-stream death, by schedule
                    with lock:
                        if not state["open"]:
                            raise RuntimeError("stream closed")
                        self.wfile.write((json.dumps(
                            {"partial": True, "t": int(tok)})
                            + "\n").encode())
                        self.wfile.flush()

                def close():
                    with lock:
                        state["open"] = False

                return on_token, close

            def handle(self):
                try:
                    for line in self.rfile:
                        closer = None
                        try:
                            req = json.loads(line)
                            on_token = None
                            if req.get("op") == "generate" \
                                    and req.get("stream"):
                                on_token, closer = self._stream_writer()
                            resp = outer._dispatch(req, on_token=on_token)
                        except ServiceError as e:  # structured
                            resp = e.to_response()
                        except Exception as e:  # report, keep serving
                            resp = {"error": f"{type(e).__name__}: {e}"}
                        if closer is not None:
                            closer()  # no partial may trail the final line
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                        if isinstance(resp, dict) and resp.get("shutdown"):
                            threading.Thread(target=outer.stop,
                                             daemon=True).start()
                            return
                except TimeoutError:
                    # dribbled (slow-loris) or idle connection timed
                    # out: count it, reclaim the thread cleanly. NOT
                    # serving_deadline_exceeded_total — no admitted
                    # request's budget ran out; a well-behaved client
                    # parking an idle keep-alive must not trip
                    # deadline alerts
                    get_registry().counter(
                        "serving_idle_timeouts_total",
                        help="connections closed after the handler "
                             "socket idle/slow-loris timeout").inc()
                    return
                except OSError:
                    return  # client vanished mid-line

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = host, self._server.server_address[1]
        self._guard = register_guard(ServiceGuard(
            f"keras_server_{self.port}", max_concurrency=max_concurrency,
            queue_depth=queue_depth,
            default_deadline_ms=default_deadline_ms,
            max_queue_wait_s=max_queue_wait_s,
            breaker_failures=breaker_failures,
            breaker_cooldown_base=breaker_cooldown_base,
            breaker_cooldown_max=breaker_cooldown_max,
            breaker_slow_call_s=breaker_slow_call_s))
        self._guard.add_ready_check("model_loaded",
                                    lambda: bool(self._models))
        self._guard.add_ready_check("prewarm",
                                    lambda: self._prewarm_inflight == 0)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        # preload= (fleet joiners): load + pin-warm the named models
        # synchronously, so by the time the constructor returns only the
        # background bucket prewarms separate this server from ready —
        # and the "prewarm" check holds readiness until they land
        for path in (preload or []):
            self._get_model(path)
            self._unpin(path)

    # -- ops ----------------------------------------------------------
    def _resolve_key(self, path: Optional[str]) -> str:
        """The model-cache / breaker key for a request, WITHOUT loading
        anything (the breaker must be consulted before a possibly
        expensive/failing load)."""
        with self._state_lock:
            if path is not None:
                return path
            if not self._models:
                raise ValueError("no model loaded; pass 'model'")
            if self._last not in self._models:  # evicted since last use
                self._last = next(reversed(self._models))
            return self._last

    def _get_model(self, key: str):
        """(model, per-model lock) for ``key``, loading and LRU-caching
        on miss, and PINNING the entry: the LRU never evicts a pinned
        model (an in-flight op keeps its model — and its lock identity —
        resident; checking ``lock.locked()`` instead would race the
        window between returning the lock and acquiring it). Callers
        must ``_unpin(key)`` when the op finishes."""
        with self._state_lock:
            if key not in self._models:
                # container-agnostic: MLN or ComputationGraph
                if key.endswith(".zip"):
                    model = ModelSerializer.restore_model(
                        key, device=self._device)
                else:
                    model = (KerasModelImport
                             .import_keras_model_and_weights(
                                 key, device=self._device))
                self._models[key] = model
                if self._prewarm and self._batcher is not None:
                    # speculative bucket prewarming: capture the
                    # observed-mix buckets for the fresh model in the
                    # background, so its first wave pays zero captures
                    # (counted in-flight — readiness waits for it)
                    self._prewarm_inflight += 1
                    threading.Thread(
                        target=self._prewarm_buckets, args=(key, model),
                        daemon=True, name="bucket-prewarm").start()
            self._models.move_to_end(key)
            self._model_pins[key] = self._model_pins.get(key, 0) + 1
            while len(self._models) > self._keep_models:
                victim = next(
                    (p for p in self._models
                     if not self._model_pins.get(p)), None)
                if victim is None:
                    break  # everything older is mid-op; over-stay
                del self._models[victim]
                self._model_locks.pop(victim, None)
                if self._batcher is not None:  # runners die with the LRU
                    self._batcher.evict_model(victim)
                self._gen.evict_model(victim)
                get_registry().counter(
                    "serving_models_evicted_total",
                    help="models evicted from the KerasServer LRU "
                         "cache").inc()
            self._last = key
            lock = self._model_locks.setdefault(key, threading.Lock())
            return self._models[key], lock

    def _prewarm_buckets(self, key: str, model) -> None:
        try:
            self._batcher.prewarm(key, model)
        finally:
            with self._state_lock:
                self._prewarm_inflight -= 1

    def _unpin(self, key: str) -> None:
        with self._state_lock:
            n = self._model_pins.get(key, 0) - 1
            if n <= 0:
                self._model_pins.pop(key, None)
            else:
                self._model_pins[key] = n

    def _dispatch(self, req: dict, on_token=None) -> dict:
        op = req.get("op")
        if op == "health":
            # never admitted/queued: a health probe must answer even
            # (especially) when the server is saturated or draining
            ready, reasons = self._guard.ready()
            return {"ok": True, "live": True, "ready": ready,
                    "reasons": reasons, "draining": self._guard.draining}
        if op == "readyz":
            # the structured readiness surface: everything a fleet router needs to gate admission and score dispatch —
            # never admitted, so it answers while saturated or draining
            return self._readyz()
        if op == "debug":
            # the live diagnostic bundle — like health, never admitted:
            # the whole point is answering while the server is wedged
            return {"ok": True, "bundle": json.loads(json.dumps(
                assemble_bundle(reason="live"), default=repr))}
        if op == "shutdown":
            return {"ok": True, "shutdown": True}
        if op not in ("fit", "predict", "evaluate", "generate"):
            raise ValueError(f"unknown op {op!r}")
        if self._replica_rank is not None:
            # fleet chaos seams: slow_replica stalls this request,
            # partition_replica opens this rank's heartbeat-suppression
            # window, kill_replica hard-kills the whole server (probes
            # above never reach here, so at_call stays predictable
            # under router readyz polling)
            stall, kill = faultinject.on_replica_request(
                self._replica_rank)
            if stall > 0:
                time.sleep(stall)
            if kill:
                self.hard_kill()
                raise OSError("replica hard-killed by fault schedule")
        # resolve the model name ONCE, at admission — a predict without
        # 'model' must not re-read _last after queueing (an LRU swap or
        # eviction mid-queue could silently retarget the request); the
        # resolved key travels with the request from here on
        key = self._resolve_key(req.get("model"))
        deadline = self._guard.deadline(req)
        t_req = time.perf_counter()
        with self._guard.admit(deadline):
            watchdog_beat("keras_server")
            flight_record("keras_server", "dispatch", op=op, model=key)
            with get_tracer().span(f"serve:{op}"):
                resp = self._serve(op, req, deadline, key,
                                   on_token=on_token)
        if op == "predict" and self._batcher is not None:
            # p50/p99 over served predictions (admission queue included
            # — this is the latency a client actually observes)
            self._batcher.latency.observe(time.perf_counter() - t_req)
        return resp

    def _readyz(self) -> dict:
        """Aggregate ServiceGuard + model/prewarm state into one
        machine-readable readiness record — the router's admission gate
        AND its per-replica load signal (inflight/queued/TTFT), which
        matters because in-process replicas share the global metrics
        registry: per-replica numbers must come from HERE, not from
        shared gauges."""
        ready, reasons = self._guard.ready()
        with self._state_lock:
            models = list(self._models)
            prewarm_done = self._prewarm_inflight == 0
        stats = self._gen.stats()
        return {"ok": True, "ready": ready, "reasons": reasons,
                "draining": self._guard.draining,
                "checks": {"model_loaded": bool(models),
                           "prewarm_done": prewarm_done},
                "open_breakers": self._guard.open_breakers(),
                "inflight": self._guard.inflight,
                "queued": self._guard.queued,
                "ttft_p99_ms": stats.get("ttft_p99_ms"),
                "models": models}

    def _serve(self, op: str, req: dict, deadline: Deadline,
               key: str, on_token=None) -> dict:
        # a budget already blown in the admission queue says nothing
        # about the backend — and checking BEFORE _prepare avoids
        # loading the whole input from disk for a doomed request
        deadline.check(f"{op} before dispatch")
        # client-side input validation/loading happens BEFORE the
        # breaker scope: a typo'd features path or mismatched batch
        # dirs is the CLIENT's failure and must not open the circuit
        # for a healthy model
        payload = self._prepare(op, req, deadline)
        breaker = self._guard.breaker(key)
        if not breaker.allow():
            raise BreakerOpen(f"model {key!r}: circuit open",
                              retry_after_ms=breaker.retry_after_ms())
        pinned = False
        t0 = time.monotonic()
        try:
            # model load IS backend scope: an unloadable model path
            # should trip its breaker
            model, lock = self._get_model(key)
            pinned = True
            faultinject.on_backend_dispatch(op)
            priority = str(req.get("priority", "interactive"))
            if op == "generate":
                # token-level continuous batching: this request joins
                # the model's running decode batch and leaves when its
                # generation completes; its verdict is its OWN (a
                # poisoned row fails alone mid-stream)
                out = self._gen.submit(
                    key, model, lock, payload,
                    int(req.get("max_new_tokens", 16)), deadline,
                    priority=priority, on_token=on_token,
                    sampling=req.get("sampling"))
                resp = {"ok": True, **out}
            elif op == "predict" and self._batcher is not None:
                # continuous batching: coalesce with concurrent
                # predicts on this model; the scheduler runs one
                # captured step per bucket under the model lock
                # and raises this request's OWN verdict (a batch-level
                # failure is re-tried singleton first)
                y = self._batcher.submit(key, model, lock, payload,
                                         deadline, priority=priority)
                resp = {"ok": True, "predictions": y.tolist()}
            else:
                with lock:
                    resp = self._run_op(op, req, payload, model,
                                        deadline)
            # post-hoc budget check: the op itself cannot be cancelled
            # mid-kernel, so a blown budget is detected at this seam
            # and the (late) result withheld
            deadline.check(f"{op} after dispatch")
        except DeadlineExceeded:
            # a blown CLIENT budget opens the shared breaker only when
            # the backend was genuinely slow (dispatch ran at least the
            # guard's slow-call threshold) — an impatient deadline_ms
            # must not fail-fast everyone else's healthy model
            if (time.monotonic() - t0
                    >= self._guard.breaker_slow_call_s):
                breaker.record_failure()
            raise
        except NonFiniteOutput:
            # a NaN/Inf prediction is a CLIENT-INPUT failure (poisoned
            # features on a healthy model): refuse the row, never open
            # the shared circuit for its batchmates or anyone else
            raise
        except Exception:
            breaker.record_failure()
            raise
        finally:
            if pinned:
                self._unpin(key)
        breaker.record_success()
        return resp

    def _prepare(self, op: str, req: dict, deadline: Deadline):
        """Load/validate the request's inputs (not the model)."""
        if op == "generate":
            # prompt token ids, inline in the request envelope (a
            # prompt is tiny next to a feature batch)
            tokens = req.get("tokens")
            if not tokens or not isinstance(tokens, (list, tuple)):
                raise ValueError("generate needs 'tokens': [ids...]")
            return np.asarray(tokens, np.int32)
        if op == "predict":
            x = _load_array(Path(req["features"])).astype(np.float32)
            # poison_row chaos seam: NaN-poison ONE request's features
            # so the per-row sentinel's batchmate isolation is provable
            return faultinject.poison_predict(x)
        return _DeadlineGatedIterator(
            HDF5MiniBatchDataSetIterator(req["features_dir"],
                                         req["labels_dir"]),
            deadline, f"{op} batch")

    def _run_op(self, op: str, req: dict, payload, model,
                deadline: Deadline) -> dict:
        if op == "fit":
            for _ in range(int(req.get("nb_epoch", 1))):
                deadline.check("fit epoch")
                model.fit(payload)
            return {"ok": True, "score": float(model.score_value)}
        if op == "predict":
            y = _host(model.output(payload))
            if host_nonfinite(y):
                get_registry().counter(
                    "serving_nonfinite_outputs_total",
                    help="predictions refused because the model "
                         "output carried NaN/Inf").inc()
                raise NonFiniteOutput("prediction contains NaN/Inf")
            return {"ok": True, "predictions": y.tolist()}
        if op == "evaluate":
            ev = model.evaluate(payload)
            return {"ok": True, "accuracy": ev.accuracy(), "f1": ev.f1()}
        raise AssertionError("unreachable")  # ops validated above

    # -- lifecycle ----------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._guard.draining

    @property
    def killed(self) -> bool:
        """True once ``hard_kill`` ran (chaos drivers poll this to
        respawn a flapping replica's next incarnation)."""
        return self._killed

    def hard_kill(self) -> None:
        """Chaos-only abrupt death (``kill_replica``): the in-process
        analog of SIGKILL. Every established connection is severed
        FIRST (clients mid-request see a dead connection, never a late
        answer), then the listener closes and a reaper thread retires
        the schedulers so the zombie's threads wind down — nothing in
        flight is finished, flushed, or answered. Callable from any
        thread, including a handler or decode loop, and idempotent."""
        with self._kill_lock:
            if self._killed:
                return
            self._killed = True
        flight_record("keras_server", "hard_killed", port=self.port)
        cb = self.on_hard_kill
        if cb is not None:
            try:
                cb()   # liveness (heartbeat) dies with the process
            except Exception:  # noqa: BLE001 — death must not fail
                pass
        self._guard.start_drain()   # nothing new admits into the corpse
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._server.shutdown()
        self._server.server_close()
        # scheduler teardown joins decode loops — a decode loop may be
        # the very thread that called us (mid-stream kill), so the
        # reaping happens on a fresh thread; it is transient and exits
        # as soon as the joins land
        threading.Thread(target=self._reap_after_kill, daemon=True,
                         name="replica-reap").start()

    def _reap_after_kill(self) -> None:
        if self._batcher is not None:
            self._batcher.stop(2.0)
        self._gen.stop(2.0)
        self._thread.join(timeout=5.0)
        unregister_guard(self._guard)

    def drain(self, grace_s: float = 10.0) -> bool:
        """Graceful shutdown: stop admitting (new ops get ``DRAINING``),
        let in-flight ops finish up to ``grace_s``, then close the
        listener. Returns True when the server emptied in time."""
        with self._kill_lock:
            if self._killed:
                # hard-killed already: the reaper owns teardown; a
                # belated drain (test finally blocks) is a no-op
                return True
        self._guard.start_drain()
        drained = self._guard.wait_idle(grace_s)
        if self._batcher is not None:
            # after wait_idle no admitted predict is waiting on a
            # future; fail any stragglers DRAINING and join dispatchers
            self._batcher.stop(grace_s)
        self._gen.stop(grace_s)
        self._server.shutdown()
        self._server.server_close()
        # shutdown() already waited for serve_forever to exit; the join
        # reaps the acceptor thread itself (bounded for safety)
        self._thread.join(timeout=grace_s)
        unregister_guard(self._guard)
        flight_record("keras_server", "drained", emptied=drained)
        return drained

    def stop(self, grace_s: float = 2.0) -> None:
        self.drain(grace_s)


class KerasClient:
    """Convenience client for the gateway (what the Python Keras side of
    the reference's py4j bridge would use)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._file = self._sock.makefile("rwb")

    def request(self, **req) -> dict:
        self._file.write((json.dumps(req) + "\n").encode())
        self._file.flush()
        while True:
            line = self._file.readline()
            if not line:
                raise ConnectionError("server closed")
            resp = json.loads(line)
            if not (isinstance(resp, dict) and resp.get("partial")):
                break
            # streaming generate interleaves {"partial": true, "t": tok}
            # lines before the final envelope; the blocking client just
            # drains them (the fleet router is the consumer that acts on
            # each one)
        if "error" in resp:
            # structured serving errors carry a machine-readable code in
            # "error" ("SHED", "DEADLINE", "BREAKER_OPEN", ...) plus a
            # human "message"; legacy errors are a single string
            msg = resp["error"]
            if "message" in resp:
                msg = f"{msg}: {resp['message']}"
            raise RuntimeError(msg)
        return resp

    def health(self) -> dict:
        return self.request(op="health")

    def readyz(self) -> dict:
        """The structured readiness record (unadmitted): guard state,
        model_loaded / prewarm_done checks, open breakers, inflight /
        queued depth, TTFT p99 — the fleet router's admission gate and
        load signal."""
        return self.request(op="readyz")

    def debug(self) -> dict:
        """The server's live diagnostic bundle (unadmitted, like
        health — answers even while the server is wedged)."""
        return self.request(op="debug")["bundle"]

    def fit(self, model: str, features_dir: str, labels_dir: str,
            nb_epoch: int = 1) -> dict:
        return self.request(op="fit", model=model, features_dir=features_dir,
                            labels_dir=labels_dir, nb_epoch=nb_epoch)

    def predict(self, features: str, model: Optional[str] = None) -> np.ndarray:
        resp = self.request(op="predict", features=features,
                            **({"model": model} if model else {}))
        return np.asarray(resp["predictions"])

    def generate(self, tokens, max_new_tokens: int = 16,
                 model: Optional[str] = None,
                 priority: str = "interactive", **kw) -> dict:
        """Token-level generation: returns the full response dict
        (``tokens``, ``ttft_ms``, ``reprefills``)."""
        return self.request(op="generate", tokens=list(tokens),
                            max_new_tokens=max_new_tokens,
                            priority=priority,
                            **({"model": model} if model else {}), **kw)

    def close(self) -> None:
        # close the makefile wrapper FIRST: the socket's real fd close
        # is deferred until every makefile ref drops, and a live fd
        # keeps the server's handler thread parked in readline until
        # its idle timeout instead of seeing EOF now
        try:
            self._file.close()
        except OSError:
            pass
        self._sock.close()
