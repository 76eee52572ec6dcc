"""Multi-replica serving fleet: lease-based membership, failover
routing, and zero-drop drains (the JAX package's ``keras/fleet.py``,
whole).

N ``KerasServer`` replicas behind a :class:`FleetRouter`, membership
coordinated by the shared-directory lease rendezvous of
``resilience/elastic.py``, so replica death, partition, and rolling
restarts are invisible to clients. The router touches no tensor; each
:class:`FleetReplica` hands its ``device`` to its ``KerasServer``
(``None`` = the card, raising without one; the CPU tests pass
``"cpu"``). Replicas in one process share the process-wide state of the
gateway: ``keras/batching.py``'s ``CAPTURE_LOCK`` serializes their CUDA
graph captures, and one compile cache (and its byte budget) holds every
replica's graphs.

**Membership is the lease lifecycle with a serving payload.**
Each :class:`FleetReplica` heartbeats ``hb_p<rank>.json`` into the
fleet directory carrying ``{host, port}`` — the beat IS the
registration record — and announces itself with a ``join_p<rank>.json``
request. The router (the lease holder, ``coordinator = -1``) admits a
joiner only after its structured ``readyz`` op reports ready (model
loaded, buckets prewarmed — never on bare TCP connect), and removes a
member whose heartbeat goes stale or whose connection drops dead. Every
membership change bumps the lease epoch and rewrites ``lease.json``;
routing decisions only ever read the router's own lease snapshot.
A replica that returns (partition healed, rolling restart) re-admits
through the same readyz gate at a fresh epoch.

**Dispatch** is power-of-two-choices least-loaded: two random members
are sampled and the one with the lower score (router-side in-flight,
polled queue depth, TTFT p99) wins. Per-replica load comes from each
replica's ``readyz`` responses — NOT from process-global gauges, which
in-process replicas share.

**Failure taxonomy** (the gateway's discipline, applied per replica):

- connection failure / timeout / unstructured server error → REPLICA
  fault: charges that replica's circuit breaker, and the op (predict /
  generate — both idempotent) retries on a survivor with bounded
  backoff (``fleet_failovers_total``). A dead connection also removes
  the replica at an epoch bump.
- ``SHED`` / ``DRAINING`` / ``BREAKER_OPEN`` → load/lifecycle signal:
  reroute to another replica WITHOUT charging (a draining replica is
  healthy — that is what zero-drop drains rely on).
- ``NONFINITE`` / ``DEADLINE`` / client input errors (bad paths, bad
  tokens) → CLIENT-side: passed through unchanged, never retried,
  never charged — a poisoned request must not open circuits or bounce
  around the fleet.

**Hedged duplicates** (optional, ``hedge_ms``): a predict whose primary
has not answered within the hedge delay is duplicated to a second
replica; the first good answer wins and the loser's connection is cut
(``fleet_hedges_total`` / ``fleet_hedge_wins_total``).

**Mid-stream generate failover.** Generates forward with
``stream=true``: the replica emits each token as a partial line and the
router accumulates them (optionally re-streaming to its own client).
When a replica dies mid-generation, the router re-dispatches to a
survivor from ``prompt + tokens-so-far`` with the remaining budget —
the engine's eviction re-prefill discipline generalized across
replicas — so the client's final token stream is the singleton
``greedy_generate`` stream (same weights; on the CPU bitwise, on the
card up to a near-tie between the prefill and the decode step, ROADMAP
C2; ``fleet_generate_resumes_total`` counts the seam). A sampled
request resumes with its ``sampling`` unchanged, as the JAX fleet's
does: the continuation is a new request whose draws are keyed on
(seed, token index) from index 0, so the tokens after a failover are
``sample_generate(prompt + so_far, remaining, t, seed)``, not the
unbroken stream's.

**Overload degradation.** Failover retries and hedges are
load *amplifiers* — they add traffic exactly when the pool is sickest —
so both are gated by a shared SRE-style :class:`RetryBudget` (refilled
as a fraction of successful dispatches): when the budget is dry a
failed dispatch gets at most ONE free reroute then surfaces the
structured error, and hedges are skipped entirely
(``fleet_retry_budget_exhausted_total``). Under sustained overload at
max capacity the :class:`~deeplearning4j_tpu_torch.keras.autoscale.
FleetAutoscaler` flips the router into **brownout**: bulk-class
requests (the batcher's priority classes) shed with a structured
``{"error": "SHED", "retry_after_ms": ...}`` while interactive traffic
keeps its SLO. And a replica that repeatedly joins and dies within a
window is **flap-quarantined** (``autoscale.FlapTracker``): the
membership scan skips it for an exponentially growing, bounded delay
instead of letting a crash-looper keep eating mid-stream generates.

The router itself admits through its own ``ServiceGuard`` (bounded
queue, deadlines, drain, ``/readyz``) and serves Prometheus metrics at
``http://host:metrics_port/api/metrics``.
"""

from __future__ import annotations

import json
import logging
import queue
import random
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple, Union

from deeplearning4j_tpu_torch.keras.autoscale import FlapTracker
from deeplearning4j_tpu_torch.keras.batching import priority_rank
from deeplearning4j_tpu_torch.keras.server import KerasServer
from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.elastic import (
    HostHeartbeat, clear_join_requests, pending_join_ranks, read_heartbeats,
    read_lease, request_join, write_lease,
)
from deeplearning4j_tpu_torch.resilience.service import (
    CircuitBreaker, Deadline, RetryBudget, ServiceError, ServiceGuard,
    ShedError, backoff_delay, register_guard, unregister_guard,
)

logger = logging.getLogger(__name__)

#: the lease's ``coordinator`` field when the ROUTER holds it — the
#: router is not a replica, so it sits outside the rank space (training
#: fleets use the lowest rank; the serving fleet has a dedicated holder)
ROUTER_COORDINATOR = -1


class NoReplicaAvailable(ServiceError):
    """No member can take this request (fleet empty, every breaker
    open, or retries exhausted against a flapping fleet)."""

    code = "NO_REPLICA"


class UnroutableOp(ServiceError):
    """Op not served by the fleet (``fit``/``evaluate`` mutate or scan
    ONE replica's state — they belong on a direct connection)."""

    code = "UNROUTABLE"


#: replica error codes that stay CLIENT-side: pass through, never
#: retried, never charged to a breaker (the gateway's taxonomy)
_CLIENT_CODES = frozenset({"NONFINITE", "DEADLINE"})
#: codes that mean "this replica can't take it right now, another can":
#: reroute without charging
_REROUTE_CODES = frozenset({"SHED", "DRAINING", "BREAKER_OPEN"})
#: legacy single-string error prefixes that are client-input failures
#: (bad op, bad shapes, bad file paths) — the replica processed the
#: request and returned a verdict, so nothing is charged or retried
_CLIENT_LEGACY = ("ValueError", "KeyError", "TypeError",
                  "JSONDecodeError", "FileNotFoundError",
                  "IsADirectoryError", "NotADirectoryError",
                  "PermissionError")


def _classify(resp: dict) -> str:
    """'client' | 'reroute' | 'replica' for a replica's error
    response."""
    code = str(resp.get("error", ""))
    if code in _CLIENT_CODES:
        return "client"
    if code in _REROUTE_CODES:
        return "reroute"
    if "message" in resp:
        # a structured code we don't know: surface it untouched rather
        # than guess-retry a verdict the replica already made
        return "client"
    if code.split(":", 1)[0] in _CLIENT_LEGACY:
        return "client"
    return "replica"


class _ForwardFailure(Exception):
    """Internal: a forward attempt failed with replica attribution."""

    def __init__(self, rep: "_Replica", cause: BaseException,
                 dead_connection: bool):
        super().__init__(str(cause))
        self.rep = rep
        self.cause = cause
        self.dead_connection = dead_connection


class _Replica:
    """Router-side record of one fleet member. ``inflight`` is the
    router's own dispatch count (guarded by the router lock);
    ``queued`` / ``ttft_p99_ms`` are the last readyz-polled values."""

    __slots__ = ("rank", "host", "port", "breaker", "inflight",
                 "queued", "ttft_p99_ms")

    def __init__(self, rank: int, host: str, port: int,
                 breaker: CircuitBreaker):
        self.rank = rank
        self.host = host
        self.port = port
        self.breaker = breaker
        self.inflight = 0
        self.queued = 0
        self.ttft_p99_ms = 0.0


class FleetReplica:
    """One fleet member in this process: a ``KerasServer`` (with
    ``replica_rank`` armed for the chaos kinds and ``preload`` for
    readiness) plus its rendezvous presence — a payload heartbeat and a
    join request in the shared fleet directory. ``device`` and the other
    ``server_kw`` go to the ``KerasServer``, which resolves the device
    before anything is announced: ``None`` (the card) raises here on a
    box without one, never when a request arrives.

    ``drain()`` is the zero-drop leave: the heartbeat retires FIRST
    (file deleted — the router stops routing here within one poll; the
    raced requests that still land get ``DRAINING`` and reroute), then
    in-flight work finishes under the server's own drain. ``kill()`` is
    chaos: abrupt death, stale heartbeat left behind."""

    def __init__(self, fleet_dir: Union[str, Path], rank: int,
                 model: Optional[str] = None, host: str = "127.0.0.1",
                 port: int = 0, heartbeat_interval_s: float = 0.2,
                 device=None, **server_kw):
        self.rank = int(rank)
        self._dir = Path(fleet_dir)
        self.server = KerasServer(
            host=host, port=port, replica_rank=self.rank,
            preload=[model] if model else None, device=device, **server_kw)
        self.host, self.port = self.server.host, self.server.port
        self._hb = HostHeartbeat(
            self._dir, self.rank, interval_s=heartbeat_interval_s,
            payload={"host": self.host, "port": self.port})
        # a hard kill (chaos or real) must take liveness with it: stop
        # beating, LEAVE the stale file — that is how peers see death
        self.server.on_hard_kill = self._hb.stop
        request_join(self._dir, self.rank)
        self._hb.start()
        # flap_replica chaos: this incarnation dies shortly after the
        # router admits it — the crash-looper the flap quarantine exists
        # for. The watcher thread is joined on drain (LC005)
        self._flap_stop = threading.Event()
        self._flap_thread: Optional[threading.Thread] = None
        flap_delay = faultinject.check_flap_spawn(self.rank)
        if flap_delay is not None:
            self._flap_thread = threading.Thread(
                target=self._flap_loop, args=(float(flap_delay),),
                daemon=True, name=f"flap-replica-{self.rank}")
            self._flap_thread.start()
        flight_record("fleet", "replica_up", rank=self.rank,
                      port=self.port)

    def _flap_loop(self, delay_s: float) -> None:
        """Wait until this rank shows up in the lease world (admitted),
        then hard-kill ``delay_s`` later — join-then-die, the shape a
        crash-looping launcher produces."""
        while not self._flap_stop.is_set():
            lease = read_lease(self._dir)
            if lease and self.rank in (lease.get("world") or []):
                break
            if self._flap_stop.wait(0.05):
                return
        if self._flap_stop.wait(delay_s):
            return
        flight_record("faultinject", "flap_kill", rank=self.rank)
        self.kill()

    @property
    def draining(self) -> bool:
        return self.server.draining

    @property
    def alive(self) -> bool:
        """False once the server was hard-killed (chaos harnesses use
        this to decide when to respawn a flapping incarnation)."""
        return not self.server.killed

    def readyz(self) -> dict:
        return self.server._readyz()

    def drain(self, grace_s: float = 10.0) -> bool:
        self._flap_stop.set()
        if self._flap_thread is not None:
            self._flap_thread.join(timeout=5.0)
            self._flap_thread = None
        self._hb.retire()
        clear_join_requests(self._dir, [self.rank])
        drained = self.server.drain(grace_s)
        flight_record("fleet", "replica_drained", rank=self.rank,
                      emptied=drained)
        return drained

    def kill(self) -> None:
        """Chaos: die the way ``kill_replica`` dies — connections
        severed, heartbeat stopped cold (stale file stays)."""
        self.server.hard_kill()


class FleetRouter:
    """The fleet front-end: speaks the KerasServer newline-JSON
    protocol (a ``KerasClient`` pointed at the router works unchanged),
    admits through its own ``ServiceGuard``, and dispatches ``predict``
    / ``generate`` across the lease's current membership."""

    def __init__(self, fleet_dir: Union[str, Path],
                 host: str = "127.0.0.1", port: int = 0,
                 max_concurrency: int = 16, queue_depth: int = 64,
                 default_deadline_ms: Optional[float] = 300_000.0,
                 max_queue_wait_s: float = 5.0,
                 heartbeat_timeout_s: float = 2.0,
                 poll_s: float = 0.25,
                 breaker_failures: int = 3,
                 breaker_cooldown_base: float = 0.5,
                 breaker_cooldown_max: float = 30.0,
                 retries: int = 4,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 0.5,
                 hedge_ms: Optional[float] = None,
                 empty_pool_wait_s: float = 15.0,
                 connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 120.0,
                 retry_budget_capacity: float = 10.0,
                 retry_budget_ratio: float = 0.1,
                 flap_window_s: float = 5.0,
                 flap_strikes: int = 2,
                 flap_quarantine_base_s: float = 2.0,
                 flap_quarantine_max_s: float = 60.0,
                 metrics_port: Optional[int] = 0):
        self._dir = Path(fleet_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.poll_s = float(poll_s)
        self.retries = int(retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.hedge_ms = hedge_ms
        self.empty_pool_wait_s = float(empty_pool_wait_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self._breaker_kw = dict(failures=breaker_failures,
                                cooldown_base=breaker_cooldown_base,
                                cooldown_max=breaker_cooldown_max)
        # one budget gates EVERY amplifier (failover retries + hedges):
        # retries stay a bounded fraction of successful traffic
        self._retry_budget = RetryBudget(capacity=retry_budget_capacity,
                                         refill_ratio=retry_budget_ratio)
        self._flaps = FlapTracker(window_s=flap_window_s,
                                  strikes_to_quarantine=flap_strikes,
                                  base_s=flap_quarantine_base_s,
                                  max_s=flap_quarantine_max_s)
        # flipped by the autoscaler's brownout state machine; read
        # lock-free on the hot path (a bool write is atomic under the
        # GIL and a one-request stale read is harmless)
        self._brownout = False
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._replicas: Dict[int, _Replica] = {}
        lease = read_lease(self._dir)
        self._epoch = int(lease["epoch"]) if lease else 0
        self._closed = False
        # lease writes serialize here, and an epoch never regresses on
        # disk even when a dispatch-path removal races the monitor
        self._lease_lock = threading.Lock()
        self._lease_epoch_written = self._epoch
        self._stop_evt = threading.Event()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            timeout = io_timeout_s

            def _stream_writer(self):
                """Client-facing partial re-streaming for generate
                (same wire shape the replicas emit). All writes happen
                on THIS handler thread — forwarding is synchronous — so
                no write lock is needed."""
                def on_token(tok):
                    self.wfile.write((json.dumps(
                        {"partial": True, "t": int(tok)}) + "\n").encode())
                    self.wfile.flush()
                return on_token

            def handle(self):
                try:
                    for line in self.rfile:
                        try:
                            req = json.loads(line)
                            on_token = None
                            if req.get("op") == "generate" \
                                    and req.get("stream"):
                                on_token = self._stream_writer()
                            resp = outer._handle(req, on_token)
                        except ServiceError as e:
                            resp = e.to_response()
                        except Exception as e:  # report, keep serving
                            resp = {"error": f"{type(e).__name__}: {e}"}
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                        if isinstance(resp, dict) and resp.get("shutdown"):
                            threading.Thread(target=outer.close,
                                             daemon=True).start()
                            return
                except (TimeoutError, OSError):
                    return  # client vanished / idle timeout

        self._server = socketserver.ThreadingTCPServer((host, port),
                                                       Handler)
        self._server.daemon_threads = True
        self.host, self.port = host, self._server.server_address[1]
        self._guard = register_guard(ServiceGuard(
            f"fleet_router_{self.port}",
            max_concurrency=max_concurrency, queue_depth=queue_depth,
            default_deadline_ms=default_deadline_ms,
            max_queue_wait_s=max_queue_wait_s))
        self._guard.add_ready_check("replicas",
                                    lambda: bool(self._replicas))
        # metrics exist (at zero) from birth: an empty /api/metrics
        # scrape must still show the fleet_* family
        reg = get_registry()
        self._m_dispatches = reg.counter(
            "fleet_dispatches_total",
            help="requests forwarded to a replica (attempts, not "
                 "client requests)")
        self._m_retries = reg.counter(
            "fleet_retries_total",
            help="forward attempts re-dispatched to another replica "
                 "(any cause)")
        self._m_failovers = reg.counter(
            "fleet_failovers_total",
            help="retries caused by a replica-attributable failure "
                 "(dead connection, timeout, server fault)")
        self._m_hedges = reg.counter(
            "fleet_hedges_total",
            help="predicts duplicated to a second replica after the "
                 "hedge delay")
        self._m_hedge_wins = reg.counter(
            "fleet_hedge_wins_total",
            help="hedged duplicates that answered before the primary")
        self._m_admissions = reg.counter(
            "fleet_admissions_total",
            help="replicas admitted to the fleet (readyz-gated, "
                 "each at an epoch bump)")
        self._m_removals = reg.counter(
            "fleet_removals_total",
            help="replicas removed from the fleet (stale heartbeat or "
                 "dead connection, each at an epoch bump)")
        self._m_resumes = reg.counter(
            "fleet_generate_resumes_total",
            help="mid-stream generations resumed on a survivor via "
                 "re-prefill from prompt + tokens-so-far")
        self._m_budget_exhausted = reg.counter(
            "fleet_retry_budget_exhausted_total",
            help="retries/hedges suppressed because the retry budget "
                 "was dry")
        self._m_brownout_sheds = reg.counter(
            "fleet_brownout_sheds_total",
            help="bulk-class requests shed (structured SHED) while the "
                 "router was in brownout")
        self._m_quarantines = reg.counter(
            "fleet_quarantines_total",
            help="flap-quarantine episodes (a crash-looping replica "
                 "put on probation)")
        self._g_replicas = reg.gauge(
            "fleet_replicas", help="current fleet membership size")
        self._g_epoch = reg.gauge(
            "fleet_epoch", help="current membership lease epoch")
        self._g_brownout = reg.gauge(
            "fleet_brownout",
            help="1 while the router sheds bulk-class requests")
        self._g_budget = reg.gauge(
            "fleet_retry_budget_tokens",
            help="retry-budget tokens currently available")
        self._g_score = reg.labeled_gauge(
            "fleet_replica_score",
            help="per-replica dispatch score (lower routes sooner): "
                 "2*inflight + queued + min(ttft_p99,1000)/1000")
        self._g_replicas.set(0)
        self._g_epoch.set(self._epoch)
        self._g_brownout.set(0)
        self._g_budget.set(self._retry_budget.tokens)
        # optional Prometheus sidecar: GET /api/metrics[.json], /readyz
        self._http = None
        self._http_thread: Optional[threading.Thread] = None
        if metrics_port is not None:
            self._http = _MetricsHTTP(self, host, int(metrics_port))
            self.metrics_port = self._http.server_address[1]
            self._http_thread = threading.Thread(
                target=self._http.serve_forever, daemon=True,
                name="fleet-metrics-http")
            self._http_thread.start()
        else:
            self.metrics_port = None
        self._acceptor = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="fleet-acceptor")
        self._acceptor.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="fleet-monitor")
        self._monitor.start()

    # ----------------------------------------------------------- membership
    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            try:
                self._membership_scan()
            except Exception:  # noqa: BLE001 — the fleet outlives a scan
                logger.exception("fleet membership scan failed")

    def _membership_scan(self) -> None:
        """One rendezvous pass: remove stale members, admit ready
        joiners (join request OR a returning fresh heartbeat), refresh
        per-member load stats."""
        hbs = read_heartbeats(self._dir)
        with self._lock:
            members = {rank: (r.host, r.port)
                       for rank, r in self._replicas.items()}
        for rank in list(members):
            hb = hbs.get(rank)
            if hb is None:
                self._remove_replica(rank, "heartbeat_gone")
            elif float(hb["age"]) > self.heartbeat_timeout_s:
                self._remove_replica(rank, "stale_heartbeat")
        # candidates: announced joiners plus any returning rank with a
        # fresh payload heartbeat (a healed partition re-admits itself
        # through the same readyz gate, at a fresh epoch)
        candidates = set(pending_join_ranks(self._dir)) | set(hbs)
        for rank in sorted(candidates - set(members)):
            if self._flaps.blocked(rank):
                continue  # on probation: re-admission delay still runs
            hb = hbs.get(rank)
            if hb is None or float(hb["age"]) > self.heartbeat_timeout_s:
                continue
            host, port = hb.get("host"), hb.get("port")
            if host is None or port is None:
                continue  # a training-host beat, not a serving replica
            rz = self._probe_readyz(str(host), int(port))
            if rz is not None and rz.get("ready"):
                self._admit_replica(rank, str(host), int(port))
        self._poll_stats()

    def _probe_readyz(self, host: str, port: int) -> Optional[dict]:
        try:
            with socket.create_connection(
                    (host, port), timeout=self.connect_timeout_s) as s:
                s.settimeout(self.connect_timeout_s)
                f = s.makefile("rwb")
                f.write(b'{"op": "readyz"}\n')
                f.flush()
                line = f.readline()
                f.close()
            if not line:
                return None
            return json.loads(line)
        except (OSError, ValueError):
            return None

    def _poll_stats(self) -> None:
        """Refresh queue-depth / TTFT-p99 dispatch signals from each
        member's readyz op; a member whose probe fails outright is
        removed (dead connection)."""
        with self._lock:
            members = [(r.rank, r.host, r.port)
                       for r in self._replicas.values()]
        for rank, host, port in members:
            rz = self._probe_readyz(host, port)
            if rz is None:
                self._remove_replica(rank, "dead_connection")
                continue
            with self._lock:
                rep = self._replicas.get(rank)
                if rep is not None:
                    rep.queued = int(rz.get("queued") or 0)
                    rep.ttft_p99_ms = float(rz.get("ttft_p99_ms") or 0.0)
                    score = self._score_locked(rep)
            if rep is not None:
                # the dispatch score itself, per replica, so autoscaler
                # decisions are explainable from /api/metrics alone
                self._g_score.labels(rank=str(rank)).set(score)

    def _admit_replica(self, rank: int, host: str, port: int) -> None:
        with self._lock:
            if self._closed or rank in self._replicas:
                return
            self._replicas[rank] = _Replica(
                rank, host, port,
                CircuitBreaker(key=f"replica:{rank}", **self._breaker_kw))
            self._epoch += 1
            epoch, world = self._epoch, sorted(self._replicas)
        clear_join_requests(self._dir, [rank])
        self._publish_lease(epoch, world)
        self._flaps.on_admit(rank)
        self._m_admissions.inc()
        self._g_replicas.set(len(world))
        self._g_epoch.set(epoch)
        self._g_score.labels(rank=str(rank)).set(0.0)
        get_tracer().instant("fleet_admit", rank=rank, epoch=epoch)
        flight_record("fleet", "replica_admitted", rank=rank,
                      epoch=epoch, world=world)

    def _remove_replica(self, rank: int, reason: str) -> None:
        with self._lock:
            if self._replicas.pop(rank, None) is None:
                return
            self._epoch += 1
            epoch, world = self._epoch, sorted(self._replicas)
        self._publish_lease(epoch, world)
        self._m_removals.inc()
        self._g_replicas.set(len(world))
        self._g_epoch.set(epoch)
        self._g_score.remove(rank=str(rank))
        get_tracer().instant("fleet_remove", rank=rank, epoch=epoch,
                             reason=reason)
        flight_record("fleet", "replica_removed", rank=rank,
                      epoch=epoch, reason=reason, world=world)
        quarantine_s = self._flaps.on_remove(rank, reason)
        if quarantine_s is not None:
            self._m_quarantines.inc()
            get_tracer().instant("fleet_quarantine", rank=rank,
                                 delay_s=round(quarantine_s, 3))
            flight_record("fleet", "replica_quarantined", rank=rank,
                          delay_s=round(quarantine_s, 3),
                          strikes=self._flaps.strikes(rank))

    def _publish_lease(self, epoch: int, world: List[int]) -> None:
        """Serialized, monotonic lease writes: a racing older epoch
        never lands on disk after a newer one."""
        with self._lease_lock:
            if epoch <= self._lease_epoch_written:
                return
            self._lease_epoch_written = epoch
            write_lease(self._dir, epoch, world, ROUTER_COORDINATOR)

    # ------------------------------------------------------------- dispatch
    def _score_locked(self, r: _Replica) -> float:
        # router-side in-flight is the freshest signal; polled queue
        # depth and TTFT p99 (bounded so a slow outlier can't dominate
        # forever) break ties toward the snappier replica
        return (2.0 * r.inflight + float(r.queued)
                + min(r.ttft_p99_ms, 1000.0) / 1000.0)

    def _pick(self, exclude: Set[int]) -> Optional[_Replica]:
        """Power-of-two-choices among members outside ``exclude``
        (falling back to all members when exclusion empties the pool —
        a last retry against a previously-failed replica beats a
        refusal)."""
        with self._lock:
            cands = [r for k, r in self._replicas.items()
                     if k not in exclude]
            if not cands:
                cands = list(self._replicas.values())
            if not cands:
                return None
            if len(cands) > 2:
                cands = self._rng.sample(cands, 2)
            return min(cands, key=self._score_locked)

    def _try_pick(self, exclude: Set[int]) -> Optional[_Replica]:
        seen = set(exclude)
        while True:
            rep = self._pick(seen)
            if rep is None:
                return None
            if rep.breaker.allow():
                return rep
            if rep.rank in seen:
                return None  # exclusion already exhausted the pool
            seen.add(rep.rank)

    def _pick_for_dispatch(self, exclude: Set[int],
                           deadline: Deadline) -> Optional[_Replica]:
        """``_try_pick``, but riding out a briefly-empty pool: during a
        rolling restart the last old replica can leave moments before
        its replacement admits, and a mid-stream failover's survivor
        may still be in its readyz gate. Waiting (bounded by
        ``empty_pool_wait_s`` and the deadline) is what turns those
        windows into latency instead of client-visible failures."""
        t_end = time.monotonic() + self.empty_pool_wait_s
        while True:
            rep = self._try_pick(exclude)
            if rep is not None:
                return rep
            deadline.check("fleet replica wait")
            if time.monotonic() >= t_end or self._stop_evt.is_set():
                return None
            time.sleep(0.05)

    def _no_replica(self, what: str) -> NoReplicaAvailable:
        with self._lock:
            n = len(self._replicas)
            ras = [r.breaker.retry_after_ms()
                   for r in self._replicas.values()]
        return NoReplicaAvailable(
            f"{what}: no dispatchable replica ({n} member(s))",
            retry_after_ms=min(ras) if ras else None)

    def _note_inflight(self, rep: _Replica, delta: int) -> None:
        with self._lock:
            rep.inflight += delta

    def _io_budget(self, deadline: Deadline) -> float:
        rem = deadline.remaining()
        if rem is None:
            return self.io_timeout_s
        return max(0.05, min(self.io_timeout_s, rem + 0.25))

    def _forward(self, rep: _Replica, fwd: dict, deadline: Deadline,
                 on_partial=None, sock_slot: Optional[list] = None
                 ) -> Tuple[dict, int]:
        """One request to one replica over a fresh connection. Streams
        partial tokens to ``on_partial``; returns ``(final response,
        partial count)``. Raises ``_ForwardFailure`` on connection
        failure / timeout / garbage, with the replica attributed."""
        self._m_dispatches.inc()
        partials = 0
        try:
            rem = deadline.remaining()
            if rem is not None and rem <= 0:
                deadline.check("fleet forward")
            with socket.create_connection(
                    (rep.host, rep.port),
                    timeout=self.connect_timeout_s) as s:
                s.settimeout(self._io_budget(deadline))
                f = s.makefile("rwb")
                if sock_slot is not None:
                    sock_slot.append(s)
                try:
                    f.write((json.dumps(fwd) + "\n").encode())
                    f.flush()
                    while True:
                        line = f.readline()
                        if not line:
                            raise ConnectionError(
                                f"replica {rep.rank} closed the "
                                f"connection mid-response")
                        resp = json.loads(line)
                        if isinstance(resp, dict) and resp.get("partial"):
                            partials += 1
                            if on_partial is not None:
                                on_partial(int(resp["t"]))
                            continue
                        return resp, partials
                finally:
                    try:
                        f.close()
                    except OSError:
                        pass
        except socket.timeout as e:
            # slow, maybe alive: charge-worthy, but not removal-worthy
            raise _ForwardFailure(rep, e, dead_connection=False) from e
        except (ConnectionError, OSError, ValueError) as e:
            # refused / reset / EOF / garbage bytes: a dead connection
            raise _ForwardFailure(rep, e, dead_connection=True) from e

    def _absorb_failure(self, failure: _ForwardFailure) -> None:
        """Charge and (for dead connections) remove the failed
        replica — the shared accounting for primary and hedge paths."""
        failure.rep.breaker.record_failure()
        if failure.dead_connection:
            self._remove_replica(failure.rep.rank, "dead_connection")

    # --------------------------------------------------------- retry budget
    def _budget_success(self) -> None:
        """A replica answered: earn back a fraction of a retry token."""
        self._retry_budget.on_success()
        self._g_budget.set(self._retry_budget.tokens)

    def _spend_retry(self, what: str) -> bool:
        """Spend one budget token for a retry/hedge; False = dry (the
        caller must stop amplifying)."""
        if self._retry_budget.try_spend():
            self._g_budget.set(self._retry_budget.tokens)
            return True
        self._m_budget_exhausted.inc()
        flight_record("fleet", "retry_budget_exhausted", what=what)
        return False

    # ------------------------------------------------------------- predict
    def _dispatch_predict(self, req: dict, deadline: Deadline) -> dict:
        attempt = 0
        tried: Set[int] = set()
        last_resp: Optional[dict] = None
        # with a dry budget a failed dispatch still gets ONE reroute
        # (a single replica death must not fail clients outright), but
        # never a storm
        free_reroute_used = False
        while True:
            deadline.check("fleet predict")
            rep = self._pick_for_dispatch(tried, deadline)
            if rep is None:
                if last_resp is not None:
                    return last_resp  # honest: the fleet's own verdict
                raise self._no_replica("predict")
            fwd = dict(req)
            rem = deadline.remaining()
            if rem is not None:
                fwd["deadline_ms"] = max(1.0, rem * 1000.0)
            try:
                used, resp = self._forward_hedged(rep, fwd, deadline,
                                                  tried)
            except _ForwardFailure as failure:
                self._absorb_failure(failure)
                tried.add(failure.rep.rank)
                attempt += 1
                if attempt > self.retries:
                    raise NoReplicaAvailable(
                        f"predict: {attempt} attempts exhausted; last "
                        f"failure on replica {failure.rep.rank}: "
                        f"{failure.cause}") from failure.cause
                if not self._spend_retry("predict"):
                    if free_reroute_used:
                        raise NoReplicaAvailable(
                            f"predict: retry budget exhausted after "
                            f"{attempt} attempt(s); last failure on "
                            f"replica {failure.rep.rank}: "
                            f"{failure.cause}") from failure.cause
                    free_reroute_used = True
                self._m_retries.inc()
                self._m_failovers.inc()
                flight_record("fleet", "failover", op="predict",
                              frm=failure.rep.rank, attempt=attempt)
                self._backoff(attempt, deadline)
                continue
            if resp.get("error") is None:
                used.breaker.record_success()
                self._budget_success()
                return resp
            verdict = _classify(resp)
            if verdict == "client":
                used.breaker.record_success()
                self._budget_success()
                return resp
            if verdict == "replica":
                used.breaker.record_failure()
            last_resp = resp
            tried.add(used.rank)
            attempt += 1
            if attempt > self.retries:
                return resp
            if not self._spend_retry("predict"):
                if free_reroute_used:
                    return resp  # surface the fleet's structured verdict
                free_reroute_used = True
            self._m_retries.inc()
            if verdict == "replica":
                self._m_failovers.inc()
                flight_record("fleet", "failover", op="predict",
                              frm=used.rank, attempt=attempt)
            self._backoff(attempt, deadline)

    def _forward_hedged(self, rep: _Replica, fwd: dict,
                        deadline: Deadline, tried: Set[int]
                        ) -> Tuple[_Replica, dict]:
        """Forward with an optional hedged duplicate. Hedging defends
        the TAIL (a slow-but-alive primary), not errors: when the
        primary fails outright the outer retry loop is the failover
        path. Returns ``(replica answered, response)`` or raises the
        primary's ``_ForwardFailure``."""
        if self.hedge_ms is None:
            self._note_inflight(rep, +1)
            try:
                resp, _ = self._forward(rep, fwd, deadline)
            finally:
                self._note_inflight(rep, -1)
            return rep, resp
        outcomes: "queue.Queue" = queue.Queue()
        slots: Dict[int, list] = {}

        def run(r: _Replica) -> None:
            slot: list = []
            slots[r.rank] = slot
            self._note_inflight(r, +1)
            try:
                resp, _ = self._forward(r, fwd, deadline,
                                        sock_slot=slot)
                outcomes.put((r, resp, None))
            except _ForwardFailure as failure:
                outcomes.put((r, None, failure))
            except Exception as e:  # noqa: BLE001 — never strand the q
                outcomes.put((r, None, _ForwardFailure(r, e, False)))
            finally:
                self._note_inflight(r, -1)

        threading.Thread(target=run, args=(rep,), daemon=True,
                         name="fleet-forward").start()
        launched = [rep]
        try:
            first = outcomes.get(timeout=self.hedge_ms / 1000.0)
        except queue.Empty:
            first = None
        if first is None:
            # opportunistic: a hedge with nowhere to go just waits for
            # the primary (never block on an empty pool here). A hedge
            # is a duplicate — pure amplification — so it spends a
            # retry-budget token; dry budget = no hedge, period
            hedge = self._try_pick(tried | {rep.rank})
            if (hedge is not None and hedge.rank != rep.rank
                    and self._spend_retry("hedge")):
                self._m_hedges.inc()
                flight_record("fleet", "hedge", primary=rep.rank,
                              hedge=hedge.rank)
                threading.Thread(target=run, args=(hedge,), daemon=True,
                                 name="fleet-forward-hedge").start()
                launched.append(hedge)
            first = outcomes.get(timeout=self._io_budget(deadline)
                                 + self.connect_timeout_s + 1.0)
        collected = [first]
        r0, resp0, fail0 = first
        winner = None
        if fail0 is None and (resp0.get("error") is None
                              or _classify(resp0) == "client"):
            winner = (r0, resp0)
        elif len(launched) > 1:
            # first outcome is bad: account for it, take the other
            if fail0 is not None:
                self._absorb_failure(fail0)
            else:
                if _classify(resp0) == "replica":
                    r0.breaker.record_failure()
            second = outcomes.get(timeout=self._io_budget(deadline)
                                  + self.connect_timeout_s + 1.0)
            collected.append(second)
            r1, resp1, fail1 = second
            if fail1 is not None:
                raise fail1
            winner = (r1, resp1)
        else:
            if fail0 is not None:
                raise fail0
            winner = (r0, resp0)
        # cut the loser loose: close its socket so its thread unblocks
        # and errors out (its failure is discarded, not charged — the
        # race was OUR doing)
        for r in launched:
            if r.rank != winner[0].rank:
                for s in slots.get(r.rank, ()):
                    try:
                        s.close()
                    except OSError:
                        pass
        if len(launched) > 1 and winner[0].rank != rep.rank:
            self._m_hedge_wins.inc()
        return winner

    # ------------------------------------------------------------- generate
    def _dispatch_generate(self, req: dict, deadline: Deadline,
                           on_token) -> dict:
        prompt = [int(t) for t in (req.get("tokens") or [])]
        if not prompt:
            raise ValueError("generate needs 'tokens': [ids...]")
        max_new = int(req.get("max_new_tokens", 16))
        sofar: List[int] = []
        failovers = 0
        attempt = 0
        tried: Set[int] = set()
        free_reroute_used = False
        t0 = time.monotonic()
        first_token_s: Optional[float] = None
        final: Optional[dict] = None
        while True:
            deadline.check("fleet generate")
            remaining = max_new - len(sofar)
            if remaining <= 0:
                break  # the replica died BETWEEN its last token and
                # the final envelope: the stream is already complete
            rep = self._pick_for_dispatch(tried, deadline)
            if rep is None:
                raise self._no_replica(
                    f"generate ({len(sofar)} tokens streamed)")
            # the re-prefill continuation: survivors see prompt +
            # generated-so-far as THE prompt and the leftover budget as
            # THE budget — the engine's eviction discipline
            fwd = dict(req)
            fwd["tokens"] = prompt + sofar
            fwd["max_new_tokens"] = remaining
            fwd["stream"] = True
            rem = deadline.remaining()
            if rem is not None:
                fwd["deadline_ms"] = max(1.0, rem * 1000.0)
            wave: List[int] = []

            def on_partial(tok: int) -> None:
                nonlocal first_token_s
                if first_token_s is None:
                    first_token_s = time.monotonic()
                wave.append(tok)
                sofar.append(tok)
                if on_token is not None:
                    on_token(tok)

            self._note_inflight(rep, +1)
            try:
                resp, _ = self._forward(rep, fwd, deadline,
                                        on_partial=on_partial)
            except _ForwardFailure as failure:
                self._absorb_failure(failure)
                tried.add(rep.rank)
                attempt += 1
                if attempt > self.retries:
                    raise NoReplicaAvailable(
                        f"generate: {attempt} attempts exhausted with "
                        f"{len(sofar)} tokens streamed; last failure "
                        f"on replica {rep.rank}: {failure.cause}"
                    ) from failure.cause
                if not self._spend_retry("generate"):
                    if free_reroute_used:
                        raise NoReplicaAvailable(
                            f"generate: retry budget exhausted after "
                            f"{attempt} attempt(s) with {len(sofar)} "
                            f"tokens streamed; last failure on replica "
                            f"{rep.rank}: {failure.cause}"
                        ) from failure.cause
                    free_reroute_used = True
                self._m_retries.inc()
                self._m_failovers.inc()
                if sofar:
                    self._m_resumes.inc()
                    get_tracer().instant("fleet_generate_resume",
                                         frm=rep.rank,
                                         tokens=len(sofar))
                flight_record("fleet", "failover", op="generate",
                              frm=rep.rank, attempt=attempt,
                              tokens_so_far=len(sofar))
                failovers += 1
                self._backoff(attempt, deadline)
                continue
            finally:
                self._note_inflight(rep, -1)
            if resp.get("error") is None:
                rep.breaker.record_success()
                self._budget_success()
                # reconcile: the final envelope carries this attempt's
                # complete token list; partials lost to a transient
                # stream-write failure on the replica still count
                full = [int(t) for t in resp.get("tokens", [])]
                for tok in full[len(wave):]:
                    if first_token_s is None:
                        first_token_s = time.monotonic()
                    sofar.append(tok)
                    if on_token is not None:
                        on_token(tok)
                final = resp
                break
            verdict = _classify(resp)
            if verdict == "client":
                rep.breaker.record_success()
                self._budget_success()
                return resp
            if verdict == "replica":
                rep.breaker.record_failure()
            tried.add(rep.rank)
            attempt += 1
            if attempt > self.retries:
                return resp
            if not self._spend_retry("generate"):
                if free_reroute_used:
                    return resp  # surface the fleet's structured verdict
                free_reroute_used = True
            self._m_retries.inc()
            if verdict == "replica":
                self._m_failovers.inc()
                if sofar:
                    self._m_resumes.inc()
                failovers += 1
            self._backoff(attempt, deadline)
        ttft_ms = (None if first_token_s is None
                   else round((first_token_s - t0) * 1000.0, 3))
        return {"ok": True, "tokens": sofar, "ttft_ms": ttft_ms,
                "reprefills": int((final or {}).get("reprefills") or 0),
                "failovers": failovers}

    def _backoff(self, attempt: int, deadline: Deadline) -> None:
        delay = backoff_delay(attempt, self.backoff_base_s,
                              self.backoff_max_s, self._rng)
        rem = deadline.remaining()
        if rem is not None:
            delay = min(delay, max(0.0, rem - 0.05))
        if delay > 0:
            time.sleep(delay)

    # ---------------------------------------------------------------- serve
    def _handle(self, req: dict, on_token=None) -> dict:
        op = req.get("op")
        if op == "health":
            ready, reasons = self._guard.ready()
            return {"ok": True, "live": True, "ready": ready,
                    "reasons": reasons,
                    "draining": self._guard.draining}
        if op == "readyz":
            return self._readyz()
        if op == "shutdown":
            return {"ok": True, "shutdown": True}
        if op in ("fit", "evaluate"):
            raise UnroutableOp(
                f"{op} mutates or scans ONE replica's state; connect "
                f"to a replica directly — the fleet serves stateless "
                f"inference (predict/generate)")
        if op not in ("predict", "generate"):
            raise ValueError(f"unknown op {op!r}")
        if self._brownout and priority_rank(
                str(req.get("priority", "interactive"))) > 0:
            # brownout: degrade by priority class, not for everyone —
            # bulk sheds (structured, connection stays up) so
            # interactive keeps its SLO
            self._m_brownout_sheds.inc()
            flight_record("fleet", "brownout_shed", op=op)
            raise ShedError(
                "fleet brownout: shedding bulk-class requests",
                retry_after_ms=int(self._guard.max_queue_wait_s * 1000))
        deadline = self._guard.deadline(req)
        with self._guard.admit(deadline):
            flight_record("fleet", "dispatch", op=op)
            with get_tracer().span(f"fleet:{op}"):
                if op == "predict":
                    return self._dispatch_predict(req, deadline)
                return self._dispatch_generate(req, deadline, on_token)

    def _readyz(self) -> dict:
        ready, reasons = self._guard.ready()
        with self._lock:
            epoch = self._epoch
            brownout = self._brownout
            replicas = {
                str(r.rank): {"host": r.host, "port": r.port,
                              "inflight": r.inflight,
                              "queued": r.queued,
                              "ttft_p99_ms": r.ttft_p99_ms,
                              "breaker": r.breaker.state,
                              "score": self._score_locked(r)}
                for r in self._replicas.values()}
        if brownout:
            # honest readiness: ready (interactive still serves), but
            # the degradation is visible to anything that probes
            reasons = list(reasons) + ["brownout: shedding bulk"]
        return {"ok": True, "ready": ready, "reasons": reasons,
                "draining": self._guard.draining, "epoch": epoch,
                "brownout": brownout,
                "retry_budget_tokens": self._retry_budget.tokens,
                "replicas": replicas}

    # ------------------------------------------------------------- overload
    @property
    def brownout(self) -> bool:
        return self._brownout

    def set_brownout(self, active: bool, reason: str = "") -> None:
        """Flip brownout shedding (the autoscaler's state machine owns
        the transitions; operators can force it too). Idempotent."""
        active = bool(active)
        with self._lock:
            if self._brownout == active:
                return
            self._brownout = active
        self._g_brownout.set(1 if active else 0)
        kind = "brownout_enter" if active else "brownout_exit"
        get_tracer().instant(f"fleet_{kind}", reason=reason)
        flight_record("fleet", kind, reason=reason)

    def load_snapshot(self) -> dict:
        """One coherent view of the load signals the autoscaler ticks
        on: router queue/inflight, lease epoch, and per-member polled
        stats (queued, TTFT p99, breaker state, dispatch score)."""
        with self._lock:
            replicas = {
                r.rank: {"inflight": r.inflight, "queued": r.queued,
                         "ttft_p99_ms": r.ttft_p99_ms,
                         "breaker": r.breaker.state,
                         "score": self._score_locked(r)}
                for r in self._replicas.values()}
            epoch, brownout = self._epoch, self._brownout
        return {"queued": self._guard.queued,
                "inflight": self._guard.inflight,
                "max_concurrency": self._guard.max_concurrency,
                "epoch": epoch, "brownout": brownout,
                "replicas": replicas}

    def quarantined(self, rank: int) -> bool:
        """True while a flapping rank's re-admission delay is running
        (harnesses/tests observe probation without reaching into the
        tracker)."""
        return self._flaps.blocked(rank)

    def replicas(self) -> List[int]:
        with self._lock:
            return sorted(self._replicas)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def wait_for_replicas(self, n: int, timeout_s: float = 30.0) -> bool:
        """Block until the membership reaches ``n`` (test/harness
        convenience — admission itself stays readyz-gated)."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            with self._lock:
                if len(self._replicas) >= n:
                    return True
            time.sleep(min(0.05, self.poll_s))
        with self._lock:
            return len(self._replicas) >= n

    # ------------------------------------------------------------ lifecycle
    @property
    def draining(self) -> bool:
        return self._guard.draining

    def drain(self, grace_s: float = 10.0) -> bool:
        """Stop admitting (DRAINING), let in-flight dispatches finish,
        then close every thread the router owns."""
        self._guard.start_drain()
        drained = self._guard.wait_idle(grace_s)
        self.close()
        return drained

    def close(self) -> None:
        """Teardown: monitor, acceptor, and metrics threads are all
        JOINED — enumerate() returns to baseline (the LC005/thread-
        hygiene contract)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._guard.start_drain()
        self._stop_evt.set()
        self._monitor.join(timeout=2 * self.poll_s
                           + 4 * self.connect_timeout_s + 5.0)
        self._server.shutdown()
        self._server.server_close()
        self._acceptor.join(timeout=5.0)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http_thread.join(timeout=5.0)
        unregister_guard(self._guard)
        flight_record("fleet", "router_closed", epoch=self.epoch)


class _MetricsHTTP(ThreadingHTTPServer):
    """Tiny observability sidecar for the router: Prometheus text at
    ``/api/metrics``, the JSON mirror at ``/api/metrics.json``, and the
    fleet ``/readyz`` (200 when ready, 503 while not)."""

    daemon_threads = True

    def __init__(self, router: FleetRouter, host: str, port: int):
        outer_router = router

        class H(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: metrics scrapes
                pass

            def _send(self, status: int, body: bytes,
                      ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path.startswith("/api/metrics.json"):
                        body = json.dumps(
                            get_registry().to_dict()).encode()
                        self._send(200, body, "application/json")
                    elif self.path.startswith("/api/metrics"):
                        body = get_registry().to_prometheus().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4")
                    elif self.path.startswith("/readyz"):
                        rz = outer_router._readyz()
                        self._send(200 if rz["ready"] else 503,
                                   json.dumps(rz).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        super().__init__((host, port), H)
