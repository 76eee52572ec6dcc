"""Service-hardening kit of the serving edge (the JAX package's
``resilience/service.py``): admission control, deadlines, circuit
breakers, health/readiness and graceful drain.

- **Admission control** — a bounded concurrency gate with a bounded
  wait queue. ``max_concurrency`` requests run; up to ``queue_depth``
  wait (never longer than the request's own deadline); everything past
  that is *shed immediately* with a structured ``SHED`` error instead
  of queueing unboundedly.
- **Deadline budgets** — every request carries a ``deadline_ms`` (or
  inherits the server default). The budget is checked at safe seams
  (before dispatch, between fit batches, after the op) and a blown
  budget returns ``DEADLINE`` and counts; the work is abandoned at the
  next seam rather than cancelled mid-update.
- **Circuit breaker** — closed -> open after ``failures`` consecutive
  failures/timeouts per backend key (model path); open requests fail
  fast with ``BREAKER_OPEN`` + ``retry_after_ms``; after a bounded,
  jittered cooldown ONE half-open probe is admitted — success closes the
  breaker, failure re-opens it with doubled cooldown.
- **Health & drain** — ``ready()`` aggregates: not draining, wait queue
  below high-water, no breaker open, plus server-specific checks (model
  loaded). ``start_drain()`` stops admitting (``DRAINING``),
  ``wait_idle(grace)`` lets in-flight work finish, then the server
  closes its listener. Guards self-register (``register_guard``) so
  ``ready_report()`` covers every server in the process.

Every structured serving error carries a machine-readable ``code`` and
renders to the wire shape with ``to_response()``. Everything observable
lands in the metrics registry (``serving_shed_total``,
``serving_deadline_exceeded_total``, ``serving_breaker_state``, ...) and
as tracer instants.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

# ---------------------------------------------------------------------------
# structured errors
# ---------------------------------------------------------------------------


class ServiceError(RuntimeError):
    """Base of every structured serving error. ``to_response()`` is the
    wire shape every server returns (the JSON envelope's ``error`` field
    carries the machine-readable code, ``message`` the human one)."""

    code = "SERVICE"

    def __init__(self, message: str = "",
                 retry_after_ms: Optional[int] = None):
        super().__init__(message or self.code)
        self.retry_after_ms = retry_after_ms

    def to_response(self) -> dict:
        resp = {"error": self.code, "message": str(self)}
        if self.retry_after_ms is not None:
            resp["retry_after_ms"] = int(self.retry_after_ms)
        return resp


class ShedError(ServiceError):
    """Admission queue full — request shed, try again later."""

    code = "SHED"


class DrainingError(ServiceError):
    """Server is draining: no new work admitted."""

    code = "DRAINING"


class DeadlineExceeded(ServiceError):
    """The request's deadline budget ran out."""

    code = "DEADLINE"


class BreakerOpen(ServiceError):
    """Circuit breaker open for this backend — failing fast."""

    code = "BREAKER_OPEN"


class NonFiniteOutput(ServiceError):
    """Inference produced NaN/Inf — never serve garbage predictions."""

    code = "NONFINITE"


class PageTableCorruption(ServiceError):
    """A decode row's KV page table failed host-side validation: an
    entry pointed outside the pool, at a freed page, or at another row's
    exclusive write page. The corrupted row fails with THIS structured
    error — it is never decoded against the bogus mapping, so cross-row
    cache garbage cannot be served."""

    code = "PAGE_TABLE"


# ---------------------------------------------------------------------------
# backoff
# ---------------------------------------------------------------------------


def backoff_delay(attempt: int, base: float, max_delay: float,
                  rng: random.Random) -> float:
    """Bounded exponential backoff with equal jitter: uniform over
    [delay/2, delay) so a fleet decorrelates while no retry is ever
    immediate."""
    delay = min(max_delay, base * (2.0 ** (max(1, attempt) - 1)))
    return delay * (0.5 + 0.5 * rng.random())


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class Deadline:
    """A monotonic deadline budget. ``None`` budget = no deadline (an
    explicit ``deadline_ms <= 0`` in a request also means unlimited —
    the escape hatch for a deliberately long fit)."""

    def __init__(self, budget_s: Optional[float]):
        self._t_end = (None if budget_s is None
                       else time.monotonic() + float(budget_s))

    @classmethod
    def from_ms(cls, ms: Optional[float]) -> "Deadline":
        if ms is None or float(ms) <= 0:
            return cls(None)
        return cls(float(ms) / 1000.0)

    @classmethod
    def from_request(cls, req: Optional[dict],
                     default_ms: Optional[float]) -> "Deadline":
        """Request-envelope ``deadline_ms`` wins over the server
        default."""
        ms = default_ms
        if req is not None and "deadline_ms" in req:
            ms = req["deadline_ms"]
        return cls.from_ms(None if ms is None else float(ms))

    def remaining(self) -> Optional[float]:
        return (None if self._t_end is None
                else self._t_end - time.monotonic())

    def expired(self) -> bool:
        return self._t_end is not None and time.monotonic() >= self._t_end

    def check(self, what: str = "request") -> None:
        """Raise (and count) at a safe seam when the budget is gone."""
        if self.expired():
            get_registry().counter(
                "serving_deadline_exceeded_total",
                help="requests whose deadline budget ran out").inc()
            raise DeadlineExceeded(f"{what}: deadline exceeded")




# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

# every live breaker in the process, for the aggregate state gauge
# (weak: a stopped server's breakers must not pin the gauge at "open")
_breakers_lock = threading.Lock()
_breakers: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()


def _update_breaker_gauge() -> None:
    with _breakers_lock:
        worst = max((b.state for b in _breakers), default=CLOSED)
    get_registry().gauge(
        "serving_breaker_state",
        help="worst circuit-breaker state in the process "
             "(0=closed, 1=half-open, 2=open)").set(worst)


class CircuitBreaker:
    """Closed/open/half-open breaker for one backend key.

    ``allow()`` must be called before dispatch; ``record_success()`` /
    ``record_failure()`` after. ``failures`` *consecutive* failures open
    the breaker for a jittered, bounded cooldown (doubling on every
    consecutive re-open); one half-open probe then decides."""

    def __init__(self, key: str = "", failures: int = 5,
                 cooldown_base: float = 0.5, cooldown_max: float = 30.0):
        self.key = key
        self.failures = max(1, int(failures))
        self.cooldown_base = cooldown_base
        self.cooldown_max = cooldown_max
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opens = 0  # consecutive open episodes (backoff exponent)
        self._open_until = 0.0
        self._probing = False
        # OS-seeded, same rationale as the consumer's reconnect jitter
        self._rng = random.Random()
        with _breakers_lock:
            _breakers.add(self)
        _update_breaker_gauge()  # gauge exists (at closed) from birth

    @property
    def state(self) -> int:
        return self._state

    def _transition(self, new: int) -> None:
        old, self._state = self._state, new
        if old != new:
            get_registry().counter(
                "serving_breaker_transitions_total",
                help="circuit-breaker state transitions").inc()
            get_tracer().instant("breaker_transition", key=self.key,
                                 frm=_STATE_NAMES[old],
                                 to=_STATE_NAMES[new])
            flight_record("service", "breaker_transition", key=self.key,
                          frm=_STATE_NAMES[old], to=_STATE_NAMES[new])
            _update_breaker_gauge()

    def retry_after_ms(self) -> int:
        with self._lock:
            return max(0, int((self._open_until - time.monotonic())
                              * 1000.0))

    def allow(self) -> bool:
        """True if a request may dispatch now. In OPEN past cooldown
        this admits exactly one half-open probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() >= self._open_until:
                    self._transition(HALF_OPEN)
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probing = False
            if self._state != CLOSED:
                self._opens = 0
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                self._open(probe_failed=True)
                return
            self._consecutive += 1
            if self._state == CLOSED and self._consecutive >= self.failures:
                self._open()

    def _open(self, probe_failed: bool = False) -> None:
        # held lock: called from record_failure only
        self._opens += 1
        cooldown = backoff_delay(self._opens, self.cooldown_base,
                                 self.cooldown_max, self._rng)
        self._open_until = time.monotonic() + cooldown
        self._consecutive = 0
        self._transition(OPEN)


# ---------------------------------------------------------------------------
# retry budget (SRE-style token bucket)
# ---------------------------------------------------------------------------


class RetryBudget:
    """Token bucket gating retry *amplification*: every retry (and every
    hedged duplicate) spends one token; every successful dispatch
    refills ``refill_ratio`` tokens, capped at ``capacity``.

    The SRE framing: retries are only safe while they stay a bounded
    fraction of successful traffic. When a backend is merely blipping,
    successes keep the bucket full and retries flow; when the whole
    pool is sick, successes dry up, the bucket drains, and retry storms
    stop amplifying the outage — callers fail fast with the structured
    error instead. Thread-safe; the bucket is shared across every
    dispatcher thread on the router."""

    def __init__(self, capacity: float = 10.0, refill_ratio: float = 0.1,
                 initial: Optional[float] = None):
        self.capacity = max(0.0, float(capacity))
        self.refill_ratio = max(0.0, float(refill_ratio))
        self._lock = threading.Lock()
        self._tokens = (self.capacity if initial is None
                        else min(self.capacity, max(0.0, float(initial))))

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def on_success(self) -> None:
        """One successful dispatch earns back a fraction of a token."""
        with self._lock:
            self._tokens = min(self.capacity,
                               self._tokens + self.refill_ratio)

    def try_spend(self, cost: float = 1.0) -> bool:
        """Spend ``cost`` tokens for one retry/hedge; False = budget
        dry, the caller must not amplify."""
        with self._lock:
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False


# ---------------------------------------------------------------------------
# the guard: admission + breakers + drain + readiness
# ---------------------------------------------------------------------------


class _Admission:
    """Token for one admitted request (context manager)."""

    def __init__(self, guard: "ServiceGuard"):
        self._guard = guard
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._guard._release(time.perf_counter() - self._t0)
        return False


class ServiceGuard:
    """One per server. ``admit()`` is the only way in; ``breaker(key)``
    hands out per-backend breakers; ``start_drain()``/``wait_idle()``
    implement graceful shutdown; ``ready()`` feeds ``/readyz`` and the
    ``health`` op. Gauges are updated via deltas so several guards in
    one process sum correctly under the shared metric names."""

    def __init__(self, name: str, max_concurrency: int = 8,
                 queue_depth: int = 16,
                 default_deadline_ms: Optional[float] = 300_000.0,
                 max_queue_wait_s: float = 5.0,
                 breaker_failures: int = 5,
                 breaker_cooldown_base: float = 0.5,
                 breaker_cooldown_max: float = 30.0,
                 breaker_slow_call_s: float = 30.0,
                 high_water: float = 0.8):
        self.name = name
        self.max_concurrency = max(1, int(max_concurrency))
        self.queue_depth = max(0, int(queue_depth))
        self.default_deadline_ms = default_deadline_ms
        self.max_queue_wait_s = max_queue_wait_s
        self.breaker_failures = breaker_failures
        self.breaker_cooldown_base = breaker_cooldown_base
        self.breaker_cooldown_max = breaker_cooldown_max
        #: a blown CLIENT deadline only counts against the backend's
        #: breaker when the dispatch itself ran at least this long —
        #: an impatient client (deadline_ms=50 on a 100 ms model) must
        #: not open the shared circuit for everyone else
        self.breaker_slow_call_s = breaker_slow_call_s
        self.high_water = high_water
        self._cond = threading.Condition()
        self._active = 0
        self._waiting = 0
        self._draining = False
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._ready_checks: List[Tuple[str, Callable[[], bool]]] = []
        # a scrape of a healthy server must still see the breaker gauge
        # (at closed), not only after the first transition
        _update_breaker_gauge()

    # -------------------------------------------------------------- metrics
    @staticmethod
    def _c(name: str, help: str = ""):
        return get_registry().counter(name, help=help)

    @staticmethod
    def _g(name: str, help: str = ""):
        return get_registry().gauge(name, help=help)

    # ------------------------------------------------------------ admission
    def admit(self, deadline: Optional[Deadline] = None) -> _Admission:
        """Admit one request or raise ``ShedError``/``DrainingError``/
        ``DeadlineExceeded``. Queued requests wait at most
        ``max_queue_wait_s`` — and never past their own deadline: a
        budget blown in (or before) the queue reports ``DEADLINE``,
        not ``SHED``, because retrying it is pointless."""
        if deadline is not None:
            deadline.check("admission")
        with self._cond:
            if self._draining:
                self._c("serving_drain_rejects_total",
                        "requests rejected because the server is "
                        "draining").inc()
                raise DrainingError(f"{self.name}: draining")
            if self._active < self.max_concurrency:
                self._active += 1
            elif self._waiting >= self.queue_depth:
                self._c("serving_shed_total",
                        "requests shed by admission control").inc()
                flight_record("service", "shed", guard=self.name,
                              inflight=self._active, queued=self._waiting)
                raise ShedError(
                    f"{self.name}: at capacity "
                    f"({self.max_concurrency} in flight, "
                    f"{self._waiting} queued)",
                    retry_after_ms=int(self.max_queue_wait_s * 1000))
            else:
                self._waiting += 1
                self._g("serving_queue_depth",
                        "requests waiting in admission queues").add(1)
                try:
                    wait_s = self.max_queue_wait_s
                    rem = None if deadline is None else deadline.remaining()
                    if rem is not None:
                        wait_s = min(wait_s, max(0.0, rem))
                    t_end = time.monotonic() + wait_s
                    while (self._active >= self.max_concurrency
                           and not self._draining):
                        left = t_end - time.monotonic()
                        if left <= 0:
                            if (deadline is not None
                                    and deadline.expired()):
                                # the REQUEST's budget ran out while
                                # queued: that is a DEADLINE, and a
                                # retry hint would be a lie
                                deadline.check("queued")
                            self._c("serving_shed_total",
                                    "requests shed by admission "
                                    "control").inc()
                            raise ShedError(
                                f"{self.name}: queued past wait budget")
                        self._cond.wait(left)
                    if self._draining:
                        self._c("serving_drain_rejects_total",
                                "requests rejected because the server "
                                "is draining").inc()
                        raise DrainingError(f"{self.name}: draining")
                    self._active += 1
                finally:
                    self._waiting -= 1
                    self._g("serving_queue_depth").add(-1)
        self._c("serving_admitted_total",
                "requests admitted for dispatch").inc()
        self._g("serving_inflight", "requests currently in flight").add(1)
        return _Admission(self)

    def _release(self, elapsed_s: float) -> None:
        get_registry().histogram(
            "serving_request_seconds",
            help="admitted request wall time").observe(elapsed_s)
        with self._cond:
            self._active -= 1
            self._cond.notify_all()
        self._g("serving_inflight").add(-1)

    @property
    def inflight(self) -> int:
        return self._active

    @property
    def queued(self) -> int:
        return self._waiting

    # ------------------------------------------------------------ deadlines
    def deadline(self, req: Optional[dict] = None) -> Deadline:
        return Deadline.from_request(req, self.default_deadline_ms)

    # ------------------------------------------------------------- breakers
    def breaker(self, key: str) -> CircuitBreaker:
        with self._breakers_lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(
                    key=f"{self.name}:{key}",
                    failures=self.breaker_failures,
                    cooldown_base=self.breaker_cooldown_base,
                    cooldown_max=self.breaker_cooldown_max)
                self._breakers[key] = b
            return b

    def open_breakers(self) -> List[str]:
        with self._breakers_lock:
            return [k for k, b in self._breakers.items()
                    if b.state == OPEN]

    # ---------------------------------------------------------------- drain
    @property
    def draining(self) -> bool:
        return self._draining

    def start_drain(self) -> None:
        """Stop admitting. Already-queued waiters are rejected; work in
        flight keeps running until it finishes or the grace runs out."""
        with self._cond:
            if self._draining:
                return
            self._draining = True
            self._cond.notify_all()
        self._c("serving_drains_total", "drains initiated").inc()
        get_tracer().instant("drain_started", guard=self.name)
        flight_record("service", "drain_started", guard=self.name)

    def wait_idle(self, grace_s: float = 10.0) -> bool:
        """Block until in-flight work finishes, up to ``grace_s``.
        Returns True when the server emptied inside the grace."""
        t_end = time.monotonic() + max(0.0, grace_s)
        with self._cond:
            while self._active > 0:
                left = t_end - time.monotonic()
                if left <= 0:
                    self._c("serving_drain_timeouts_total",
                            "drains whose grace expired with work "
                            "still in flight").inc()
                    return False
                self._cond.wait(left)
        return True

    # ------------------------------------------------------------ readiness
    def add_ready_check(self, name: str,
                        fn: Callable[[], bool]) -> None:
        """Server-specific readiness condition (e.g. 'model_loaded')."""
        self._ready_checks.append((name, fn))

    def ready(self) -> Tuple[bool, List[str]]:
        """(ready?, reasons-not-ready). Ready means: not draining, wait
        queue below high-water, no breaker open, all extra checks
        pass."""
        reasons: List[str] = []
        if self._draining:
            reasons.append("draining")
        if (self.queue_depth > 0 and self._waiting
                >= max(1, int(self.high_water * self.queue_depth))):
            reasons.append(
                f"queue above high-water ({self._waiting}/"
                f"{self.queue_depth})")
        for key in self.open_breakers():
            reasons.append(f"breaker open: {key}")
        for name, fn in self._ready_checks:
            try:
                ok = bool(fn())
            except Exception:  # a broken check is a not-ready signal
                ok = False
            if not ok:
                reasons.append(name)
        return (not reasons, reasons)


# ---------------------------------------------------------------------------
# process-wide guard registry (feeds the UI server's /readyz)
# ---------------------------------------------------------------------------

_guards_lock = threading.Lock()
_guards: Dict[str, ServiceGuard] = {}


def register_guard(guard: ServiceGuard) -> ServiceGuard:
    """Servers register their guard at start so ``/readyz`` sees every
    server in the process. Same name overwrites (restart)."""
    with _guards_lock:
        _guards[guard.name] = guard
    return guard


def unregister_guard(guard: ServiceGuard) -> None:
    with _guards_lock:
        if _guards.get(guard.name) is guard:
            del _guards[guard.name]


def ready_report() -> Tuple[bool, Dict[str, dict]]:
    """(everything ready?, per-guard {ready, reasons}) across every
    registered guard — the ``/readyz`` payload."""
    with _guards_lock:
        guards = list(_guards.values())
    report: Dict[str, dict] = {}
    all_ready = True
    for g in guards:
        ok, reasons = g.ready()
        report[g.name] = {"ready": ok, "reasons": reasons}
        all_ready = all_ready and ok
    return all_ready, report
