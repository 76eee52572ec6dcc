"""Serving errors, backoff and deadlines (the JAX package's
``resilience/service.py``, the parts the generation engine uses).

Every structured serving error carries a machine-readable ``code`` and
renders to the wire shape with ``to_response()``. ``Deadline`` is a
request's monotonic budget, checked at safe seams (before enqueue, in
flight, at each decode step). ``ServiceGuard`` (admission control and
drain), ``CircuitBreaker`` and ``RetryBudget`` come with the server
(ROADMAP A5, part 2).
"""

from __future__ import annotations

import random
import time
from typing import Optional

from deeplearning4j_tpu_torch.profiling.metrics import get_registry

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
