"""Fleet autoscaling + overload degradation controller (the JAX
package's ``keras/autoscale.py``, whole; it touches no tensor).

The fleet (``keras/fleet.py``) publishes everything a control loop
needs (per-replica ``readyz`` stats from the membership poller, router
queue depth, TTFT p99, breaker states) and its zero-drop drain seam
makes scale-down free — this module closes the loop. Three pieces, one
controller thread:

- **FleetAutoscaler** — a tick-based controller that reads one
  ``router.load_snapshot()`` per tick and drives ``spawn_fn`` /
  ``drain_fn`` callbacks toward a target SLO. Scale-up when queue depth
  or TTFT p99 breaches for ``up_ticks`` consecutive ticks; scale-down
  when the pool idles for ``down_ticks`` ticks — always through the
  replica's own drain seam (retire beat → clear join → ServiceGuard
  drain), never by killing. Hysteresis (consecutive-tick streaks) plus
  per-direction cooldowns keep oscillating load from flapping the pool.
  Every decision lands as ``fleet_autoscale_*`` counters, the
  ``fleet_target_replicas`` gauge, and a flight-recorder event, so a
  postmortem bundle explains *why* the pool was the size it was.
- **Brownout state machine** — when the breach persists while the pool
  is already at ``max_replicas`` there is nothing left to spawn; the
  controller flips the router into brownout (``router.set_brownout``)
  and the router sheds bulk-class requests with a structured ``SHED``
  while interactive traffic keeps its SLO. Exit needs ``exit_ticks``
  calm ticks (wider than entry, so the machine can't chatter).
- **FlapTracker** — probation for crash-looping replicas. A member that
  dies or partitions within ``window_s`` of admission takes a strike;
  ``strikes_to_quarantine`` strikes inside the window quarantine the
  rank with an exponentially growing, bounded, equal-jitter re-admission
  delay (``service.backoff_delay`` — the same policy every other retry
  path in the repo uses). Clean leaves (retired heartbeat) never
  strike, and a tenure longer than the window resets the count.

The controller is a real thread with a real teardown: ``drain()`` stops
the loop, JOINS it (the lockcheck LC005 invariant), and optionally
drains every replica the controller itself spawned. ``spawn_fn``/
``drain_fn`` run *outside* the controller's lock — they block on model
load and drain grace respectively, and nothing unbounded ever runs
under a lock here.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience.service import backoff_delay

logger = logging.getLogger(__name__)

#: removal reasons that count as a flap strike: the replica *vanished*
#: (kill, crash, partition). A clean leave retires its heartbeat first
#: and surfaces as "heartbeat_gone" — draining is not flapping.
STRIKE_REASONS = frozenset({"stale_heartbeat", "dead_connection"})


class FlapTracker:
    """Per-rank probation for replicas that join and die repeatedly.

    The router calls ``on_admit(rank)`` when it admits a member and
    ``on_remove(rank, reason)`` when it removes one; the membership scan
    consults ``blocked(rank)`` before probing a candidate. All methods
    take only the tracker's own leaf lock (nothing else is called under
    it), so it composes with the router's locks in any order."""

    def __init__(self, window_s: float = 5.0,
                 strikes_to_quarantine: int = 2,
                 base_s: float = 2.0, max_s: float = 60.0,
                 rng: Optional[random.Random] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.strikes_to_quarantine = max(1, int(strikes_to_quarantine))
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self._rng = rng if rng is not None else random.Random()
        self._now = now_fn
        self._lock = threading.Lock()
        # rank -> {"admitted_at": float|None, "strikes": int,
        #          "blocked_until": float}
        self._records: Dict[int, Dict[str, Any]] = {}

    def _rec(self, rank: int) -> Dict[str, Any]:
        return self._records.setdefault(
            int(rank), {"admitted_at": None, "strikes": 0,
                        "blocked_until": 0.0})

    def on_admit(self, rank: int) -> None:
        with self._lock:
            self._rec(rank)["admitted_at"] = self._now()

    def on_remove(self, rank: int, reason: str) -> Optional[float]:
        """Record a removal; returns the quarantine delay (seconds) when
        this removal tipped the rank into (deeper) probation, else
        None."""
        with self._lock:
            rec = self._rec(rank)
            admitted, rec["admitted_at"] = rec["admitted_at"], None
            if reason not in STRIKE_REASONS or admitted is None:
                return None
            now = self._now()
            if now - admitted > self.window_s:
                # it served long enough: that is a failure, not a flap
                rec["strikes"] = 0
                return None
            rec["strikes"] += 1
            if rec["strikes"] < self.strikes_to_quarantine:
                return None
            episode = rec["strikes"] - self.strikes_to_quarantine + 1
            delay = backoff_delay(episode, self.base_s, self.max_s,
                                  self._rng)
            rec["blocked_until"] = now + delay
            return delay

    def blocked(self, rank: int) -> bool:
        with self._lock:
            rec = self._records.get(int(rank))
            return (rec is not None
                    and self._now() < rec["blocked_until"])

    def strikes(self, rank: int) -> int:
        with self._lock:
            rec = self._records.get(int(rank))
            return 0 if rec is None else int(rec["strikes"])

    def forget(self, rank: int) -> None:
        """Drop a rank's history (operator override)."""
        with self._lock:
            self._records.pop(int(rank), None)


class FleetAutoscaler:
    """SLO-driven controller for a FleetRouter's replica pool.

    ``spawn_fn(rank) -> handle`` must bring up a replica that joins the
    router's rendezvous directory (an in-process ``FleetReplica``
    factory in tests/smoke; a process/VM launcher in production) and
    return a handle; ``drain_fn(rank, handle) -> bool`` retires it
    (default: ``handle.drain(drain_grace_s)`` — the zero-drop seam).
    The controller only ever drains replicas *it* spawned; pre-existing
    members are the operator's.

    ``tick()`` is the whole policy and is safe to call manually
    (``start=False`` + an injected ``now_fn`` make the tests
    deterministic); the controller thread just calls it every
    ``tick_s``. ``drain()`` stops and joins the thread."""

    def __init__(self, router: Any,
                 spawn_fn: Callable[[int], Any],
                 drain_fn: Optional[Callable[[int, Any], bool]] = None,
                 *,
                 min_replicas: int = 1, max_replicas: int = 3,
                 queue_high: int = 4,
                 slo_ttft_p99_ms: Optional[float] = None,
                 breach_on_open_breaker: bool = True,
                 up_ticks: int = 3, down_ticks: int = 10,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 10.0,
                 brownout: bool = True,
                 brownout_enter_ticks: int = 6,
                 brownout_exit_ticks: int = 4,
                 tick_s: float = 0.5,
                 drain_grace_s: float = 15.0,
                 spawn_grace_s: float = 30.0,
                 start: bool = True,
                 now_fn: Callable[[], float] = time.monotonic):
        self.router = router
        self.spawn_fn = spawn_fn
        self.drain_fn = drain_fn
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.queue_high = max(1, int(queue_high))
        self.slo_ttft_p99_ms = (None if slo_ttft_p99_ms is None
                                else float(slo_ttft_p99_ms))
        self.breach_on_open_breaker = bool(breach_on_open_breaker)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.brownout_enabled = bool(brownout)
        self.brownout_enter_ticks = max(1, int(brownout_enter_ticks))
        self.brownout_exit_ticks = max(1, int(brownout_exit_ticks))
        self.tick_s = float(tick_s)
        self.drain_grace_s = float(drain_grace_s)
        self.spawn_grace_s = float(spawn_grace_s)
        self._now = now_fn

        # controller state: mutated only on the tick caller (the
        # controller thread, or the test driving tick() by hand) —
        # _lock guards the handle map, which drain()/handles() read
        # from other threads
        self._lock = threading.Lock()
        self._owned: Dict[int, Any] = {}
        self._spawned_at: Dict[int, float] = {}
        self._was_member: Set[int] = set()
        self._next_rank = 0
        self._breach_streak = 0
        self._calm_streak = 0
        self._idle_streak = 0
        self._next_up_at = 0.0
        self._next_down_at = 0.0
        self._brownout = False

        reg = get_registry()
        self._m_up = reg.counter(
            "fleet_autoscale_up_total", help="autoscaler scale-up spawns")
        self._m_down = reg.counter(
            "fleet_autoscale_down_total",
            help="autoscaler scale-down drains")
        self._m_decisions = reg.labeled_counter(
            "fleet_autoscale_decisions_total",
            help="autoscaler tick decisions by action/reason")
        self._m_spawn_failures = reg.counter(
            "fleet_autoscale_spawn_failures_total",
            help="spawn_fn raised or the spawn never joined")
        self._m_brownout_entries = reg.counter(
            "fleet_brownout_entries_total",
            help="brownout episodes entered")
        self._g_target = reg.gauge(
            "fleet_target_replicas",
            help="autoscaler's current target pool size")
        self._g_target.set(max(self.min_replicas, 1))

        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._drained = False
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-autoscaler", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ signals
    def _read_breach(self, snap: dict) -> List[str]:
        """Reasons the current snapshot violates the SLO (empty = no
        breach)."""
        reasons: List[str] = []
        queued = int(snap.get("queued", 0))
        if queued >= self.queue_high:
            reasons.append(f"queue_depth={queued}>={self.queue_high}")
        worst_ttft = max(
            (float(r.get("ttft_p99_ms") or 0.0)
             for r in snap.get("replicas", {}).values()), default=0.0)
        if (self.slo_ttft_p99_ms is not None
                and worst_ttft > self.slo_ttft_p99_ms):
            reasons.append(
                f"ttft_p99={worst_ttft:.0f}ms>{self.slo_ttft_p99_ms:.0f}ms")
        if self.breach_on_open_breaker:
            opened = [r for r, st in snap.get("replicas", {}).items()
                      if st.get("breaker") == 2]
            if opened:
                reasons.append(f"breakers_open={sorted(opened)}")
        return reasons

    def _is_idle(self, snap: dict) -> bool:
        """Quiet enough to consider shrinking: nothing queued, no open
        breaker, TTFT comfortably under the SLO."""
        if int(snap.get("queued", 0)) > 0:
            return False
        for st in snap.get("replicas", {}).values():
            if st.get("breaker") == 2:
                return False
            ttft = float(st.get("ttft_p99_ms") or 0.0)
            if (self.slo_ttft_p99_ms is not None
                    and ttft > 0.5 * self.slo_ttft_p99_ms):
                return False
        return True

    # ----------------------------------------------------------- ownership
    def _reconcile_owned(self, members: Set[int], now: float) -> None:
        """Forget handles for owned replicas that are gone: a spawn
        that never joined inside ``spawn_grace_s`` failed; a member
        that vanished died (the flap tracker, not us, judges it)."""
        with self._lock:
            for rank in list(self._owned):
                if rank in members:
                    self._was_member.add(rank)
                    continue
                if rank in self._was_member:
                    self._owned.pop(rank, None)
                    self._spawned_at.pop(rank, None)
                elif now - self._spawned_at.get(rank, now) \
                        > self.spawn_grace_s:
                    self._owned.pop(rank, None)
                    self._spawned_at.pop(rank, None)
                    self._m_spawn_failures.inc()
                    flight_record("autoscale", "spawn_abandoned",
                                  rank=rank)

    def _pending_spawn(self, members: Set[int]) -> bool:
        with self._lock:
            return any(r not in members for r in self._owned)

    def _fresh_rank(self, members: Set[int]) -> int:
        with self._lock:
            used = members | set(self._owned) | self._was_member
        rank = max([self._next_rank] + [r + 1 for r in used])
        self._next_rank = rank + 1
        return rank

    def handles(self) -> Dict[int, Any]:
        """The replicas this controller spawned and still tracks."""
        with self._lock:
            return dict(self._owned)

    # ---------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One control decision. Returns the decision record (what the
        flight event carries) for tests and callers."""
        snap = self.router.load_snapshot()
        members: Set[int] = set(snap.get("replicas", {}))
        now = self._now()
        self._reconcile_owned(members, now)
        n = len(members)

        reasons = self._read_breach(snap)
        breach = bool(reasons)
        if breach:
            self._breach_streak += 1
            self._calm_streak = 0
            self._idle_streak = 0
        else:
            self._breach_streak = 0
            self._calm_streak += 1
            self._idle_streak = (self._idle_streak + 1
                                 if self._is_idle(snap) else 0)

        decision = {"action": "hold", "reason": "steady", "members": n,
                    "epoch": snap.get("epoch"), "breach": breach}
        if breach and self._breach_streak >= self.up_ticks:
            decision.update(self._try_scale_up(members, now, reasons))
        elif (not breach and self._idle_streak >= self.down_ticks
              and n > self.min_replicas):
            decision.update(self._try_scale_down(snap, members, now))

        self._update_brownout(breach, n, reasons)
        self._m_decisions.labels(action=decision["action"]).inc()
        return decision

    def _try_scale_up(self, members: Set[int], now: float,
                      reasons: List[str]) -> dict:
        if len(members) >= self.max_replicas:
            return {"action": "hold", "reason": "at_max"}
        if self._pending_spawn(members):
            return {"action": "hold", "reason": "spawn_pending"}
        if now < self._next_up_at:
            return {"action": "hold", "reason": "up_cooldown"}
        rank = self._fresh_rank(members)
        try:
            handle = self.spawn_fn(rank)
        except Exception as exc:  # the pool must survive a bad launcher
            logger.exception("autoscale: spawn_fn(%d) failed", rank)
            self._m_spawn_failures.inc()
            flight_record("autoscale", "spawn_failed", rank=rank,
                          error=repr(exc))
            return {"action": "hold", "reason": "spawn_failed"}
        with self._lock:
            self._owned[rank] = handle
            self._spawned_at[rank] = now
        self._next_up_at = now + self.up_cooldown_s
        target = min(self.max_replicas, len(members) + 1)
        self._g_target.set(target)
        self._m_up.inc()
        why = ";".join(reasons)
        get_tracer().instant("autoscale_up", rank=rank, reason=why)
        flight_record("autoscale", "scale_up", rank=rank, reason=why,
                      members=len(members), target=target)
        return {"action": "up", "reason": why, "rank": rank}

    def _try_scale_down(self, snap: dict, members: Set[int],
                        now: float) -> dict:
        if now < self._next_down_at:
            return {"action": "hold", "reason": "down_cooldown"}
        with self._lock:
            candidates = [r for r in self._owned if r in members]
        if not candidates:
            return {"action": "hold", "reason": "no_owned_member"}
        # retire the least-loaded owned member (ties: highest rank, so
        # repeated downs peel the newest spawns first)
        stats = snap.get("replicas", {})
        victim = min(candidates,
                     key=lambda r: (float(stats.get(r, {}).get("score",
                                                               0.0)), -r))
        with self._lock:
            handle = self._owned.pop(victim, None)
            self._spawned_at.pop(victim, None)
        self._next_down_at = now + self.down_cooldown_s
        target = max(self.min_replicas, len(members) - 1)
        self._g_target.set(target)
        self._m_down.inc()
        get_tracer().instant("autoscale_down", rank=victim)
        flight_record("autoscale", "scale_down", rank=victim,
                      members=len(members), target=target)
        # the drain itself runs on the tick caller, outside every lock:
        # it blocks for up to drain_grace_s by design (zero-drop seam)
        emptied = self._drain_handle(victim, handle)
        flight_record("autoscale", "scale_down_drained", rank=victim,
                      emptied=bool(emptied))
        return {"action": "down", "reason": "idle", "rank": victim,
                "emptied": bool(emptied)}

    def _drain_handle(self, rank: int, handle: Any) -> bool:
        try:
            if self.drain_fn is not None:
                return bool(self.drain_fn(rank, handle))
            return bool(handle.drain(self.drain_grace_s))
        except Exception:
            logger.exception("autoscale: drain of replica %d failed", rank)
            return False

    def _update_brownout(self, breach: bool, members: int,
                         reasons: List[str]) -> None:
        if not self.brownout_enabled:
            return
        if (not self._brownout and breach
                and members >= self.max_replicas
                and self._breach_streak >= self.brownout_enter_ticks):
            self._brownout = True
            self._m_brownout_entries.inc()
            self.router.set_brownout(True, reason=";".join(reasons))
        elif (self._brownout
                and self._calm_streak >= self.brownout_exit_ticks):
            self._brownout = False
            self.router.set_brownout(False, reason="recovered")

    # ------------------------------------------------------------ lifecycle
    def _loop(self) -> None:
        while not self._stop_evt.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # a bad tick must not kill the controller
                logger.exception("autoscale tick failed")

    def drain(self, drain_owned: bool = False) -> None:
        """Stop the controller and JOIN its thread; with
        ``drain_owned=True`` also retire (zero-drop) every replica this
        controller spawned. Idempotent."""
        with self._lock:
            if self._drained:
                return
            self._drained = True
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 4 * self.tick_s))
            self._thread = None
        if drain_owned:
            for rank, handle in sorted(self.handles().items()):
                self._drain_handle(rank, handle)
                with self._lock:
                    self._owned.pop(rank, None)
                    self._spawned_at.pop(rank, None)
        flight_record("autoscale", "controller_drained",
                      owned=len(self.handles()))

    def close(self) -> None:
        self.drain()
