"""Elastic membership: the lease and heartbeat half of the JAX package's
``resilience/elastic.py`` (its ``:140-441``), which the serving fleet
(``keras/fleet.py``) runs on. ``ElasticTrainer``, the preemption-tolerant
multi-host trainer of the other half, wraps the data-parallel trainers
(``parallel/``) and waits for ROADMAP A6.3.

**Coordination is an epoch-numbered, lease-based rendezvous over a
shared directory.** The files are the JAX package's, name for name and
key for key, so either package reads what the other wrote:

- ``lease.json`` — ``{epoch, coordinator, world, pending, time}``: the
  current rendezvous epoch, the holder of the lease, the member world
  and the join requests recorded but not yet admitted. The epoch
  increments on every membership change. Single writer by protocol
  (the coordinator; the fleet's router holds it as rank -1).
- ``join_p<rank>.json`` — ``{rank, time}``: a joiner's announcement,
  re-written until it is admitted; readers may drop aged ones.
- ``hb_p<rank>.json`` — ``{rank, time, step}`` plus a static payload
  (the fleet rides ``host``/``port`` here, so a beat doubles as the
  replica's registration record): a daemon thread rewrites it every
  ``interval_s``. An orderly leave deletes it (``retire``); a crash
  leaves a stale file behind.

Every write is a tmp file renamed over the record
(``resilience/atomic.py`` ``replace_bytes``): readers never see a
prefix. These records are liveness signals, superseded by the next
write, so they skip the fsyncs and the checkpoint commit's fault hook
that a checkpoint goes through.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.atomic import replace_bytes

logger = logging.getLogger(__name__)

__all__ = ["ElasticError", "ElasticFenced", "ElasticRestartRequired",
           "ElasticTrainer", "HostHeartbeat", "LEASE_NAME",
           "clear_join_requests", "pending_join_ranks", "read_heartbeat_ages",
           "read_heartbeats", "read_lease", "request_join", "write_lease"]


class ElasticError(RuntimeError):
    """Elastic-layer failure that is NOT a survivable host loss."""


class ElasticFenced(ElasticError):
    """This host's own heartbeat stopped landing for a full timeout
    window (partition / unwritable coordination dir): its peers have —
    correctly, from their view — declared it dead and re-formed the
    world without it. The fenced host must contribute nothing further:
    no steps, no checkpoint shards."""


class ElasticRestartRequired(ElasticError):
    """The group must re-form at a new width the old runtime cannot
    reach in process — more than one survivor after a loss, or a
    scale-UP admission (``grow=True``). Carries the world the outer
    scheduler must (re)start, the ELECTED coordinator (lowest surviving
    rank, holding the lease), and the new rendezvous ``epoch`` the
    lease announces; the ``lease.json`` in the coordination directory
    is the authoritative copy of the same record."""

    def __init__(self, survivors: List[int], dead: List[int],
                 coordinator: Optional[int] = None,
                 epoch: Optional[int] = None, grow: bool = False):
        self.survivors = list(survivors)
        self.dead = list(dead)
        self.coordinator = (min(survivors) if coordinator is None
                            else int(coordinator))
        self.epoch = epoch
        self.grow = bool(grow)
        if grow:
            msg = (f"world {sorted(survivors)} admitted replacement "
                   f"host(s) at rendezvous epoch {epoch}: the outer "
                   f"scheduler restarts all {len(survivors)} process(es) "
                   f"at the grown width (coordinator rank "
                   f"{self.coordinator} holds the lease) and the sharded "
                   "state reshard-restores bitwise at the wider width")
        else:
            msg = (f"hosts {sorted(dead)} lost; surviving world "
                   f"{sorted(survivors)} elected rank {self.coordinator} "
                   f"coordinator at rendezvous epoch {epoch} and must "
                   f"restart at dp-width of {len(survivors)} process(es), "
                   "resuming from the latest checkpoint (in-process "
                   "continuation is only possible for a sole survivor)")
        super().__init__(msg)


# ---------------------------------------------------------------------------
# the rendezvous lease (epoch-numbered group membership)
# ---------------------------------------------------------------------------

LEASE_NAME = "lease.json"
_JOIN_RE = "join_p*.json"


def _lease_path(directory: Union[str, Path]) -> Path:
    return Path(directory) / LEASE_NAME


def read_lease(directory: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """The current lease record ({epoch, coordinator, world, pending,
    time}) or None when the rendezvous directory holds none yet.
    Unreadable/partial files read as None (the writer's atomic rename
    means that can only be a pre-first-lease state)."""
    try:
        d = json.loads(_lease_path(directory).read_text())
        return {"epoch": int(d["epoch"]),
                "coordinator": int(d["coordinator"]),
                "world": [int(r) for r in d["world"]],
                "pending": [int(r) for r in d.get("pending", [])],
                "time": float(d.get("time", 0.0))}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def write_lease(directory: Union[str, Path], epoch: int, world: List[int],
                coordinator: int, pending: Optional[List[int]] = None
                ) -> None:
    """Atomically publish a lease: the coordinator named here holds the
    rendezvous for ``epoch`` over ``world``. ``pending`` lists join
    requests recorded but not yet admitted. Single-writer by protocol,
    so the atomic rename is ordering, not arbitration."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    replace_bytes(_lease_path(directory), json.dumps({
        "epoch": int(epoch), "coordinator": int(coordinator),
        "world": sorted(int(r) for r in world),
        "pending": sorted(int(r) for r in (pending or [])),
        "time": time.time()}).encode())
    flight_record("elastic", "lease_written", epoch=int(epoch),
                  coordinator=int(coordinator),
                  world=",".join(str(int(r)) for r in sorted(world)))


def request_join(directory: Union[str, Path], rank: int) -> Path:
    """A (replacement) host announces itself to the rendezvous: writes
    ``join_p<rank>.json`` atomically and returns its path. Announcements
    expire for readers that pass ``max_age_s``, so a joiner re-announces
    (idempotent: each call refreshes the timestamp) until admitted; a
    leftover request from a joiner that died never enters a lease."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"join_p{int(rank)}.json"
    replace_bytes(path, json.dumps({"rank": int(rank),
                                    "time": time.time()}).encode())
    return path


def pending_join_ranks(directory: Union[str, Path],
                       max_age_s: Optional[float] = None) -> List[int]:
    """Ranks with a join request on disk (sorted; unreadable files are
    skipped — the joiner's next announcement replaces them).
    ``max_age_s`` drops requests whose announcement timestamp is
    older."""
    ranks = []
    now = time.time()
    for p in Path(directory).glob(_JOIN_RE):
        try:
            d = json.loads(p.read_text())
            if max_age_s is not None and \
                    now - float(d.get("time", 0.0)) > max_age_s:
                continue
            ranks.append(int(d["rank"]))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return sorted(set(ranks))


def clear_join_requests(directory: Union[str, Path],
                        ranks: List[int]) -> None:
    """Consume admitted join requests (coordinator-only, after the
    admission lease is published)."""
    for r in ranks:
        try:
            (Path(directory) / f"join_p{int(r)}.json").unlink()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def _heartbeat_path(directory: Path, rank: int) -> Path:
    return directory / f"hb_p{rank}.json"


class HostHeartbeat:
    """Per-process liveness beacon: a daemon thread rewrites this host's
    heartbeat file every ``interval_s`` (atomic rename, no fsync — a
    lost beat just reads as one beat older)."""

    def __init__(self, directory: Union[str, Path], rank: int,
                 interval_s: float = 0.5,
                 payload: Optional[Dict[str, object]] = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.rank = int(rank)
        self.interval_s = float(interval_s)
        # static rendezvous payload merged into every beat (rank/time/
        # step keys win)
        self.payload = dict(payload) if payload else {}
        self.step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned = False
        self._last_written = time.monotonic()

    def start(self) -> "HostHeartbeat":
        if self._thread is None:
            self.beat()
            self._thread = threading.Thread(
                target=self._run, name=f"heartbeat-p{self.rank}", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def beat(self) -> None:
        if faultinject.heartbeat_suppressed(self.rank):
            # partition_replica chaos: the process lives, its beats
            # don't land — _last_written stalls
            return
        record = dict(self.payload)
        record.update({"rank": self.rank, "time": time.time(),
                       "step": self.step})
        try:
            replace_bytes(_heartbeat_path(self.directory, self.rank),
                          json.dumps(record).encode())
            self._last_written = time.monotonic()
            self._warned = False
        except OSError as e:  # a transient disk blip must not kill the host
            if not self._warned:
                self._warned = True
                logger.warning("heartbeat write failed (will keep trying "
                               "quietly): %s", e)

    def write_stale_s(self) -> float:
        """Seconds since this host's heartbeat last LANDED on disk. Past
        the fleet's heartbeat timeout, peers are about to declare this
        host dead even though it is alive."""
        return time.monotonic() - self._last_written

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1.0)
            self._thread = None

    def retire(self) -> None:
        """Orderly leave: stop beating and delete the heartbeat file, so
        peers see the host as GONE (file absent) rather than merely
        stale. A crash, by contrast, leaves a stale file behind."""
        self.stop()
        try:
            _heartbeat_path(self.directory, self.rank).unlink()
        except OSError:
            pass


def read_heartbeat_ages(directory: Union[str, Path]) -> Dict[int, float]:
    """{rank: seconds since last beat} for every heartbeat file in
    ``directory``. Unreadable/partial files are skipped (the next beat
    replaces them)."""
    ages: Dict[int, float] = {}
    now = time.time()
    for p in Path(directory).glob("hb_p*.json"):
        try:
            d = json.loads(p.read_text())
            ages[int(d["rank"])] = max(0.0, now - float(d["time"]))
        except (OSError, ValueError, KeyError):
            continue
    return ages


def read_heartbeats(directory: Union[str, Path]
                    ) -> Dict[int, Dict[str, object]]:
    """Full heartbeat records keyed by rank: the beat's payload plus an
    ``age`` key (seconds since the beat landed). The serving fleet's
    registration read: a fresh record carrying host/port IS the
    replica's rendezvous announcement."""
    out: Dict[int, Dict[str, object]] = {}
    now = time.time()
    for p in Path(directory).glob("hb_p*.json"):
        try:
            d = json.loads(p.read_text())
            d["age"] = max(0.0, now - float(d["time"]))
            out[int(d["rank"])] = d
        except (OSError, ValueError, KeyError):
            continue
    return out


class ElasticTrainer:
    """The preemption-tolerant multi-host trainer over the data-parallel
    trainers: waits for ROADMAP A6.3 (with ``multihost``'s elastic
    runtime)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ElasticTrainer (host-loss detection, resize and reshard "
            "restore over the parallel trainers) is not ported yet "
            "(ROADMAP A6.3)")
