"""Elastic, preemption-tolerant multi-process training (the JAX package's
``resilience/elastic.py``): the lease and heartbeat records, which the
serving fleet (``keras/fleet.py``) runs on too, and ``ElasticTrainer``
over the data-parallel trainers (``parallel/``).

``ElasticTrainer`` detects a lost host, resizes to the survivors,
reshard-restores the latest valid sharded checkpoint and resumes the
cursor's unconsumed tail exactly:

- **Detect.** Every process rewrites a heartbeat file; every step runs in
  a worker thread behind a bounded barrier wait. A stuck or failed step
  with a stale peer heartbeat is a lost host; a stuck step with fresh
  peers is a straggler (``elastic_barrier_timeouts_total``, waited out
  ``max_barrier_waits`` times, then ``ElasticError``): never a silent
  hang. The open span ``elastic:step_barrier`` names the stuck step.
- **Elect and resize.** The lowest surviving rank takes the lease at the
  next rendezvous epoch. A sole survivor continues in process: it
  installs the world of one (``multihost.set_topology_override``),
  quarantines the old process group (``multihost.quarantine_group``: no
  collective, no ``destroy_process_group``, a step thread may still be
  inside one of its collectives) and rebuilds net, mesh (world 1, no
  group), manager and trainer from the factory. More survivors raise
  ``ElasticRestartRequired``: a torch process group cannot re-form in
  process, so the launcher restarts them at the new width (their
  ``multihost.initialize(..., elastic=True, rendezvous_epoch=e)`` joins
  a store of that epoch's own) and the same code resumes them.
- **Reshard-restore.** The sharded checkpoint is restored with
  ``reshard=True`` before the trainer attaches: ZeRO ``(dp_old, chunk)``
  rows un-pad into whole moments, which the new trainer lays out at its
  width (at world 1 zero1 and zero2 run replicated).
- **Resume exactly.** The cursor's epoch, step, generator and batch order
  are applied and the tail replays in the recorded order verbatim;
  trajectory entries past the restore point are dropped, so every batch
  is consumed once. The restart of a clean run from the same checkpoint
  at the same width computes the same losses bit for bit.
- **Scale up.** A joiner's request (``request_join``; the ``rejoin_host``
  fault) is recorded in the lease at the coordinator's next checkpoint
  and admitted at the next epoch boundary (``ElasticRestartRequired(
  grow=True)``); admission needs ``checkpoint_every >= 1``.
- **Fence.** A host whose own heartbeat has not landed for a timeout
  window (``partition_host``) raises ``ElasticFenced`` before any
  further step or checkpoint shard; a lease that moved on without this
  rank fences it too, one that moved on with it is followed.

Every detection, resize, election, admission and fence is counted
(``elastic_*``, ``resilience_host_failures_total``, the ``elastic_epoch``
and ``elastic_dp_width`` gauges) and traced under the JAX package's span
and instant names; the ``elastic`` watchdog heartbeat fires before every
step's barrier.

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

import torch

from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.profiling.watchdog import (
    beat as watchdog_beat,
)
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.atomic import (
    CheckpointError, replace_bytes,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (
    FaultInjected, KilledByFault,
)
from deeplearning4j_tpu_torch.resilience.manager import (
    SHARDED_WUS_MODES, CheckpointManager, TrainingCursor,
)
from deeplearning4j_tpu_torch.resilience.sentinel import (
    DivergenceError, RollbackRequested,
)

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


class _HostsLost(Exception):
    """Internal control flow: the detection verdict naming the dead
    ranks."""

    def __init__(self, dead: List[int], where: str):
        self.dead = list(dead)
        self.where = where
        super().__init__(f"hosts {sorted(dead)} lost ({where})")


#: exceptions a step may raise that are not host-failure symptoms: they
#: pass straight through to the caller (sentinel policies, scheduled
#: chaos, an operator's interrupt)
_PASSTHROUGH = (RollbackRequested, DivergenceError, KilledByFault,
                FaultInjected, KeyboardInterrupt)


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
    """Preemption-tolerant data-parallel training over ``ParallelTrainer``:
    detect a lost host, resize to the survivors, reshard-restore the latest
    valid sharded checkpoint, resume the cursor's unconsumed tail exactly
    (see the module docstring).

    ``net_factory`` returns a fresh initialized container, the same
    configuration every call, on the device to train on: after a resize
    nothing of the old net is touched (a step thread may still hold it),
    everything is rebuilt from the factory and the checkpoint.

    Every process of the world runs the same ``fit`` on the same global
    batches, each training on its rows of every batch at the surviving
    width (a sole survivor trains on the whole batch: the trajectory a
    clean run at world 1 computes). Call ``multihost.initialize(...,
    elastic=True)`` first for a world of more than one process.
    """

    def __init__(self, net_factory, checkpoint_dir: Union[str, Path], *,
                 heartbeat_dir: Optional[Union[str, Path]] = None,
                 weight_update_sharding=None,
                 gradient_accumulation: int = 1,
                 checkpoint_every: int = 1,
                 keep_last: int = 5,
                 step_timeout_s: float = 60.0,
                 max_barrier_waits: int = 10,
                 heartbeat_interval_s: float = 0.5,
                 heartbeat_timeout_s: float = 10.0,
                 commit_timeout_s: float = 120.0,
                 sentinel=None,
                 resume: bool = True,
                 collect_consumption: bool = True):
        from deeplearning4j_tpu_torch.parallel import multihost
        from deeplearning4j_tpu_torch.parallel.mesh import (
            WeightUpdateSharding,
        )
        self._factory = net_factory
        self.checkpoint_dir = Path(checkpoint_dir)
        self.heartbeat_dir = Path(heartbeat_dir
                                  if heartbeat_dir is not None
                                  else self.checkpoint_dir / "heartbeats")
        self._wus = WeightUpdateSharding.parse(weight_update_sharding)
        self.gradient_accumulation = max(1, int(gradient_accumulation))
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.keep_last = keep_last
        self.step_timeout_s = float(step_timeout_s)
        self.max_barrier_waits = max(1, int(max_barrier_waits))
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        #: join announcements older than this never enter a lease (a
        #: joiner re-announces until admitted)
        self.join_ttl_s = max(60.0, 20.0 * self.heartbeat_timeout_s)
        self.commit_timeout_s = float(commit_timeout_s)
        self.sentinel = sentinel
        self.resume = resume
        self.collect_consumption = collect_consumption

        self._multihost = multihost
        self._rank = multihost.process_index()       # the original rank
        self._world = list(range(multihost.process_count()))
        self.net = None
        self.trainer = None
        self.manager: Optional[CheckpointManager] = None
        self.mesh = None
        self._cursor: Optional[TrainingCursor] = None
        #: the step threads started (a thread abandoned on a dead world
        #: may outlive its step; ``close`` joins what it can)
        self._step_threads: List[threading.Thread] = []
        #: the committed step log: [{"step", "epoch", "index", "loss"}],
        #: cut back to the restore point on every recovery
        self.trajectory: List[Dict[str, Any]] = []

        reg = get_registry()
        self._c_host_failures = reg.counter(
            "resilience_host_failures_total",
            help="lost/preempted hosts detected by ElasticTrainer")
        self._c_resizes = reg.counter(
            "elastic_resizes_total",
            help="in-process mesh resizes after a host loss")
        self._c_barrier_timeouts = reg.counter(
            "elastic_barrier_timeouts_total",
            help="step-barrier waits that timed out with all hosts alive "
                 "(straggler detections)")
        self._c_reshard_restores = reg.counter(
            "elastic_reshard_restores_total",
            help="checkpoint restores across a dp-width change")
        self._c_elections = reg.counter(
            "elastic_elections_total",
            help="coordinator elections this process participated in "
                 "(lowest surviving rank takes the lease)")
        self._c_scale_ups = reg.counter(
            "elastic_scale_ups_total",
            help="scale-UP admissions: replacement hosts admitted at an "
                 "epoch boundary, growing the mesh")
        self._c_fenced = reg.counter(
            "elastic_fenced_total",
            help="self-fencing events: this host's own heartbeat went "
                 "stale past the fleet timeout and it refused to keep "
                 "training/committing into a re-formed world")
        self._g_dp = reg.gauge(
            "elastic_dp_width", help="current data-parallel width")
        self._g_epoch = reg.gauge(
            "elastic_epoch",
            help="current rendezvous epoch (+1 per membership change, "
                 "shrink or grow)")

        # adopt (or found) the lease: a fresh world starts at epoch 0 with
        # rank 0 holding it; a restarted world finds the lease its
        # election or admission published, and the new coordinator
        # re-anchors it over the renumbered world
        lease = read_lease(self.heartbeat_dir)
        self.rdv_epoch = int(lease["epoch"]) if lease else 0
        if self._rank == min(self._world) and (
                lease is None or lease["world"] != sorted(self._world)):
            write_lease(self.heartbeat_dir, self.rdv_epoch, self._world,
                        self._rank, pending=self._pending_for_lease())

        self._input_sig: Optional[Dict[str, Any]] = None
        self._hb = HostHeartbeat(self.heartbeat_dir, self._rank,
                                 heartbeat_interval_s).start()
        self._bootstrap(initial=True)

    # --------------------------------------------------------------- topology
    def _bootstrap(self, initial: bool = False) -> None:
        """(Re)build net, mesh, manager and trainer for the current world
        and reshard-restore the latest valid checkpoint: startup (also a
        restart at a new width) and an in-process resize alike."""
        from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
        from deeplearning4j_tpu_torch.parallel.trainer import (
            ParallelTrainer,
        )
        mh = self._multihost
        mh.set_rendezvous_epoch(self.rdv_epoch)
        self._g_epoch.set(self.rdv_epoch)
        if len(self._world) != mh.process_count():
            mh.set_topology_override(len(self._world),
                                     self._world.index(self._rank))
        dp = mh.effective_process_count()
        wus = self._wus if (self._wus.enabled and dp >= 2) else None
        if self._wus.enabled and dp < 2:
            logger.warning("dp width %d cannot carry %s weight-update "
                           "sharding; continuing with the replicated "
                           "layout", dp, self._wus.mode)
        with get_tracer().span("elastic:bootstrap", dp=dp,
                               world=len(self._world)):
            net = self._factory()
            self.mesh = MeshContext.create(device=net.device)
            if self.sentinel is not None:
                net.set_divergence_sentinel(self.sentinel)
            self.manager = CheckpointManager(
                self.checkpoint_dir, keep_last=self.keep_last,
                sharded=True, mesh_ctx=self.mesh,
                weight_update_sharding=wus.mode if wus else "off",
                commit_timeout=self.commit_timeout_s)
            cursor = None
            if self.resume or not initial:
                info = self.manager.latest_valid()
                if info is not None:
                    saved = info.cursor.topology if info.cursor else None
                    resharding = bool(
                        saved and saved.get("weight_update_sharding")
                        in SHARDED_WUS_MODES
                        and int(saved.get("dp", dp)) != dp)
                    # restore BEFORE the trainer attaches: ZeRO rows
                    # un-pad into the fresh net's whole moments, which
                    # the trainer then lays out at this width
                    cursor = self.manager.restore(net, info, reshard=True)
                    if resharding:
                        self._c_reshard_restores.inc()
                        get_tracer().instant(
                            "reshard_restore",
                            saved_dp=int(saved.get("dp", 0)), dp=dp)
            self.net = net
            self.trainer = ParallelTrainer(
                net, self.mesh,
                gradient_accumulation=self.gradient_accumulation,
                weight_update_sharding=wus)
        self._cursor = cursor
        self._g_dp.set(dp)
        # entries past the restore point died with the old world (and
        # all of them when no checkpoint was found: the epoch replays)
        self.trajectory = [e for e in self.trajectory
                           if cursor is not None
                           and e["step"] <= cursor.step]
        if cursor is not None:
            logger.info("resumed at dp=%d from step %d (epoch %d, "
                        "batch %d)", dp, cursor.step, cursor.epoch,
                        cursor.data_position)

    # -------------------------------------------------------------- detection
    def _peer_ages(self) -> Dict[int, float]:
        ages = read_heartbeat_ages(self.heartbeat_dir)
        return {r: ages.get(r, float("inf"))
                for r in self._world if r != self._rank}

    def _dead_hosts(self) -> List[int]:
        return [r for r, age in self._peer_ages().items()
                if age > self.heartbeat_timeout_s]

    def _await_staleness(self) -> List[int]:
        """After a step raised: wait out the heartbeat window to tell a
        dead peer (its file goes stale) from a genuine error (the peers
        keep beating). Bounded by the window and 2 s."""
        deadline = time.monotonic() + self.heartbeat_timeout_s + 2.0
        while time.monotonic() < deadline:
            dead = self._dead_hosts()
            if dead:
                return dead
            time.sleep(min(0.2, self.heartbeat_timeout_s / 4))
        return []

    # ------------------------------------------------------------------ steps
    def _check_batch(self, batch) -> None:
        """Refuse, before the step thread starts, a batch the surviving
        width and the gradient accumulation cannot split into equal
        rows."""
        B, dp = batch.num_examples(), self.mesh.n_data
        k = self.gradient_accumulation
        if B % (dp * k):
            raise ElasticError(
                f"global batch {B} is not divisible by the surviving dp "
                f"width {dp} times the gradient accumulation {k}")

    def _guarded_step(self, batch, step_id: int) -> float:
        """One step under the elastic contract: the chaos hooks, the step
        in a worker thread, a bounded barrier wait that reads the peers'
        heartbeats. Raises ``_HostsLost`` on a detected death and
        ``ElasticError`` when the waits run out with every peer alive;
        never hangs."""
        tracer = get_tracer()
        stall = faultinject.host_step_stall(step_id)
        if stall:
            with tracer.span("elastic:straggle", step=step_id,
                             duration=stall):
                time.sleep(stall)
        faultinject.check_kill(step_id)
        faultinject.check_partition(step_id)
        join_rank = faultinject.check_rejoin(step_id)
        if join_rank is not None:
            # the simulated replacement's announcement: admitted at the
            # next epoch boundary through the lease's snapshot
            if join_rank < 0:
                join_rank = next(r for r in range(len(self._world) + 1)
                                 if r not in self._world)
            request_join(self.heartbeat_dir, join_rank)
        self._check_fence(f"step {step_id}")
        self._check_batch(batch)
        self._hb.step = step_id
        # the last beat before the barrier: a step wedged in a straggle,
        # the dispatch or a collective goes stale and a bundle's open
        # spans name the stuck phase
        watchdog_beat("elastic")
        flight_record("elastic", "step", step=step_id,
                      epoch=self.rdv_epoch)
        box: Dict[str, Any] = {}
        done = threading.Event()
        trainer, device = self.trainer, self.net.device
        sync = self._multihost.gloo_collectives_active() and \
            device.type == "cuda"

        def run():
            try:
                # float() waits for the loss inside the abandonable
                # thread: a collective stuck on a dead peer hangs here,
                # not on the caller's thread
                box["loss"] = float(trainer.fit_batch(batch))
                if sync:
                    # gloo stages CUDA tensors through the host on its
                    # own threads: the step is done when the card is
                    torch.cuda.synchronize(device)
            except BaseException as e:  # noqa: BLE001 (relayed below)
                box["exc"] = e
            finally:
                done.set()

        worker = threading.Thread(target=run, daemon=True,
                                  name=f"elastic-step-{step_id}")
        self._step_threads = [t for t in self._step_threads
                              if t.is_alive()] + [worker]
        with tracer.span("elastic:step_barrier", step=step_id):
            worker.start()
            waits = 0
            while not done.wait(self.step_timeout_s):
                dead = self._dead_hosts()
                if dead:
                    raise _HostsLost(dead, f"step {step_id} barrier")
                waits += 1
                self._c_barrier_timeouts.inc()
                tracer.instant("barrier_timeout", step=step_id,
                               waits=waits)
                flight_record("elastic", "barrier_timeout", step=step_id,
                              waits=waits)
                logger.warning(
                    "step %d barrier timed out (%.1fs, wait %d/%d) with "
                    "all hosts alive: a straggler; waiting on", step_id,
                    self.step_timeout_s, waits, self.max_barrier_waits)
                if waits >= self.max_barrier_waits:
                    raise ElasticError(
                        f"step {step_id} still stuck after "
                        f"{waits * self.step_timeout_s:.0f}s with every "
                        "host's heartbeat fresh: not a host failure; "
                        "giving up instead of hanging")
        if "exc" in box:
            e = box["exc"]
            if isinstance(e, _PASSTHROUGH):
                raise e
            dead = self._await_staleness()
            if dead:
                logger.warning("step %d failed (%s) and hosts %s went "
                               "stale: a host loss", step_id,
                               type(e).__name__, sorted(dead))
                raise _HostsLost(dead, f"step {step_id}: "
                                       f"{type(e).__name__}") from e
            raise e
        return box["loss"]

    # ---------------------------------------------------------------- fencing
    def _check_fence(self, where: str) -> None:
        """Before every step and every checkpoint write: once this host's
        own heartbeat has not landed for a timeout window, its peers have
        declared it dead and re-formed; a further step or shard would be a
        split brain, so raise ``ElasticFenced``."""
        if len(self._world) <= 1:
            return
        stale = self._hb.write_stale_s()
        if stale <= self.heartbeat_timeout_s:
            return
        self._c_fenced.inc()
        get_tracer().instant("elastic_fenced", where=where,
                             stale_s=round(stale, 3))
        flight_record("elastic", "fenced", where=where,
                      stale_s=round(stale, 3))
        raise ElasticFenced(
            f"this host's heartbeat has not been written for "
            f"{stale:.1f}s (> {self.heartbeat_timeout_s}s) at {where}: "
            "peers have declared it dead and re-formed the world; "
            "self-fencing: no further steps or checkpoint shards from "
            "this process (a partition, or an unwritable rendezvous "
            "directory?)")

    # ----------------------------------------------------------------- resize
    def _on_hosts_lost(self, lost: _HostsLost) -> None:
        """Detection verdict to election: the lowest surviving rank writes
        the next epoch's lease (every survivor reaches the same verdict
        from the same files). A sole survivor continues in process; more
        survivors raise ``ElasticRestartRequired``."""
        tracer = get_tracer()
        for r in sorted(set(lost.dead)):
            self._c_host_failures.inc()
            tracer.instant("host_failure", rank=r, where=lost.where)
            flight_record("elastic", "host_failure", rank=r,
                          where=lost.where)
        self._follow_newer_lease(f"host loss at {lost.where}")
        survivors = [r for r in self._world if r not in lost.dead]
        if self._rank not in survivors:
            raise ElasticError("this process was declared dead by its own "
                               "detector (heartbeat directory clock "
                               "skew?)")
        elected = min(survivors)
        new_epoch = self.rdv_epoch + 1
        self._c_elections.inc()
        tracer.instant("elastic_election", epoch=new_epoch,
                       coordinator=elected, dead=sorted(set(lost.dead)))
        flight_record("elastic", "election", epoch=new_epoch,
                      coordinator=elected,
                      dead=",".join(map(str, sorted(set(lost.dead)))))
        logger.warning(
            "host(s) %s lost at %s; surviving world %s elected rank %d "
            "coordinator at rendezvous epoch %d", sorted(set(lost.dead)),
            lost.where, survivors, elected, new_epoch)
        self._world = survivors
        self.rdv_epoch = new_epoch
        if self._rank == elected:
            # the winner takes the lease, a sole survivor of the original
            # coordinator's death included
            write_lease(self.heartbeat_dir, new_epoch, survivors, elected,
                        pending=self._pending_for_lease(world=survivors))
        if len(survivors) > 1:
            raise ElasticRestartRequired(survivors, lost.dead,
                                         coordinator=elected,
                                         epoch=new_epoch)
        old_dp = self.mesh.n_data if self.mesh else 0
        if self._multihost.process_count() > 1:
            # the old group is dead to this process from here on
            self._multihost.quarantine_group()
        with tracer.span("elastic:resize", old_dp=old_dp):
            self._c_resizes.inc()
            self._bootstrap()
        tracer.instant("elastic_resize", old_dp=old_dp,
                       new_dp=self.mesh.n_data)

    def _follow_newer_lease(self, where: str) -> Optional[Dict[str, Any]]:
        """The lease is authoritative and epochs only move forward: a
        member that finds a lease newer than its epoch follows it
        (``ElasticRestartRequired`` with the lease's record) or, when the
        lease's world leaves it out, fences itself. Returns the one lease
        snapshot it read when it does not raise; callers deciding on its
        contents reuse that snapshot rather than reading again."""
        lease = read_lease(self.heartbeat_dir)
        if lease is None or lease["epoch"] <= self.rdv_epoch:
            return lease
        if self._rank not in lease["world"]:
            self._c_fenced.inc()
            get_tracer().instant("elastic_fenced", where=where,
                                 lease_epoch=lease["epoch"])
            flight_record("elastic", "fenced", where=where,
                          lease_epoch=lease["epoch"])
            raise ElasticFenced(
                f"the rendezvous lease moved to epoch {lease['epoch']} "
                f"(world {lease['world']}) without this rank "
                f"({self._rank}) at {where}: the group has re-formed "
                "without us; self-fencing instead of training into a "
                "split brain")
        old_world = self._world
        self._world = list(lease["world"])
        self.rdv_epoch = int(lease["epoch"])
        raise ElasticRestartRequired(
            self._world, [r for r in old_world if r not in self._world],
            coordinator=lease["coordinator"], epoch=lease["epoch"],
            grow=len(self._world) > len(old_world))

    # --------------------------------------------------------------- scale-up
    def _maybe_scale_up(self) -> None:
        """Epoch-boundary admission of the joins the coordinator recorded
        in the lease at an earlier checkpoint: every member raises
        ``ElasticRestartRequired(grow=True)``; the coordinator first
        publishes the next epoch's lease and consumes the join files."""
        lease = self._follow_newer_lease("epoch boundary")
        pending = [r for r in (lease or {}).get("pending", [])
                   if r not in self._world]
        if not pending:
            return
        new_world = sorted(set(self._world) | set(pending))
        new_epoch = self.rdv_epoch + 1
        coordinator = min(new_world)
        self._c_scale_ups.inc()
        get_tracer().instant("elastic_scale_up", epoch=new_epoch,
                             joined=pending, world=new_world)
        flight_record("elastic", "scale_up", epoch=new_epoch,
                      joined=",".join(map(str, pending)),
                      world=",".join(map(str, new_world)))
        logger.warning(
            "admitting replacement host(s) %s at the epoch boundary: world "
            "%s -> %s, rendezvous epoch %d (a restart grows the world)",
            pending, self._world, new_world, new_epoch)
        if self._rank == min(self._world):
            write_lease(self.heartbeat_dir, new_epoch, new_world,
                        coordinator, pending=[])
            clear_join_requests(self.heartbeat_dir, pending)
        self._world = new_world
        self.rdv_epoch = new_epoch
        raise ElasticRestartRequired(new_world, [], coordinator=coordinator,
                                     epoch=new_epoch, grow=True)

    # -------------------------------------------------------------------- fit
    def fit(self, data, epochs: int = 1) -> "ElasticTrainer":
        """Train ``epochs`` over the global batches in ``data`` (a list, a
        ``DataSetIterator`` or one batch; an object with a
        ``shuffle_signature()`` records it in the cursor). The same call
        on every process; survives any host's loss mid-epoch and admits
        joiners at epoch boundaries."""
        from deeplearning4j_tpu_torch.resilience.trainer import (
            FaultTolerantTrainer,
        )
        sig = getattr(data, "shuffle_signature", None)
        self._input_sig = sig() if callable(sig) else None
        batches = FaultTolerantTrainer._materialize(data)
        if not batches:
            return self
        n = len(batches)
        cursor = self._cursor
        if cursor is not None:
            # in either direction a change of shuffling would replay the
            # tail over another emission order
            recorded = (cursor.extra or {}).get("input")
            if recorded != self._input_sig:
                raise ElasticError(
                    f"the checkpoint cursor records input shuffle state "
                    f"{recorded} but the supplied data announces "
                    f"{self._input_sig}: resuming would re-randomize the "
                    "emission order and the cursor tail would replay "
                    "other batches; supply input with the recorded "
                    "shuffle seed and window (None: unshuffled)")
        epoch, pos = (cursor.epoch, cursor.data_position) if cursor \
            else (0, 0)
        order = FaultTolerantTrainer._cursor_order(cursor, n)
        anchored = cursor is not None or not self.checkpoint_every
        while epoch < epochs:
            try:
                if not anchored:
                    # a host lost at step 1 must have a state to resume
                    self._save(epoch=epoch, next_pos=pos, order=order)
                    anchored = True
                if pos >= n:
                    if self.sentinel is not None:
                        self.sentinel.flush()
                    if self.checkpoint_every:
                        self._save(epoch=epoch + 1, next_pos=0)
                    # the epoch boundary admits recorded joins, while
                    # work remains: a grow-restart after the last epoch
                    # would start the world only to exit
                    if epoch + 1 < epochs:
                        self._maybe_scale_up()
                    epoch, pos, order = epoch + 1, 0, list(range(n))
                    continue
                step_id = self.net.iteration_count + 1
                loss = self._guarded_step(batches[order[pos]], step_id)
                if self.collect_consumption:
                    self.trajectory.append(
                        {"step": step_id, "epoch": epoch,
                         "index": order[pos], "loss": loss})
                pos += 1
                if (self.checkpoint_every
                        and self.net.iteration_count
                        % self.checkpoint_every == 0):
                    if self.sentinel is not None:
                        self.sentinel.flush()
                    self._save(epoch=epoch, next_pos=pos, order=order)
            except _HostsLost as lost:
                self._on_hosts_lost(lost)     # may raise RestartRequired
                cursor = self._cursor
                anchored = True
                if cursor is None:
                    epoch, pos, order = 0, 0, list(range(n))
                else:
                    # the recorded order, verbatim: a topology change
                    # keeps the trajectory reproducible
                    epoch, pos = cursor.epoch, cursor.data_position
                    order = FaultTolerantTrainer._cursor_order(cursor, n)
        return self

    def _save(self, epoch: int, next_pos: int,
              order: Optional[List[int]] = None) -> None:
        # a partitioned host never lands a shard in a re-formed world:
        # fence before the write
        self._check_fence("checkpoint save")
        cursor = TrainingCursor.of(self.net, epoch=epoch,
                                   data_position=next_pos)
        if order is not None and order != list(range(len(order))):
            cursor.extra["order"] = list(order)
        if self._input_sig is not None:
            cursor.extra["input"] = dict(self._input_sig)
        try:
            self.manager.save(self.net, cursor=cursor)
        except CheckpointError:
            # a peer that dies mid-save surfaces as a commit timeout:
            # classify it as a step failure is classified
            dead = self._await_staleness()
            if dead:
                raise _HostsLost(dead, "checkpoint commit") from None
            raise
        self._snapshot_pending_joins()

    def _pending_for_lease(self, world: Optional[List[int]] = None
                           ) -> List[int]:
        """Join ranks eligible for the lease's pending list: none while
        checkpointing is off (a joiner has nothing to resume from, and a
        stale join file must not ride a founding or election lease)."""
        if not self.checkpoint_every:
            return []
        world = self._world if world is None else world
        return [r for r in pending_join_ranks(self.heartbeat_dir,
                                              max_age_s=self.join_ttl_s)
                if r not in world]

    def _snapshot_pending_joins(self) -> None:
        """Coordinator only, after each committed checkpoint: record the
        join requests in the lease. The write lands before any member's
        next step completes (its collectives wait on this process), so at
        the epoch boundary every member reads the same pending set."""
        if self._rank != min(self._world):
            return
        pending = self._pending_for_lease()
        lease = read_lease(self.heartbeat_dir)
        if lease is not None and lease["epoch"] > self.rdv_epoch:
            # the world moved past us while we saved: never clobber a
            # newer lease; the next step's follow check converges
            return
        if lease is not None and lease.get("pending", []) == pending:
            return
        write_lease(self.heartbeat_dir, self.rdv_epoch, self._world,
                    self._rank, pending=pending)

    # ---------------------------------------------------------------- cleanup
    def close(self) -> None:
        """Stop the heartbeat thread and join the step threads (a thread
        abandoned inside a dead world's collective gets the group's
        timeout to end)."""
        self._hb.stop()
        for t in self._step_threads:
            t.join(timeout=self.step_timeout_s)
            if t.is_alive():
                logger.warning("step thread %s still running at close",
                               t.name)
        self._step_threads = [t for t in self._step_threads
                              if t.is_alive()]

    def __enter__(self) -> "ElasticTrainer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------ inspection
    @property
    def dp_width(self) -> int:
        return self.mesh.n_data if self.mesh else 0

    @property
    def world(self) -> List[int]:
        return list(self._world)

    def consumed_indices(self, epoch: int) -> List[int]:
        """Batch indices the committed trajectory consumed in ``epoch``
        (the exactly-once evidence)."""
        return [e["index"] for e in self.trajectory
                if e["epoch"] == epoch]
