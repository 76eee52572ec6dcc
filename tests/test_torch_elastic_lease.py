"""The port's elastic lease and heartbeats and its stall watchdog on the
CPU (``deeplearning4j_tpu_torch/resilience/elastic.py``,
``profiling/watchdog.py``'s ``StallWatchdog``):

(a) the lease cases of ``tests/test_elastic.py`` — heartbeats beat and
    go stale, the lease and join requests round-trip — and the files
    either package writes (``lease.json``, ``hb_p<rank>.json``,
    ``join_p<rank>.json``) read by the other;
(b) the watchdog cases of ``tests/test_profiling.py`` — a wedged
    thread's stale beat writes one bundle naming its deepest open span,
    a recovered beat re-arms, ``close()`` joins — and the JAX package's
    ``tools/postmortem.py`` reading a port bundle;
(c) the teardown cases of ``tests/test_thread_hygiene.py`` for the
    watchdog, the fleet router and the autoscaler;
(d) ``ElasticTrainer`` no longer refusing (ROADMAP A6.3 is ported; its
    cases are ``tests/test_torch_elastic.py``).
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from deeplearning4j_tpu.resilience import elastic as jelastic

from deeplearning4j_tpu_torch.profiling.flightrec import (FlightRecorder,
                                                          set_flightrec)
from deeplearning4j_tpu_torch.profiling.metrics import (MetricsRegistry,
                                                        set_registry)
from deeplearning4j_tpu_torch.profiling.tracer import Tracer, set_tracer
from deeplearning4j_tpu_torch.profiling.watchdog import (BUNDLE_FORMAT,
                                                         StallWatchdog,
                                                         assemble_bundle,
                                                         beat, clear_beats,
                                                         heartbeat_ages)
from deeplearning4j_tpu_torch.resilience import elastic, faultinject, service
from deeplearning4j_tpu_torch.resilience.elastic import (
    ElasticTrainer, HostHeartbeat, clear_join_requests, pending_join_ranks,
    read_heartbeat_ages, read_heartbeats, read_lease, request_join,
    write_lease,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (Fault,
                                                             FaultSchedule)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = set_registry(MetricsRegistry())
    yield
    faultinject.clear()
    with service._guards_lock:
        service._guards.clear()
    set_registry(prev)


@pytest.fixture
def fresh_diag():
    """Isolated tracer + flight recorder + registry + heartbeats for the
    watchdog/bundle tests, restored afterwards."""
    tr, rec, reg = Tracer(), FlightRecorder(), MetricsRegistry()
    prev_tr = set_tracer(tr)
    prev_rec = set_flightrec(rec)
    prev_reg = set_registry(reg)
    clear_beats()
    try:
        yield tr, rec, reg
    finally:
        set_tracer(prev_tr)
        set_flightrec(prev_rec)
        set_registry(prev_reg)
        clear_beats()


def _baseline():
    return set(threading.enumerate())


def _assert_settled(baseline, timeout_s: float = 8.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        leaked = _baseline() - baseline
        if not leaked:
            return
        time.sleep(0.02)
    raise AssertionError(
        f"threads leaked past teardown: {[t.name for t in leaked]}")


# ------------------------------------------------------- lease, heartbeats

def test_heartbeat_beats_and_goes_stale(tmp_path):
    hb = HostHeartbeat(tmp_path, rank=3, interval_s=0.05).start()
    try:
        time.sleep(0.2)
        ages = read_heartbeat_ages(tmp_path)
        assert 3 in ages and ages[3] < 1.0
    finally:
        hb.stop()
    time.sleep(0.3)
    assert read_heartbeat_ages(tmp_path)[3] >= 0.3  # no thread, no beats


def test_lease_roundtrip_and_join_requests(tmp_path):
    assert read_lease(tmp_path) is None
    write_lease(tmp_path, 3, [1, 2, 5], 1, pending=[7])
    lease = read_lease(tmp_path)
    assert lease["epoch"] == 3 and lease["coordinator"] == 1
    assert lease["world"] == [1, 2, 5] and lease["pending"] == [7]
    assert pending_join_ranks(tmp_path) == []
    request_join(tmp_path, 4)
    request_join(tmp_path, 0)
    request_join(tmp_path, 4)  # idempotent re-announce
    assert pending_join_ranks(tmp_path) == [0, 4]
    clear_join_requests(tmp_path, [0])
    assert pending_join_ranks(tmp_path) == [4]
    # announcements expire: an aged request never enters a lease
    # snapshot (a joiner re-announces until admitted)
    stale = tmp_path / "join_p4.json"
    stale.write_text(json.dumps({"rank": 4, "time": time.time() - 999}))
    assert pending_join_ranks(tmp_path, max_age_s=60.0) == []
    assert pending_join_ranks(tmp_path) == [4]  # unfiltered read keeps it


def test_heartbeat_payload_retire_and_partition(tmp_path):
    """The payload rides every beat; a ``partition_replica`` window
    drops the beats while the thread lives; ``retire`` deletes the file
    (an orderly leave reads as gone, a crash as stale)."""
    hb = HostHeartbeat(tmp_path, rank=2, interval_s=0.05,
                       payload={"host": "h", "port": 7, "rank": 99})
    hb.start()
    try:
        rec = read_heartbeats(tmp_path)[2]
        assert rec["host"] == "h" and rec["port"] == 7
        assert rec["rank"] == 2 and rec["age"] < 1.0   # rank key wins
        faultinject.set_schedule(FaultSchedule([Fault(
            "partition_replica", rank=2, at_call=1, duration=0.0)]))
        assert faultinject.on_replica_request(2) == (0.0, False)
        time.sleep(0.3)
        assert hb.write_stale_s() >= 0.25
        assert read_heartbeat_ages(tmp_path)[2] >= 0.25
        faultinject.clear()
        time.sleep(0.2)
        assert read_heartbeat_ages(tmp_path)[2] < 0.2
    finally:
        hb.retire()
    assert read_heartbeats(tmp_path) == {}
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rendezvous_files_cross_between_the_packages(tmp_path, writer):
    """``lease.json``, ``join_p<rank>.json`` and ``hb_p<rank>.json``
    written by one package are read by the other, field for field."""
    w, r = (jelastic, elastic) if writer == "jax" else (elastic, jelastic)
    w.write_lease(tmp_path, 6, [3, 0, 2], -1, pending=[9, 4])
    w.request_join(tmp_path, 4)
    w.request_join(tmp_path, 9)
    hb = w.HostHeartbeat(tmp_path, 5, interval_s=10.0,
                         payload={"host": "127.0.0.1", "port": 4242})
    hb.start()
    try:
        hb.step = 11
        hb.beat()
        lease = r.read_lease(tmp_path)
        assert {k: lease[k] for k in ("epoch", "coordinator", "world",
                                      "pending")} == {
            "epoch": 6, "coordinator": -1, "world": [0, 2, 3],
            "pending": [4, 9]}
        assert lease == w.read_lease(tmp_path)
        assert r.pending_join_ranks(tmp_path) == [4, 9]
        assert r.pending_join_ranks(tmp_path, max_age_s=60.0) == [4, 9]
        rec = r.read_heartbeats(tmp_path)[5]
        assert (rec["host"], rec["port"], rec["step"]) == ("127.0.0.1",
                                                           4242, 11)
        assert 0.0 <= r.read_heartbeat_ages(tmp_path)[5] < 5.0
        assert set(rec) == set(w.read_heartbeats(tmp_path)[5])
        r.clear_join_requests(tmp_path, [9])
        assert w.pending_join_ranks(tmp_path) == [4]
    finally:
        hb.retire()
    assert r.read_heartbeats(tmp_path) == {}


def test_elastic_trainer_waits_for_a6(tmp_path):
    """ROADMAP A6.3 is ported: the trainer no longer refuses. At world 1
    it founds the epoch-0 lease, trains and stops its heartbeat thread at
    ``close`` (its cases: ``tests/test_torch_elastic.py``)."""
    import numpy as np

    import torch_parallel_worker as W
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    trainer = ElasticTrainer(W.elastic_net, tmp_path, checkpoint_every=1)
    try:
        rng = np.random.default_rng(0)
        trainer.fit([DataSet(rng.normal(size=(4, 4)).astype(np.float32),
                             np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])],
                    epochs=1)
        assert trainer.consumed_indices(0) == [0]
        assert read_lease(trainer.heartbeat_dir)["world"] == [0]
    finally:
        trainer.close()
    assert trainer._hb._thread is None


# ------------------------------------------------------- stall watchdog

def test_watchdog_heartbeat_ages(fresh_diag):
    beat("elastic")
    ages = heartbeat_ages()
    assert 0.0 <= ages["elastic"] < 5.0


def test_watchdog_stale_heartbeat_writes_bundle(tmp_path, fresh_diag):
    """A wedged thread (open spans + stale beat) must produce a bundle
    on disk whose culprit names the deepest open span of THAT thread;
    the JAX package's postmortem reads it."""
    tr, rec, _reg = fresh_diag
    release = threading.Event()
    armed = threading.Event()

    def wedge():
        h1 = tr.begin("train:step")
        h2 = tr.begin("train:collective")
        beat("trainer")               # last sign of life, then hang
        rec.record("trainer", "dispatch", step=7)
        armed.set()
        release.wait(20)
        tr.end(h2)
        tr.end(h1)

    wd = StallWatchdog(str(tmp_path), interval_s=0.05)
    t = threading.Thread(target=wedge, name="wedged-trainer")
    try:
        wd.watch("trainer", deadline_s=0.25)
        t.start()
        assert armed.wait(5)
        deadline = time.monotonic() + 8
        while wd.last_bundle_path is None and time.monotonic() < deadline:
            time.sleep(0.02)
        path = wd.last_bundle_path
        assert path is not None, "watchdog never fired on the stale beat"
        with open(path) as f:
            bundle = json.load(f)
        assert bundle["format"] == BUNDLE_FORMAT
        assert bundle["reason"] == "stalled_heartbeat"
        assert bundle["stale"]["subsystem"] == "trainer"
        assert bundle["stale"]["age_s"] > 0.25
        assert "trainer" in bundle["heartbeats"]
        assert bundle["culprit"]["span"] == "train:collective"
        assert bundle["culprit"]["via"] == "stale_thread"
        spans = bundle["open_spans"][str(bundle["stale"]["tid"])]
        assert [s["name"] for s in spans] == ["train:step",
                                              "train:collective"]
        names = {th["name"] for th in bundle["threads"]}
        assert "wedged-trainer" in names
        assert any(ev["kind"] == "dispatch"
                   for ev in bundle["flight_tail"])
        assert isinstance(bundle["metrics"], dict)
        # one bundle per episode: no second dump while still stale
        seq_before = wd.last_bundle_path
        time.sleep(0.3)
        assert wd.last_bundle_path == seq_before
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "postmortem.py"), path],
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert "CULPRIT" in out.stdout and "train:collective" in out.stdout
    finally:
        release.set()
        t.join(5)
        wd.close()


def test_watchdog_threads_return_to_baseline(tmp_path):
    baseline = set(threading.enumerate())
    wd = StallWatchdog(str(tmp_path), interval_s=0.05)
    assert any(t.name == "stall-watchdog" for t in threading.enumerate())
    wd.watch("x", 10.0)
    wd.close()
    wd.close()                         # idempotent
    _assert_settled(baseline)


def test_watchdog_recovered_heartbeat_rearms(tmp_path, fresh_diag):
    wd = StallWatchdog(str(tmp_path), interval_s=0.05)
    try:
        wd.watch("svc", deadline_s=0.15)
        deadline = time.monotonic() + 8
        while wd.last_bundle_path is None and time.monotonic() < deadline:
            time.sleep(0.02)
        first = wd.last_bundle_path
        assert first is not None
        beat("svc")                    # recovery re-arms the episode
        time.sleep(0.1)
        deadline = time.monotonic() + 8
        while wd.last_bundle_path == first \
                and time.monotonic() < deadline:
            time.sleep(0.02)           # goes stale again -> second dump
        assert wd.last_bundle_path != first
    finally:
        wd.close()


def test_assemble_bundle_without_watchdog(fresh_diag):
    tr, _rec, _reg = fresh_diag
    with tr.span("serve:decode"):
        bundle = assemble_bundle(reason="live")
    assert bundle["format"] == BUNDLE_FORMAT
    assert bundle["stale"] is None
    me = str(threading.get_ident())
    assert bundle["culprit"]["span"] == "serve:decode"
    assert me in bundle["open_spans"]
    json.dumps(bundle, default=repr)


# ----------------------------------------------------- thread hygiene

def test_stall_watchdog_close_joins_monitor(tmp_path):
    base = _baseline()
    wd = StallWatchdog(str(tmp_path), interval_s=0.05)
    assert _baseline() - base, "monitor thread should have started"
    wd.watch("hygiene", deadline_s=30.0)
    wd.close()
    _assert_settled(base)
    clear_beats()


def test_fleet_router_close_reaps_monitor_acceptor_http(tmp_path):
    """FleetRouter owns three threads (membership monitor, TCP
    acceptor, metrics HTTP) — close() joins all of them. Idempotent."""
    from deeplearning4j_tpu_torch.keras.fleet import FleetRouter

    base = _baseline()
    router = FleetRouter(str(tmp_path / "fleet"), poll_s=0.05,
                         metrics_port=0)
    assert _baseline() - base, "router should have started threads"
    router.close()
    router.close()
    _assert_settled(base)


def test_fleet_autoscaler_drain_joins_controller(tmp_path):
    from deeplearning4j_tpu_torch.keras.autoscale import FleetAutoscaler
    from deeplearning4j_tpu_torch.keras.fleet import FleetRouter

    base = _baseline()
    router = FleetRouter(str(tmp_path / "fleet"), poll_s=0.05,
                         metrics_port=None)
    auto = FleetAutoscaler(router, spawn_fn=lambda rank: None,
                           tick_s=0.05)
    assert _baseline() - base, "controller thread should be live"
    auto.drain()
    auto.drain()
    router.close()
    _assert_settled(base)
