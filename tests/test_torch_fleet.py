"""The port's serving fleet on the CPU (``deeplearning4j_tpu_torch/keras/
fleet.py``): the ten cases of ``tests/test_fleet.py`` against the port —
membership behind the readyz gate and the lease, failover under the
failure taxonomy, hedges, the op surface, drains, the ``flap_replica``
and ``load_spike`` chaos kinds — and what holds the port to the JAX
package's fleet:

(a) one ``.zip`` written by the JAX package (an MLP, a 2-layer GPT)
    served by a JAX fleet and by a port fleet: predictions within 1e-5,
    greedy generate tokens equal, before and after a scheduled
    mid-stream kill;
(b) the structured errors (``SHED``, ``DRAINING``, ``NO_REPLICA``,
    ``UNROUTABLE``) in the same cases;
(c) the same membership script (admit, partition, readmit, drain)
    yields the same lease epochs and worlds in both;
(d) the keys the router reads from a replica's ``readyz`` are in the
    port gateway's ``readyz``;
(e) ``device=None`` raises at the replica without a card.

Every port replica runs with ``device="cpu"``.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.keras import fleet as jfleet
from deeplearning4j_tpu.keras import server as jserver
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.profiling import metrics as jmetrics
from deeplearning4j_tpu.resilience import faultinject as jfaultinject
from deeplearning4j_tpu.resilience import service as jservice
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSerializer

from deeplearning4j_tpu_torch import (InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch.keras import fleet
from deeplearning4j_tpu_torch.keras.fleet import (ROUTER_COORDINATOR,
                                                  FleetReplica, FleetRouter)
from deeplearning4j_tpu_torch.keras.server import KerasClient
from deeplearning4j_tpu_torch.models.gpt import greedy_generate
from deeplearning4j_tpu_torch.nn.layers import OutputLayer
from deeplearning4j_tpu_torch.profiling.metrics import (MetricsRegistry,
                                                        get_registry,
                                                        set_registry)
from deeplearning4j_tpu_torch.resilience import faultinject, service
from deeplearning4j_tpu_torch.resilience.elastic import read_lease
from deeplearning4j_tpu_torch.resilience.faultinject import (Fault,
                                                             FaultSchedule)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

#: port answers against the JAX fleet's on the same archive (f32 on the
#: CPU, two frameworks' GEMMs: the repo's slice tolerance)
ATOL_JAX = 1e-5
VOCAB, SEQ_LEN = 13, 16            # the 2-layer GPT (gpt_tiny)


@pytest.fixture(autouse=True)
def _fresh_registry():
    """Isolate every test's counters, disarm leftover fault schedules,
    and drop leaked guard registrations — of both packages."""
    prev = set_registry(MetricsRegistry())
    jprev = jmetrics.set_registry(jmetrics.MetricsRegistry())
    yield
    faultinject.clear()
    jfaultinject.clear()
    for mod in (service, jservice):
        with mod._guards_lock:
            mod._guards.clear()
    set_registry(prev)
    jmetrics.set_registry(jprev)


@pytest.fixture()
def workload(tmp_path):
    """Tiny MLP zip + a features file — the smallest servable model."""
    conf = (NeuralNetConfiguration.builder().updater("sgd")
            .learning_rate(0.1).seed(3).list()
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    zip_path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(
        MultiLayerNetwork(conf, device="cpu").init(), zip_path)
    x_path = str(tmp_path / "x.npy")
    np.save(x_path, np.zeros((2, 3), np.float32))
    return zip_path, x_path


def Replica(fdir, rank, model, **kw):
    return FleetReplica(fdir, rank, model=model, device="cpu", **kw)


def _fleet(tmp_path, model, ranks, **router_kw):
    fdir = str(tmp_path / "fleet")
    kw = dict(poll_s=0.1, heartbeat_timeout_s=1.0, metrics_port=None,
              default_deadline_ms=60_000)
    kw.update(router_kw)
    router = FleetRouter(fdir, **kw)
    reps = {r: Replica(fdir, r, model, max_batch=4,
                       default_deadline_ms=30_000)
            for r in ranks}
    assert router.wait_for_replicas(len(ranks), timeout_s=30.0), \
        f"fleet never formed: {router.replicas()}"
    return fdir, router, reps


def _teardown(router, reps):
    faultinject.clear()
    router.close()
    for rep in reps.values():
        rep.drain(grace_s=5.0)


def _predict(router, x, model, **kw):
    cli = KerasClient(router.host, router.port)
    try:
        return cli.request(op="predict", features=x, model=model, **kw)
    finally:
        cli.close()


def _counter(name):
    m = get_registry().get(name)
    return 0 if m is None else m.value


# ------------------------------------------------------------- membership

def test_admission_is_readyz_gated_and_leased(tmp_path, workload):
    """A heartbeat alone (even with a serving payload) does not admit:
    membership requires the readyz probe to answer ready. Admission
    lands in the shared-dir lease at a bumped epoch with the router as
    coordinator."""
    model, x = workload
    fdir = str(tmp_path / "fleet")
    router = FleetRouter(fdir, poll_s=0.1, heartbeat_timeout_s=1.0,
                         metrics_port=None)
    try:
        # a liar: fresh heartbeat with a payload pointing at a dead
        # port — readyz can never answer, so it must never join
        hb = tmp_path / "fleet" / "hb_p99.json"
        for _ in range(8):
            hb.write_text(json.dumps(
                {"rank": 99, "time": time.time(), "step": 0,
                 "host": "127.0.0.1", "port": 1}))
            time.sleep(0.1)
        assert router.replicas() == []

        rep = Replica(fdir, 0, model)
        try:
            assert router.wait_for_replicas(1, timeout_s=30.0)
            assert router.replicas() == [0]
            lease = read_lease(fdir)
            assert lease is not None
            assert lease["coordinator"] == ROUTER_COORDINATOR
            assert lease["world"] == [0]
            assert lease["epoch"] >= 1
            # the replica's own readyz agrees it is servable
            rz = rep.readyz()
            assert rz["ready"] and rz["checks"]["model_loaded"]
        finally:
            rep.drain(grace_s=5.0)
    finally:
        router.close()


def test_partitioned_replica_removed_then_readmitted(tmp_path, workload):
    """A partition (suppressed heartbeats) removes the replica at an
    epoch bump while the survivor keeps serving; when the partition
    heals, the replica re-admits through the readyz gate at a fresh
    epoch — no operator involved."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0, 1))
    try:
        epoch0 = router.epoch
        faultinject.set_schedule(FaultSchedule(
            [Fault("partition_replica", rank=0, at_call=1,
                   duration=2.0),
             Fault("partition_replica", rank=1, at_call=1,
                   duration=2.0)]))
        t_end = time.monotonic() + 6.0
        dipped = False
        while time.monotonic() < t_end:
            r = _predict(router, x, model)
            assert r.get("ok"), f"client-visible failure: {r}"
            if len(router.replicas()) < 2:
                dipped = True
            if dipped and len(router.replicas()) == 2:
                break
            time.sleep(0.1)
        assert dipped, "partition never removed a replica"
        assert _counter("fleet_removals_total") >= 1
        assert router.wait_for_replicas(2, timeout_s=20.0)
        assert router.epoch > epoch0 + 1
        assert read_lease(fdir)["world"] == [0, 1]
    finally:
        _teardown(router, reps)


# --------------------------------------------------------------- failover

def test_predict_failover_on_kill_zero_client_failures(tmp_path,
                                                       workload):
    """A replica hard-killed mid-storm costs zero client-visible
    failures: in-flight and subsequent requests fail over to the
    survivor, the corpse leaves the membership."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0, 1))
    try:
        kill = Fault("kill_replica", rank=0, at_call=2)
        faultinject.set_schedule(FaultSchedule([kill]))
        failures, lock = [], threading.Lock()

        def one(i):
            try:
                r = _predict(router, x, model)
                if not r.get("ok"):
                    raise RuntimeError(str(r))
            except Exception as e:  # noqa: BLE001 — the assertion
                with lock:
                    failures.append(f"req {i}: {e}")

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not failures, failures
        assert kill.fired, "kill_replica never fired"
        assert _counter("fleet_failovers_total") >= 1
        t_end = time.monotonic() + 10.0
        while 0 in router.replicas() and time.monotonic() < t_end:
            time.sleep(0.05)
        assert router.replicas() == [1]
    finally:
        _teardown(router, reps)


def test_client_errors_pass_through_uncharged(tmp_path, workload):
    """A client-input failure (missing features file) is the CLIENT's
    error: the envelope passes through unretried, the replica stays a
    member, and its breaker is never charged."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0,),
                                breaker_failures=2)
    try:
        for _ in range(4):  # enough repeats to open a 2-failure breaker
            cli = KerasClient(router.host, router.port)
            try:
                with pytest.raises(RuntimeError):
                    cli.request(op="predict",
                                features=str(tmp_path / "nope.npy"),
                                model=model)
            finally:
                cli.close()
        assert router.replicas() == [0]
        assert _counter("fleet_failovers_total") == 0
        assert _counter("fleet_retries_total") == 0
        assert _predict(router, x, model).get("ok")
    finally:
        _teardown(router, reps)


def test_hedged_predict_beats_slow_replica(tmp_path, workload):
    """With hedging armed, a predict stuck on a slow replica is
    duplicated to the other member after the hedge delay and the fast
    answer wins — tail latency bounded by the hedge, not the stall."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0, 1),
                                hedge_ms=100.0)
    try:
        # discover which member the idle tie-break dispatches to (the
        # counters are per-rank; an empty schedule still counts)
        faultinject.set_schedule(FaultSchedule([]))
        assert _predict(router, x, model).get("ok")
        primary = max(faultinject._replica_requests,
                      key=faultinject._replica_requests.get)
        faultinject.set_schedule(FaultSchedule(
            [Fault("slow_replica", rank=primary, at_call=1,
                   duration=2.0)]))
        t0 = time.monotonic()
        r = _predict(router, x, model)
        elapsed = time.monotonic() - t0
        assert r.get("ok")
        assert elapsed < 1.5, \
            f"hedge never rescued the stalled predict ({elapsed:.2f}s)"
        assert _counter("fleet_hedges_total") >= 1
        assert _counter("fleet_hedge_wins_total") >= 1
    finally:
        _teardown(router, reps)


# ------------------------------------------------------------ op surface

def test_fit_is_unroutable_and_unknown_op_rejected(tmp_path, workload):
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0,))
    try:
        cli = KerasClient(router.host, router.port)
        try:
            with pytest.raises(RuntimeError, match="UNROUTABLE"):
                cli.request(op="fit", model=model)
            with pytest.raises(RuntimeError, match="ValueError"):
                cli.request(op="frobnicate")
            # the connection survives structured rejections
            assert cli.request(op="predict", features=x,
                               model=model).get("ok")
        finally:
            cli.close()
    finally:
        _teardown(router, reps)


def test_router_drain_rejects_new_work_structured(tmp_path, workload):
    """A draining router answers DRAINING (structured, retryable
    elsewhere), not a dropped connection."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0,))
    try:
        assert _predict(router, x, model).get("ok")
        router._guard.start_drain()
        with pytest.raises(RuntimeError, match="DRAINING"):
            _predict(router, x, model)
    finally:
        _teardown(router, reps)


def test_replica_drain_is_zero_drop_leave(tmp_path, workload):
    """Draining a member under light load never surfaces a failure:
    the heartbeat retires first (routing moves within a poll), raced
    requests reroute on DRAINING, in-flight work completes."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0, 1))
    try:
        stop = threading.Event()
        failures, lock = [], threading.Lock()

        def load():
            while not stop.is_set():
                try:
                    r = _predict(router, x, model)
                    if not r.get("ok"):
                        raise RuntimeError(str(r))
                except Exception as e:  # noqa: BLE001 — the assertion
                    with lock:
                        failures.append(str(e))
                    return
                time.sleep(0.01)

        t = threading.Thread(target=load, daemon=True)
        t.start()
        time.sleep(0.2)
        assert reps[0].drain(grace_s=10.0)
        t_end = time.monotonic() + 10.0
        while 0 in router.replicas() and time.monotonic() < t_end:
            time.sleep(0.05)
        time.sleep(0.3)  # a little post-leave load on the survivor
        stop.set()
        t.join(30.0)
        assert not failures, failures
        assert router.replicas() == [1]
    finally:
        _teardown(router, reps)


def test_flap_replica_chaos_quarantines_then_releases(tmp_path,
                                                      workload):
    """The ``flap_replica`` chaos kind crash-loops a rank: each
    incarnation is admitted then killed moments later. Two strikes
    inside the flap window quarantine the rank while the stable member
    keeps serving; the next — healthy — incarnation is admitted once the
    delay elapses."""
    model, x = workload
    fdir, router, reps = _fleet(
        tmp_path, model, (0,), flap_window_s=10.0, flap_strikes=2,
        flap_quarantine_base_s=1.5, flap_quarantine_max_s=6.0)
    flapper = None
    try:
        faultinject.set_schedule(FaultSchedule(faults=[
            Fault("flap_replica", rank=5, count=2, duration=0.2)]))
        spawns = 0
        flapper = Replica(fdir, 5, model, max_batch=4)
        spawns += 1
        t_end = time.monotonic() + 40.0
        while (_counter("fleet_quarantines_total") < 1
               and time.monotonic() < t_end):
            # respawn once the router dropped the dead incarnation: a
            # successor that read the dead one's lease world would start
            # its kill clock before its own admission
            if not flapper.alive and 5 not in router.replicas():
                flapper = Replica(fdir, 5, model, max_batch=4)
                spawns += 1
            time.sleep(0.1)
        assert _counter("fleet_quarantines_total") >= 1
        assert router.quarantined(5)
        assert _counter("resilience_faults_injected_total") >= 2
        assert _predict(router, x, model).get("ok")
        if not flapper.alive:
            t_end = time.monotonic() + 10.0
            while 5 in router.replicas() and time.monotonic() < t_end:
                time.sleep(0.05)
            flapper = Replica(fdir, 5, model, max_batch=4)
            spawns += 1
        assert spawns >= 3
        assert router.wait_for_replicas(2, timeout_s=30.0), \
            router.replicas()
        assert 5 in router.replicas()
        assert not flapper.server.killed
        assert _predict(router, x, model).get("ok")
    finally:
        if flapper is not None:
            flapper.drain(grace_s=5.0)
        _teardown(router, reps)


def test_load_spike_chaos_degrades_structurally(tmp_path, workload):
    """The ``load_spike`` chaos kind hands the harness a concurrent
    burst spec; fired at an undersized router every request either
    succeeds or gets a *structured* envelope (SHED/DEADLINE) on a live
    connection — never a dropped socket."""
    model, x = workload
    fdir, router, reps = _fleet(tmp_path, model, (0,),
                                max_concurrency=2, queue_depth=2,
                                max_queue_wait_s=0.3)
    try:
        faultinject.set_schedule(FaultSchedule(faults=[
            Fault("load_spike", count=12, duration=0.0)] + [
            Fault("slow_replica", rank=0, at_call=i, duration=0.3)
            for i in range(1, 13)]))
        spec = faultinject.load_spike_spec()
        assert spec == {"count": 12, "duration": 0.0}
        assert faultinject.load_spike_spec() is None  # one-shot
        outcomes, hard_failures = [], []
        lock = threading.Lock()

        def one():
            try:
                r = _predict(router, x, model, priority="bulk")
                with lock:
                    outcomes.append("ok" if r.get("ok") else str(r))
            except RuntimeError as e:  # structured error envelope
                with lock:
                    outcomes.append(str(e).split(":", 1)[0])
            except Exception as e:  # noqa: BLE001 — dropped socket
                with lock:
                    hard_failures.append(repr(e))

        threads = [threading.Thread(target=one, daemon=True)
                   for _ in range(spec["count"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not hard_failures, hard_failures
        assert len(outcomes) == 12
        assert outcomes.count("ok") >= 1
        shed = [o for o in outcomes if o in ("SHED", "DEADLINE")]
        assert shed, outcomes
        assert all(o == "ok" or o in ("SHED", "DEADLINE")
                   for o in outcomes), outcomes
        assert _counter("resilience_faults_injected_total") >= 1
    finally:
        _teardown(router, reps)


# ------------------------------------------------- the port's own contract

def test_replica_device_none_needs_a_card(tmp_path, workload, monkeypatch):
    """``FleetReplica(device=None)`` is the card: without one it raises
    while the replica is built, before it announces itself — never when
    a request arrives."""
    model, _ = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fdir = tmp_path / "fleet"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetReplica(str(fdir), 0, model=model)
    assert not fdir.exists() or not list(fdir.glob("*.json"))


def test_readyz_carries_every_key_the_router_reads(tmp_path, workload):
    """The router scores and admits from a replica's ``readyz``: the
    keys it reads (ready, queued, ttft_p99_ms, checks) are in the port
    gateway's answer, and the port's keys are the JAX gateway's."""
    model, _ = workload
    jnet = JMultiLayerNetwork(
        JConf.builder().updater("sgd").learning_rate(0.1).seed(3).list()
        .layer(JOutput(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(JInputType.feed_forward(3)).build()).init()
    jzip = str(tmp_path / "j.zip")
    JSerializer.write_model(jnet, jzip)
    port = Replica(str(tmp_path / "a"), 0, model)
    jrep = jfleet.FleetReplica(str(tmp_path / "b"), 0, model=jzip)
    try:
        rz, jrz = port.readyz(), jrep.readyz()
    finally:
        port.drain(grace_s=5.0)
        jrep.drain(grace_s=5.0)
    for key in ("ready", "queued", "ttft_p99_ms", "checks"):
        assert key in rz, key
    assert rz["ready"] and rz["checks"]["model_loaded"]
    assert set(rz) == set(jrz)
    assert set(rz["checks"]) == set(jrz["checks"])


# ----------------------------------------------- parity with the JAX fleet

def _jax_mlp():
    conf = (JConf.builder().updater("adam").learning_rate(0.05).seed(7)
            .list().layer(JDense(n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    rng = np.random.default_rng(51)
    return (JMultiLayerNetwork(conf).init(),
            [rng.normal(size=(r, 4)).astype(np.float32)
             for r in (1, 2, 3, 5)])


def _jax_gpt():
    rng = np.random.default_rng(52)
    eye = np.eye(VOCAB, dtype=np.float32)
    return (JGraph(jgpt.gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN)).init(),
            [eye[rng.integers(0, VOCAB, (r, SEQ_LEN))] for r in (1, 2, 3)])


#: each package's fleet: (router, replica, client, fault module, kw)
FLEETS = {
    "jax": (jfleet.FleetRouter, jfleet.FleetReplica, jserver.KerasClient,
            jfaultinject, {}),
    "port": (FleetRouter, FleetReplica, KerasClient, faultinject,
             {"device": "cpu"}),
}


def _stream_generate(router, tokens, max_new, model):
    """Raw streaming client through the router: (partials, final)."""
    partials = []
    with socket.create_connection((router.host, router.port),
                                  timeout=120) as s:
        f = s.makefile("rwb")
        f.write((json.dumps({"op": "generate", "tokens": tokens,
                             "max_new_tokens": max_new, "model": model,
                             "stream": True}) + "\n").encode())
        f.flush()
        while True:
            resp = json.loads(f.readline())
            if resp.get("partial"):
                partials.append(int(resp["t"]))
                continue
            f.close()
            return partials, resp


def _serve_through(which, fdir, model, files, prompt=None, max_new=0):
    """Ragged concurrent predicts through a two-replica fleet of one
    package, then (with a prompt) a greedy generate, and a streamed one
    whose first replica is killed after its 3rd token and whose
    survivor joins behind the readyz gate mid-stream. Returns
    (answers, tokens, (streamed, final) after the kill)."""
    Router, Rep, Client, fi, kw = FLEETS[which]
    router = Router(fdir, poll_s=0.1, heartbeat_timeout_s=1.5,
                    metrics_port=None, empty_pool_wait_s=60.0,
                    default_deadline_ms=300_000)
    reps = {r: Rep(fdir, r, model=model, max_batch=8, max_wait_ms=30.0,
                   default_deadline_ms=120_000, **kw) for r in (0, 1)}
    late = None
    try:
        assert router.wait_for_replicas(2, timeout_s=60.0)
        out, lock = {}, threading.Lock()
        start = threading.Barrier(len(files))

        def one(i):
            cli = Client(router.host, router.port)
            try:
                start.wait(10.0)
                y = cli.predict(files[i], model=model)
                with lock:
                    out[i] = np.asarray(y)
            finally:
                cli.close()

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(len(files))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert sorted(out) == list(range(len(files)))
        answers = [out[i] for i in range(len(files))]
        if prompt is None:
            return answers, None, None
        cli = Client(router.host, router.port)
        try:
            tokens = cli.generate(prompt, max_new, model=model)["tokens"]
        finally:
            cli.close()
        # mid-stream: rank 0 alone, killed after its 3rd streamed token;
        # rank 10 joins while the stream runs
        reps[1].drain(grace_s=5.0)
        t_end = time.monotonic() + 10.0
        while router.replicas() != [0] and time.monotonic() < t_end:
            time.sleep(0.05)
        assert router.replicas() == [0]
        kill = fi.Fault("kill_replica", rank=0, step=3)
        fi.set_schedule(fi.FaultSchedule([kill]))
        res = {}

        def gen():
            res["out"] = _stream_generate(router, prompt, max_new, model)

        t = threading.Thread(target=gen, daemon=True)
        t.start()
        late = Rep(fdir, 10, model=model, max_batch=8,
                   default_deadline_ms=120_000, **kw)
        t.join(240.0)
        assert kill.fired and "out" in res
        return answers, tokens, res["out"]
    finally:
        fi.clear()
        router.close()
        for rep in list(reps.values()) + ([late] if late else []):
            rep.drain(grace_s=5.0)


@pytest.mark.parametrize("which", ["mlp", "gpt"])
def test_jax_zip_served_by_both_fleets_agree(tmp_path, which):
    """One JAX-written archive behind each package's fleet: answers
    within 1e-5; for the GPT, greedy tokens equal to each other and to
    the port's singleton decode, and after a mid-stream kill the
    streamed and final tokens equal them too."""
    jnet, feats = {"mlp": _jax_mlp, "gpt": _jax_gpt}[which]()
    model = str(tmp_path / f"{which}.zip")
    JSerializer.write_model(jnet, model)
    files = []
    for i, f in enumerate(feats):
        files.append(str(tmp_path / f"x{i}.npy"))
        np.save(files[-1], f)
    prompt, max_new = ([3, 1, 4, 1, 5], 8) if which == "gpt" else (None, 0)
    got = {name: _serve_through(name, str(tmp_path / f"fleet_{name}"),
                                model, files, prompt, max_new)
           for name in ("jax", "port")}
    for i, (a, b) in enumerate(zip(got["port"][0], got["jax"][0])):
        assert a.shape == b.shape == (len(feats[i]),) + b.shape[1:]
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_JAX,
                                   err_msg=f"{which} request {i}")
    if prompt is None:
        return
    ref = greedy_generate(ModelSerializer.restore_model(model,
                                                        device="cpu"),
                          prompt, max_new)
    assert got["port"][1] == got["jax"][1] == ref
    for name in ("jax", "port"):
        partials, final = got[name][2]
        assert final.get("ok") and final["failovers"] >= 1, final
        assert final["tokens"] == partials == ref, (name, final, partials)


def _fleet_codes(which, tmp_path, model, x):
    """Drive one package's fleet through the four structured refusals;
    returns each case's answer code."""
    Router, Rep, Client, _fi, kw = FLEETS[which]
    codes = {}
    fdir = str(tmp_path / f"codes_{which}")
    empty = Router(str(tmp_path / f"empty_{which}"), poll_s=0.1,
                   metrics_port=None, empty_pool_wait_s=0.3)
    try:
        codes["empty"] = _raw_code(empty, op="predict", features=x,
                                   model=model)
    finally:
        empty.close()
    router = Router(fdir, poll_s=0.1, heartbeat_timeout_s=1.0,
                    metrics_port=None)
    rep = Rep(fdir, 0, model=model, **kw)
    try:
        assert router.wait_for_replicas(1, timeout_s=30.0)
        codes["fit"] = _raw_code(router, op="fit", model=model)
        router.set_brownout(True, reason="test")
        codes["bulk_in_brownout"] = _raw_code(
            router, op="predict", features=x, model=model, priority="bulk")
        codes["interactive_in_brownout"] = _raw_code(
            router, op="predict", features=x, model=model)
        router.set_brownout(False)
        router._guard.start_drain()
        codes["draining"] = _raw_code(router, op="predict", features=x,
                                      model=model)
    finally:
        router.close()
        rep.drain(grace_s=5.0)
    return codes


def _raw_code(router, **req):
    with socket.create_connection((router.host, router.port),
                                  timeout=30.0) as s:
        f = s.makefile("rwb")
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        resp = json.loads(f.readline())
        f.close()
    return "ok" if resp.get("ok") else str(resp.get("error")).split(":")[0]


def test_structured_errors_match_the_jax_fleet(tmp_path):
    jnet, feats = _jax_mlp()
    model = str(tmp_path / "mlp.zip")
    JSerializer.write_model(jnet, model)
    x = str(tmp_path / "x.npy")
    np.save(x, feats[1])
    jcodes = _fleet_codes("jax", tmp_path, model, x)
    assert jcodes == {"empty": "NO_REPLICA", "fit": "UNROUTABLE",
                      "bulk_in_brownout": "SHED",
                      "interactive_in_brownout": "ok",
                      "draining": "DRAINING"}
    assert _fleet_codes("port", tmp_path, model, x) == jcodes


def _membership_script(which, fdir, model):
    """Admit 0, admit 1, partition 1 (its heartbeat suppressed until the
    schedule is cleared), heal it, readmit 1, drain 0: the lease's
    (epoch, world) after each step. The partition is held open until the
    router has dropped rank 1, so no timing decides whether the [0]
    world is seen; the 3 s heartbeat timeout keeps a healthy replica
    whose 0.2 s heartbeat thread is starved on a loaded host from being
    dropped as well."""
    Router, Rep, Client, fi, kw = FLEETS[which]
    router = Router(fdir, poll_s=0.1, heartbeat_timeout_s=3.0,
                    metrics_port=None)
    reps, seen = {}, []

    def settle(world):
        t_end = time.monotonic() + 30.0
        while router.replicas() != world and time.monotonic() < t_end:
            time.sleep(0.05)
        assert router.replicas() == world, (which, router.replicas())
        lease = (read_lease if which == "port" else
                 jfleet.read_lease)(fdir)
        seen.append((lease["epoch"], lease["world"]))

    try:
        reps[0] = Rep(fdir, 0, model=model, **kw)
        settle([0])
        reps[1] = Rep(fdir, 1, model=model, **kw)
        settle([0, 1])
        fi.set_schedule(fi.FaultSchedule([fi.Fault(
            "partition_replica", rank=1, at_call=1, duration=0.0)]))
        # an admitted request on rank 1 opens its partition window (a
        # probe would not count; a missing file is answered, not served)
        cli = Client(reps[1].host, reps[1].port)
        try:
            cli.request(op="predict", features="missing.npy", model=model)
        except RuntimeError:
            pass
        cli.close()
        settle([0])
        fi.clear()          # the partition heals: rank 1 beats again
        settle([0, 1])
        reps.pop(0).drain(grace_s=5.0)
        settle([1])
        return seen
    finally:
        fi.clear()
        router.close()
        for rep in reps.values():
            rep.drain(grace_s=5.0)


def test_membership_script_same_epochs_and_worlds(tmp_path):
    jnet, _ = _jax_mlp()
    model = str(tmp_path / "mlp.zip")
    JSerializer.write_model(jnet, model)
    jseen = _membership_script("jax", str(tmp_path / "j"), model)
    assert jseen == [(1, [0]), (2, [0, 1]), (3, [0]), (4, [0, 1]),
                     (5, [1])]
    assert _membership_script("port", str(tmp_path / "p"), model) == jseen


def test_fleet_module_names_match_the_jax_package():
    """A reader finds each counterpart by its name."""
    for name in ("ROUTER_COORDINATOR", "NoReplicaAvailable", "UnroutableOp",
                 "_classify", "_Replica", "_ForwardFailure", "FleetReplica",
                 "FleetRouter", "_MetricsHTTP"):
        assert hasattr(fleet, name) and hasattr(jfleet, name), name
    assert fleet.ROUTER_COORDINATOR == jfleet.ROUTER_COORDINATOR
    for resp in ({"error": "SHED"}, {"error": "DRAINING"},
                 {"error": "NONFINITE"}, {"error": "X", "message": "m"},
                 {"error": "ValueError: bad"}, {"error": "boom"}):
        assert fleet._classify(resp) == jfleet._classify(resp), resp


def test_stopped_schedulers_put_nothing_back_in_the_cache(workload):
    """A replica's teardown stops its schedulers, and ``stop()`` releases
    their slice of the process-global compile cache. A capture that ends
    after that (a killed replica's dispatcher that waited on
    ``CAPTURE_LOCK`` past the stop's join) still serves its own call but
    puts no dead owner's entry back: the predict batcher's and the
    engine's alike."""
    from deeplearning4j_tpu_torch.keras.batching import (BatchScheduler,
                                                         CompileCache)
    from deeplearning4j_tpu_torch.keras.generation import (
        GenerationScheduler)
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.resilience.service import Deadline

    model_path, _ = workload
    net = ModelSerializer.restore_model(model_path, device="cpu")
    cache = CompileCache()
    sched = BatchScheduler(max_batch=4, compile_cache=cache)
    sched._backends["m"] = (net, threading.Lock())
    sched._runner("m", net, 2, ((3,), "float32"))
    assert len(cache.keys()) == 1
    sched.stop()
    assert cache.keys() == []
    assert sched._runner("m", net, 4, ((3,), "float32")) is not None
    assert cache.keys() == []

    gpt = ComputationGraph(gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN),
                           device="cpu").init()
    gen = GenerationScheduler(max_rows=2, compile_cache=cache,
                              prewarm_decode_ladder=False)
    gen.submit("g", gpt, threading.Lock(), [1, 2, 3], 2, Deadline(30.0))
    engine = gen._engines["g"]
    assert cache.keys()
    gen.stop()
    assert cache.keys() == []
    assert engine._compiled("decode", 2) is not None
    assert cache.keys() == []
