"""The port's serving edge on the CPU (``deeplearning4j_tpu_torch/
resilience/service.py``, ``keras/server.py``, ``keras/batching.py``):
the counterpart of the ``ServiceGuard``, ``keras_*`` and ``batch_*``
cases of ``tests/test_serving_resilience.py`` (the broker, frame
protocol and ui cases wait for ROADMAP A7), and what the port adds:

(a) the service kit — admission sheds past the queue, a budget blown in
    the queue is DEADLINE, breakers walk closed -> open -> half-open ->
    closed, drain rejects then waits, readiness aggregates;
(b) the gateway — health/readyz/debug, deadlines on a hung backend, the
    breaker over the wire, a burst that sheds and recovers without
    leaking threads, drain, the LRU with per-model locks, slow-loris
    reclaim, nonfinite refusal, and the batching chaos (a poisoned row
    fails alone, a deadline-blown member fails alone, a batch-level
    failure falls back to singletons);
(c) the port's own contract — ``fit``, ``evaluate`` and ``generate``
    (greedy, sampled, streamed) over the wire against the served net's
    own answers, a ``fit`` followed by predicts that see the new weights,
    ``tuned=`` (A7.4) refusing with ``NotImplementedError`` while ``.h5``
    batch files and Keras ``.h5`` models are served,
    ``device=None`` raising without a card, threads back to baseline
    after ``drain`` and ``stop``, ``tools/lockcheck.py`` clean on
    ``keras/`` and ``resilience/``;
(d) parity with the JAX package's gateway — one ``.zip`` written by the
    JAX package (the iris MLP, a small char-RNN with the JAX LSTM kernel
    interpreted, a 2-layer GPT) served by both ``KerasServer``s under
    ragged concurrent predicts: answers within 1e-5, generated tokens
    equal, and the structured errors (``SHED``, ``DEADLINE``,
    ``BREAKER_OPEN``, ``NONFINITE``, ``DRAINING``) in the same cases.

Every port server runs with ``device="cpu"`` (its runners are the eager
``output()``; the CUDA graphs are held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.iris import load_iris as jload_iris
from deeplearning4j_tpu.keras import server as jserver
from deeplearning4j_tpu.models import char_rnn as jchar_rnn
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
from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iris import (IrisDataSetIterator,
                                                    load_iris)
from deeplearning4j_tpu_torch.keras.hdf5 import Hdf5Writer
from deeplearning4j_tpu_torch.keras.server import KerasClient, KerasServer
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.models.gpt import (gpt_tiny, greedy_generate,
                                                 sample_generate)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.profiling.metrics import (MetricsRegistry,
                                                        get_registry,
                                                        set_registry)
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.profiling.watchdog import (BUNDLE_FORMAT,
                                                         assemble_bundle,
                                                         beat)
from deeplearning4j_tpu_torch.resilience import faultinject, service
from deeplearning4j_tpu_torch.resilience.faultinject import (Fault,
                                                             FaultSchedule)
from deeplearning4j_tpu_torch.resilience.service import (CLOSED, OPEN,
                                                         CircuitBreaker,
                                                         Deadline,
                                                         DeadlineExceeded,
                                                         DrainingError,
                                                         RetryBudget,
                                                         ServiceGuard,
                                                         ShedError,
                                                         ready_report,
                                                         register_guard,
                                                         unregister_guard)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

ROOT = Path(__file__).resolve().parents[1]
#: port answers against the JAX gateway's on the same archive (f32 on
#: the CPU, two frameworks' GEMMs: the repo's slice tolerance)
ATOL_JAX = 1e-5
VOCAB, SEQ_LEN = 13, 16            # the 2-layer GPT (gpt_tiny)
RNN_VOCAB, RNN_T = 16, 8           # char_rnn_lstm(16, 32, 2) windows


def Server(**kw):
    return KerasServer(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh_registry_and_schedule():
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


def _counter(name: str) -> float:
    m = get_registry().get(name)
    return 0.0 if m is None else m.value


def _wait_until(cond, timeout=5.0, msg="condition"):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _code(fn) -> str:
    """The structured error code a request answers, or "ok"."""
    try:
        fn()
        return "ok"
    except RuntimeError as e:
        return str(e).split(":")[0]


# ---------------------------------------------------------------------------
# service kit units
# ---------------------------------------------------------------------------

def test_admission_sheds_past_queue_depth():
    guard = ServiceGuard("t", max_concurrency=1, queue_depth=1,
                         max_queue_wait_s=0.2)
    release = threading.Event()
    entered = threading.Event()

    def hold():
        with guard.admit():
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    entered.wait(5.0)
    # slot busy; one waiter fits in the queue (it will time out), the
    # NEXT is shed immediately
    waiter_err = []

    def queued():
        try:
            with guard.admit():
                pass
        except ShedError as e:
            waiter_err.append(e)

    q = threading.Thread(target=queued, daemon=True)
    q.start()
    _wait_until(lambda: guard.queued == 1, msg="waiter queued")
    with pytest.raises(ShedError, match="at capacity"):
        guard.admit()
    assert _counter("serving_shed_total") >= 1
    q.join(5.0)
    assert waiter_err, "queued request should shed after wait budget"
    release.set()
    t.join(5.0)
    assert guard.inflight == 0
    assert _counter("serving_admitted_total") == 1


def test_queued_past_own_deadline_is_deadline_not_shed():
    """A budget blown while queued is DEADLINE (retrying is pointless),
    not SHED with a retry hint."""
    guard = ServiceGuard("t", max_concurrency=1, queue_depth=2,
                         max_queue_wait_s=5.0)
    release = threading.Event()
    entered = threading.Event()

    def hold():
        with guard.admit():
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    entered.wait(5.0)
    try:
        with pytest.raises(DeadlineExceeded):
            guard.admit(Deadline.from_ms(120))
        assert _counter("serving_deadline_exceeded_total") == 1
        # and a budget already dead on arrival never even queues
        d = Deadline.from_ms(1)
        time.sleep(0.01)
        with pytest.raises(DeadlineExceeded):
            guard.admit(d)
    finally:
        release.set()
        t.join(5.0)


def test_deadline_budget_and_envelope():
    d = Deadline.from_request({"deadline_ms": 30}, default_ms=60_000)
    assert not d.expired()
    time.sleep(0.05)
    with pytest.raises(DeadlineExceeded):
        d.check("op")
    assert _counter("serving_deadline_exceeded_total") == 1
    # <= 0 disables; missing key falls back to the server default
    assert Deadline.from_request({"deadline_ms": 0}, 10).remaining() is None
    assert Deadline.from_request({}, None).remaining() is None
    assert Deadline.from_request({}, 1000).remaining() is not None


def test_breaker_open_halfopen_closed_lifecycle():
    b = CircuitBreaker("k", failures=3, cooldown_base=0.05,
                       cooldown_max=0.1)
    for _ in range(3):
        assert b.allow()
        b.record_failure()
    assert b.state == OPEN
    assert not b.allow()
    assert b.retry_after_ms() >= 0
    assert get_registry().get("serving_breaker_state").value == OPEN
    _wait_until(lambda: b.allow(), msg="half-open probe admitted")
    # exactly one probe: a second concurrent request is still refused
    assert not b.allow()
    b.record_success()
    assert b.state == CLOSED
    assert get_registry().get("serving_breaker_state").value == CLOSED
    assert _counter("serving_breaker_transitions_total") >= 3


def test_breaker_failed_probe_reopens():
    b = CircuitBreaker("k", failures=1, cooldown_base=0.04,
                       cooldown_max=0.08)
    b.record_failure()
    assert b.state == OPEN
    _wait_until(lambda: b.allow(), msg="half-open probe")
    b.record_failure()  # probe failed
    assert b.state == OPEN


def test_drain_rejects_then_waits_idle():
    guard = ServiceGuard("t", max_concurrency=2, queue_depth=2)
    release = threading.Event()
    entered = threading.Event()

    def hold():
        with guard.admit():
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    entered.wait(5.0)
    guard.start_drain()
    with pytest.raises(DrainingError):
        guard.admit()
    assert not guard.wait_idle(0.1)  # in-flight work still running
    release.set()
    assert guard.wait_idle(5.0)
    assert not guard.ready()[0]
    assert "draining" in guard.ready()[1]
    assert _counter("serving_drains_total") == 1
    assert _counter("serving_drain_rejects_total") == 1


def test_ready_reports_breaker_and_custom_check():
    guard = ServiceGuard("t", breaker_failures=1)
    ok, reasons = guard.ready()
    assert ok and reasons == []
    loaded = []
    guard.add_ready_check("model_loaded", lambda: bool(loaded))
    assert "model_loaded" in guard.ready()[1]
    loaded.append(1)
    assert guard.ready()[0]
    guard.breaker("m").record_failure()
    assert any("breaker open" in r for r in guard.ready()[1])


def test_retry_budget_and_ready_report():
    """The token bucket spends per retry and refills a fraction per
    success; ``ready_report`` aggregates every registered guard and
    drops an unregistered one."""
    rb = RetryBudget(capacity=2.0, refill_ratio=0.5, initial=1.0)
    assert rb.try_spend() and not rb.try_spend()
    rb.on_success()
    rb.on_success()
    assert rb.tokens == 1.0
    for _ in range(10):
        rb.on_success()
    assert rb.tokens == 2.0              # capped at capacity
    a = register_guard(ServiceGuard("a"))
    b = register_guard(ServiceGuard("b"))
    assert ready_report() == (True, {"a": {"ready": True, "reasons": []},
                                     "b": {"ready": True, "reasons": []}})
    b.start_drain()
    ok, report = ready_report()
    assert not ok and report["b"]["reasons"] == ["draining"]
    unregister_guard(b)
    assert ready_report() == (True, {"a": {"ready": True, "reasons": []}})
    unregister_guard(a)


def test_debug_bundle_names_the_wedged_span():
    """``assemble_bundle`` (the ``debug`` op's payload) keeps the JAX
    schema and names the deepest open span of the stalest heartbeat's
    thread."""
    wedged, release = threading.Event(), threading.Event()

    def stuck():
        beat("stuck_subsystem")
        with get_tracer().span("serve:outer"), \
                get_tracer().span("serve:inner_wedge"):
            wedged.set()
            release.wait(5.0)

    t = threading.Thread(target=stuck, daemon=True)
    t.start()
    wedged.wait(5.0)
    time.sleep(0.05)
    try:
        bundle = assemble_bundle(reason="test")
        assert bundle["format"] == BUNDLE_FORMAT
        assert {"threads", "open_spans", "metrics", "flight_tail",
                "heartbeats", "culprit"} <= set(bundle)
        culprit = bundle["culprit"]
        assert culprit["span"] == "serve:inner_wedge", culprit
        assert culprit["tid"] == t.ident
    finally:
        release.set()
        t.join(5.0)


def test_replica_fault_kinds():
    """The replica kinds a gateway with a ``replica_rank`` consults:
    ``slow_replica`` stalls, ``partition_replica`` opens a heartbeat
    window, ``kill_replica`` kills at a request or a streamed token."""
    faultinject.set_schedule(FaultSchedule([
        Fault("slow_replica", rank=1, at_call=1, duration=0.25),
        Fault("partition_replica", rank=1, at_call=2, duration=0.0),
        Fault("kill_replica", rank=2, at_call=1),
        Fault("kill_replica", rank=3, step=2)]))
    assert faultinject.on_replica_request(1) == (0.25, False)
    assert not faultinject.heartbeat_suppressed(1)
    assert faultinject.on_replica_request(1) == (0.0, False)
    assert faultinject.heartbeat_suppressed(1)
    assert not faultinject.heartbeat_suppressed(2)
    assert faultinject.on_replica_request(2) == (0.0, True)
    assert not faultinject.check_kill_replica_token(3)
    assert faultinject.check_kill_replica_token(3)
    assert _counter("resilience_faults_injected_total") == 4
    faultinject.clear()
    assert not faultinject.heartbeat_suppressed(1)


def test_iris_matches_the_jax_package():
    a, b = load_iris(), jload_iris()
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    it = IrisDataSetIterator(50)
    assert [ds.num_examples() for ds in it] == [50, 50, 50]


# ---------------------------------------------------------------------------
# keras gateway: burst/shed, deadline, breaker, drain, LRU
# ---------------------------------------------------------------------------

def _iris_conf(builder, dense, output, input_type):
    return (builder.builder().updater("adam")
            .learning_rate(0.05).seed(7).list()
            .layer(dense(n_out=8, activation="relu"))
            .layer(output(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.feed_forward(4)).build())


@pytest.fixture(scope="module")
def iris_zip(tmp_path_factory):
    conf = _iris_conf(NeuralNetConfiguration, DenseLayer, OutputLayer,
                      InputType)
    net = MultiLayerNetwork(conf, device="cpu").init()
    path = tmp_path_factory.mktemp("serving") / "iris.zip"
    ModelSerializer.write_model(net, str(path))
    x = tmp_path_factory.mktemp("serving_x") / "x.npy"
    np.save(x, load_iris().features[:4])
    return str(path), str(x)


def test_keras_health_op_and_envelope(iris_zip):
    model, x = iris_zip
    srv = Server()
    try:
        cli = KerasClient(srv.host, srv.port)
        h = cli.health()
        assert h["live"] and not h["draining"]
        assert not h["ready"] and "model_loaded" in h["reasons"]
        cli.predict(x, model=model)
        h = cli.health()
        assert h["ready"] and h["reasons"] == []
        r = cli.readyz()
        assert r["ready"] and r["checks"] == {"model_loaded": True,
                                              "prewarm_done": True}
        assert r["models"] == [model] and r["inflight"] == 0
        assert cli.debug()["format"] == BUNDLE_FORMAT
        cli.close()
    finally:
        srv.stop()


def test_keras_deadline_exceeded_on_hung_backend(iris_zip):
    model, x = iris_zip
    srv = Server()
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)  # warm: load + runner
        faultinject.set_schedule(FaultSchedule(
            [Fault("hang_backend", at_call=1, duration=0.4)]))
        with pytest.raises(RuntimeError, match="DEADLINE"):
            cli.request(op="predict", features=x, model=model,
                        deadline_ms=100)
        assert _counter("serving_deadline_exceeded_total") >= 1
        cli.close()
    finally:
        srv.stop()


def test_keras_breaker_lifecycle_over_the_wire(tmp_path, iris_zip):
    """K consecutive load failures open the model's breaker; requests
    fail fast while open; once the cause is fixed the half-open probe
    closes it again."""
    model, x = iris_zip
    late = tmp_path / "late.zip"
    srv = Server(breaker_failures=2, breaker_cooldown_base=0.05,
                 breaker_cooldown_max=0.1)
    try:
        cli = KerasClient(srv.host, srv.port)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                cli.request(op="predict", features=x, model=str(late))
        with pytest.raises(RuntimeError, match="BREAKER_OPEN"):
            cli.request(op="predict", features=x, model=str(late))
        assert get_registry().get("serving_breaker_state").value == OPEN
        # fix the backend: now the half-open probe should close it
        import shutil
        shutil.copy(model, late)

        def recovered():
            try:
                cli.request(op="predict", features=x, model=str(late))
                return True
            except RuntimeError:
                return False

        _wait_until(recovered, msg="breaker recovery")
        assert get_registry().get("serving_breaker_state").value == CLOSED
        cli.close()
    finally:
        srv.stop()


def test_keras_burst_sheds_breaker_recovers_no_thread_leak(iris_zip):
    """hang_backend + a 50-request burst against queue depth 4 ->
    structured sheds, breaker opens and later recovers via half-open
    probe, no handler thread leaks, and the serving_* metrics appear."""
    model, x = iris_zip
    n0 = threading.active_count()
    srv = Server(max_concurrency=1, queue_depth=4,
                 breaker_failures=3, breaker_cooldown_base=2.0,
                 breaker_cooldown_max=2.0, io_timeout=30.0,
                 # hung dispatches (0.5s) must count as slow calls;
                 # impatient-deadline failures faster than this do not
                 # open the breaker
                 breaker_slow_call_s=0.3)
    try:
        warm = KerasClient(srv.host, srv.port)
        warm.predict(x, model=model)  # load outside the storm
        faultinject.set_schedule(FaultSchedule(
            [Fault("hang_backend", at_call=k, duration=0.5)
             for k in (1, 2, 3)] + [Fault("burst", count=50)]))
        n_burst = faultinject.burst_size()
        assert n_burst == 50
        outcomes = []
        out_lock = threading.Lock()

        def one_request():
            try:
                cli = KerasClient(srv.host, srv.port)
                try:
                    cli.request(op="predict", features=x, model=model,
                                deadline_ms=300)
                    result = "ok"
                finally:
                    cli.close()
            except RuntimeError as e:
                result = str(e).split(":")[0]
            except (ConnectionError, OSError):
                result = "conn"
            with out_lock:
                outcomes.append(result)

        threads = [threading.Thread(target=one_request, daemon=True)
                   for _ in range(n_burst)]
        for t in threads:
            t.start()
            # a burst with a tail: later arrivals must observe OPEN
            time.sleep(0.04)
        for t in threads:
            t.join(30.0)
        assert len(outcomes) == n_burst
        # every outcome is structured: success or a known error code
        assert set(outcomes) <= {"ok", "SHED", "DEADLINE", "BREAKER_OPEN"}
        assert _counter("serving_shed_total") > 0
        assert _counter("serving_deadline_exceeded_total") > 0
        assert "BREAKER_OPEN" in outcomes  # the breaker opened mid-burst
        snap = get_registry().snapshot("serving_")
        for name in ("serving_shed_total",
                     "serving_deadline_exceeded_total",
                     "serving_breaker_state"):
            assert name in snap
        cli = KerasClient(srv.host, srv.port)

        def recovered():
            try:
                cli.request(op="predict", features=x, model=model,
                            deadline_ms=5000)
                return True
            except RuntimeError as e:
                assert "BREAKER_OPEN" in str(e)
                return False

        _wait_until(recovered, timeout=10.0, msg="breaker recovery")
        assert get_registry().get("serving_breaker_state").value == CLOSED
        cli.close()
    finally:
        assert srv.drain(grace_s=5.0)
    _wait_until(lambda: threading.active_count() <= n0 + 2,
                timeout=10.0, msg="handler threads reclaimed")


def test_impatient_client_deadline_does_not_open_breaker(iris_zip):
    """A blown CLIENT budget on a fast backend is the client's problem:
    sub-second dispatches that merely outran a tiny deadline_ms never
    open the shared breaker."""
    model, x = iris_zip
    srv = Server(breaker_failures=1)  # hair trigger
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)  # warm
        faultinject.set_schedule(FaultSchedule(
            [Fault("hang_backend", at_call=1, duration=0.2)]))
        with pytest.raises(RuntimeError, match="DEADLINE"):
            cli.request(op="predict", features=x, model=model,
                        deadline_ms=50)
        assert cli.predict(x, model=model).shape == (4, 3)
        assert get_registry().get("serving_breaker_state").value == CLOSED
        cli.close()
    finally:
        srv.stop()


def test_keras_drain_finishes_inflight_rejects_new(iris_zip):
    model, x = iris_zip
    srv = Server()
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)  # warm
        faultinject.set_schedule(FaultSchedule(
            [Fault("hang_backend", at_call=1, duration=0.6)]))
        slow = {}

        def slow_predict():
            c = KerasClient(srv.host, srv.port)
            slow["resp"] = c.request(op="predict", features=x,
                                     model=model)
            c.close()

        t = threading.Thread(target=slow_predict, daemon=True)
        t.start()
        _wait_until(lambda: srv._guard.inflight == 1,
                    msg="slow predict admitted")
        drained = {}
        d = threading.Thread(
            target=lambda: drained.update(ok=srv.drain(grace_s=5.0)),
            daemon=True)
        d.start()
        _wait_until(lambda: srv.draining, msg="drain mode")
        with pytest.raises(RuntimeError, match="DRAINING"):
            cli.request(op="predict", features=x, model=model)
        t.join(10.0)
        d.join(10.0)
        assert slow["resp"]["ok"]  # in-flight work finished during grace
        assert drained["ok"] is True
        cli.close()
    finally:
        srv.stop()


def test_keras_model_cache_lru_and_per_model_lock(tmp_path, iris_zip):
    model, x = iris_zip
    import shutil
    paths = []
    for i in range(3):
        p = tmp_path / f"m{i}.zip"
        shutil.copy(model, p)
        paths.append(str(p))
    srv = Server(keep_models=2)
    try:
        cli = KerasClient(srv.host, srv.port)
        for p in paths:
            cli.predict(x, model=p)
        assert len(srv._models) <= 2
        assert _counter("serving_models_evicted_total") >= 1
        preds = cli.predict(x, model=paths[0])
        assert preds.shape == (4, 3)
        # per-model lock identity: same path -> same lock, distinct
        # paths -> distinct locks (fit/predict on one model serialize)
        _, l0a = srv._get_model(paths[0])
        _, l0b = srv._get_model(paths[0])
        _, l1 = srv._get_model(paths[1])
        assert l0a is l0b and l0a is not l1
        cli.close()
    finally:
        srv.stop()


def test_keras_slow_loris_client_reclaimed():
    srv = Server(io_timeout=0.3)
    try:
        s = socket.create_connection((srv.host, srv.port))
        s.settimeout(5.0)
        s.sendall(b'{"op": "pre')  # dribble and stall
        assert s.recv(1) == b""  # server hung up
        assert _counter("serving_idle_timeouts_total") >= 1
        assert _counter("serving_deadline_exceeded_total") == 0
        s.close()
    finally:
        srv.stop()


def test_keras_nonfinite_prediction_refused(iris_zip, tmp_path):
    model, _ = iris_zip
    x = tmp_path / "nan_x.npy"
    np.save(x, np.full((2, 4), np.nan, np.float32))
    srv = Server()
    try:
        cli = KerasClient(srv.host, srv.port)
        with pytest.raises(RuntimeError, match="NONFINITE"):
            cli.request(op="predict", features=str(x), model=model)
        assert _counter("serving_nonfinite_outputs_total") == 1
        cli.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# continuous batching: batchmate isolation under chaos
# ---------------------------------------------------------------------------

def _flushes(reason: str) -> float:
    fam = get_registry().get("serving_batch_flushes_total")
    return 0.0 if fam is None else fam.labels(reason=reason).value


def test_batch_poison_row_fails_alone(iris_zip):
    """poison_row chaos: ONE request in a coalesced batch turns
    nonfinite; the per-row sentinel fails it alone, its batchmates are
    served, and the client-input failure never charges the breaker."""
    model, x = iris_zip
    srv = Server(max_concurrency=8, queue_depth=16, max_batch=8,
                 max_wait_ms=200.0, breaker_failures=1)
    try:
        warm = KerasClient(srv.host, srv.port)
        warm.predict(x, model=model)
        warm.close()
        faultinject.set_schedule(FaultSchedule(
            [Fault("poison_row", at_call=2)]))
        outcomes, lock = [], threading.Lock()
        start = threading.Barrier(3)

        def one():
            try:
                cli = KerasClient(srv.host, srv.port)
                try:
                    start.wait(10.0)
                    cli.request(op="predict", features=x, model=model)
                    r = "ok"
                finally:
                    cli.close()
            except RuntimeError as e:
                r = str(e).split(":")[0]
            with lock:
                outcomes.append(r)

        threads = [threading.Thread(target=one, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert sorted(outcomes) == ["NONFINITE", "ok", "ok"], outcomes
        assert _counter("serving_nonfinite_outputs_total") == 1
        assert _counter("resilience_faults_injected_total") == 1
        assert get_registry().get("serving_breaker_state").value == CLOSED
        cli = KerasClient(srv.host, srv.port)
        assert cli.predict(x, model=model).shape == (4, 3)
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


def test_batch_deadline_blown_member_fails_alone(iris_zip):
    """slow_batch chaos: a stalled batched dispatch blows ONE member's
    tight budget. That member alone gets DEADLINE, its batchmate is
    served, the deadline-aware flush is counted, the breaker untouched."""
    model, x = iris_zip
    srv = Server(max_concurrency=8, queue_depth=16,
                 # two 4-row requests must NOT fill the bucket — only
                 # the deadline-aware path may flush
                 max_batch=32, max_wait_ms=30_000.0,
                 batch_deadline_margin_ms=50.0, breaker_failures=1)
    try:
        # the warm-up fills its bucket, so it flushes at once (alone and
        # short, the idle window would hold it 30 s)
        full = str(Path(x).with_name("x32.npy"))
        np.save(full, np.tile(np.load(x), (8, 1)))
        warm = KerasClient(srv.host, srv.port)
        assert warm.predict(full, model=model).shape == (32, 3)
        warm.close()
        flushes_before = _flushes("deadline")
        faultinject.set_schedule(FaultSchedule(
            [Fault("slow_batch", at_call=1, duration=0.6)]))
        results = {}
        lock = threading.Lock()
        start = threading.Barrier(2)

        def one(name, deadline_ms):
            try:
                cli = KerasClient(srv.host, srv.port)
                try:
                    start.wait(10.0)
                    cli.request(op="predict", features=x, model=model,
                                deadline_ms=deadline_ms)
                    r = "ok"
                finally:
                    cli.close()
            except RuntimeError as e:
                r = str(e).split(":")[0]
            with lock:
                results[name] = r

        threads = [
            threading.Thread(target=one, args=("patient", 30_000),
                             daemon=True),
            threading.Thread(target=one, args=("tight", 300),
                             daemon=True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert results == {"patient": "ok", "tight": "DEADLINE"}, results
        assert _flushes("deadline") >= flushes_before + 1
        assert _counter("serving_deadline_exceeded_total") >= 1
        assert get_registry().get("serving_breaker_state").value == CLOSED
    finally:
        srv.drain(grace_s=5.0)


def test_batch_level_failure_falls_back_to_singletons(iris_zip, tmp_path):
    """A batch-level execution failure re-runs each member ALONE before
    anything surfaces: healthy members succeed via the singleton
    fallback, counted."""
    model, x = iris_zip
    srv = Server(max_batch=8, max_wait_ms=50.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)  # load + warm
        key, bucket = model, 4
        shape_key = ((4,), "float32")

        def boom(_x):
            raise RuntimeError("injected batch-step failure")
        srv._batcher._compiled.put(
            (srv._batcher._cache_owner, key, bucket, shape_key), boom)
        got = cli.predict(x, model=model)  # singleton fallback serves it
        assert got.shape == (4, 3)
        assert _counter("serving_batch_fallbacks_total") == 1
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------

def test_unported_paths_raise_naming_their_roadmap_item(tmp_path,
                                                        iris_zip):
    """``tuned=`` takes the autotuner's config, as the JAX gateway does:
    the batching scheduler's ``max_batch`` becomes its top serving bucket
    (an explicit one wins); the two ``.h5`` requests that once refused
    naming A7.1 are served: an ``.h5`` batch file (its first dataset,
    written by the port's ``Hdf5Writer``) answers as its ``.npy`` twin
    does, and a Keras ``.h5`` model path imports and answers its golden
    outputs."""
    from deeplearning4j_tpu_torch.autotune import TunedConfig
    model, x = iris_zip
    tuned = TunedConfig(dp=2, global_batch=16, device_count=2,
                        serve_buckets=(1, 2, 4, 8))
    for kw, want in (({}, 8), ({"max_batch": 4}, 4)):
        tuned_srv = Server(tuned=tuned, **kw)
        try:
            assert tuned_srv._batcher.max_batch == want
        finally:
            tuned_srv.drain(grace_s=5.0)
    h5 = tmp_path / "x.h5"
    with Hdf5Writer(str(h5)) as w:
        w.write_dataset("/features", np.load(x))
    fixtures = Path(__file__).resolve().parent / "fixtures"
    goldens = np.load(fixtures / "keras_goldens.npz")
    keras_x = tmp_path / "keras_x.npy"
    np.save(keras_x, goldens["mlp_x"])
    srv = Server()
    try:
        cli = KerasClient(srv.host, srv.port)
        np.testing.assert_array_equal(cli.predict(str(h5), model=model),
                                      cli.predict(x, model=model))
        got = cli.predict(str(keras_x), model=str(fixtures / "keras_mlp.h5"))
        np.testing.assert_allclose(got, goldens["mlp_y"], atol=1e-5)
        cli.close()
    finally:
        srv.stop()


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasServer()
    assert not service._guards     # nothing was registered


def _char_batches(rng, n, rows, T, V):
    """``n`` one-hot (features, next-char labels) batches."""
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (rows, T + 1))
        eye = np.eye(V, dtype=np.float32)
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _batch_dirs(tmp_path, batches):
    fd, ld = tmp_path / "features", tmp_path / "labels"
    fd.mkdir()
    ld.mkdir()
    for i, (f, l) in enumerate(batches):
        np.save(fd / f"{i:03d}.npy", f)
        np.save(ld / f"{i:03d}.npy", l)
    return str(fd), str(ld)


def test_fit_evaluate_then_predict_serves_the_new_weights(tmp_path):
    """A server ``fit`` on a char-RNN (tBPTT over .npy batch files)
    trains the served net as the same calls train a restored copy, an
    ``evaluate`` answers that net's own accuracy, and the next predicts
    answer the fitted weights (no runner serves stale ones)."""
    rng = np.random.default_rng(31)
    conf = char_rnn_lstm(RNN_VOCAB, 32, 2, tbptt_length=4)
    net = MultiLayerNetwork(conf, device="cpu").init()
    path = str(tmp_path / "rnn.zip")
    ModelSerializer.write_model(net, path)
    batches = _char_batches(rng, 2, 4, RNN_T, RNN_VOCAB)
    fdir, ldir = _batch_dirs(tmp_path, batches)
    x = tmp_path / "x.npy"
    np.save(x, batches[0][0][:3])
    twin = ModelSerializer.restore_model(path, device="cpu")
    srv = Server(max_batch=8, max_wait_ms=2.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        before = cli.predict(str(x), model=path)
        resp = cli.fit(path, fdir, ldir, nb_epoch=2)
        for _ in range(2):
            twin.fit(ListDataSetIterator([DataSet(f, l)
                                          for f, l in batches]))
        served = srv._models[path]
        np.testing.assert_array_equal(served.params_flat(),
                                      twin.params_flat())
        assert resp["score"] == pytest.approx(twin.score_value, abs=0)
        after = cli.predict(str(x), model=path)
        assert np.abs(after - before).max() > 1e-4       # weights moved
        np.testing.assert_allclose(
            after, served.output(np.load(x)).numpy(), rtol=0, atol=1e-5)
        ev = cli.request(op="evaluate", model=path, features_dir=fdir,
                         labels_dir=ldir)
        want = twin.evaluate(ListDataSetIterator(
            [DataSet(f, l) for f, l in batches]))
        assert ev["accuracy"] == want.accuracy()
        assert ev["f1"] == want.f1()
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


@pytest.fixture(scope="module")
def gpt_zip(tmp_path_factory):
    net = ComputationGraph(gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN),
                           device="cpu").init()
    path = tmp_path_factory.mktemp("gpt") / "gpt.zip"
    ModelSerializer.write_model(net, str(path))
    return str(path), net


def test_generate_greedy_sampled_and_streamed_over_the_wire(gpt_zip):
    model, net = gpt_zip
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
    srv = Server(max_batch=4)
    try:
        cli = KerasClient(srv.host, srv.port)
        got = cli.generate(prompts[0], 5, model=model)
        assert got["ok"] and got["tokens"] == greedy_generate(
            net, prompts[0], 5)
        got = cli.generate(prompts[1], 5, model=model,
                           sampling={"temperature": 0.8, "seed": 3})
        assert got["tokens"] == sample_generate(net, prompts[1], 5, 0.8, 3)
        # streamed: one partial line per token, then the envelope
        s = socket.create_connection((srv.host, srv.port))
        f = s.makefile("rwb")
        f.write(b'{"op": "generate", "stream": true, "tokens": [9], '
                b'"max_new_tokens": 4, "model": "' + model.encode()
                + b'"}\n')
        f.flush()
        import json
        lines = [json.loads(f.readline()) for _ in range(5)]
        assert [ln["t"] for ln in lines[:4]] == greedy_generate(
            net, prompts[2], 4)
        assert all(ln["partial"] for ln in lines[:4])
        assert lines[4]["ok"] and lines[4]["tokens"] == [
            ln["t"] for ln in lines[:4]]
        f.close()
        s.close()
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


def test_drain_and_stop_return_threads_to_baseline(gpt_zip, iris_zip):
    """Teardown: a server that served predicts on two models and a
    generation (dispatchers, a decode loop, handler threads, a prewarm
    thread) leaves no thread behind after ``drain`` and ``stop``."""
    model, _ = gpt_zip
    imodel, x = iris_zip
    base = set(threading.enumerate())
    srv = Server(max_batch=4, max_wait_ms=2.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=imodel)
        cli.generate([1, 2], 3, model=model)
        assert len(set(threading.enumerate()) - base) >= 3
        cli.close()
    finally:
        assert srv.drain(grace_s=5.0)
        srv.stop()
    _wait_until(lambda: not (set(threading.enumerate()) - base),
                timeout=10.0,
                msg=f"threads back to baseline: "
                    f"{set(threading.enumerate()) - base}")
    assert not service._guards


def test_lockcheck_clean_on_the_serving_modules():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "lockcheck.py"),
         str(ROOT / "deeplearning4j_tpu_torch" / "keras"),
         str(ROOT / "deeplearning4j_tpu_torch" / "resilience")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lockcheck: clean" in out.stdout


# ---------------------------------------------------------------------------
# parity with the JAX package's gateway on one JAX-written archive
# ---------------------------------------------------------------------------

def _jax_iris(tmp):
    conf = _iris_conf(JConf, JDense, JOutput, JInputType)
    net = JMultiLayerNetwork(conf).init()
    rng = np.random.default_rng(41)
    feats = [rng.normal(size=(r, 4)).astype(np.float32)
             for r in (1, 2, 3, 5)]
    return net, feats


def _jax_char_rnn(tmp):
    net = JMultiLayerNetwork(jchar_rnn.char_rnn_lstm(RNN_VOCAB, 32,
                                                     2)).init()
    rng = np.random.default_rng(42)
    eye = np.eye(RNN_VOCAB, dtype=np.float32)
    feats = [eye[rng.integers(0, RNN_VOCAB, (r, RNN_T))]
             for r in (1, 2, 3, 5)]
    return net, feats


def _jax_gpt(tmp):
    net = JGraph(jgpt.gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN)).init()
    rng = np.random.default_rng(43)
    eye = np.eye(VOCAB, dtype=np.float32)
    feats = [eye[rng.integers(0, VOCAB, (r, SEQ_LEN))]
             for r in (1, 2, 3, 5)]
    return net, feats


def _ragged_predicts(srv, client_cls, model, files):
    """Every file predicted at once from its own connection: the rows
    coalesce into shared buckets."""
    out, lock = {}, threading.Lock()
    start = threading.Barrier(len(files))

    def one(i):
        cli = client_cls(srv.host, srv.port)
        try:
            start.wait(10.0)
            y = cli.predict(files[i], model=model)
            with lock:
                out[i] = y
        finally:
            cli.close()

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(files))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert sorted(out) == list(range(len(files)))
    return [out[i] for i in range(len(files))]


@pytest.mark.parametrize("which", ["iris", "char_rnn", "gpt"])
def test_jax_archive_served_by_both_gateways_agree(tmp_path, monkeypatch,
                                                   which):
    """One archive written by the JAX package, served by the JAX gateway
    and by the port's, under the same ragged concurrent predicts: each
    request's answers agree within 1e-5 (the JAX LSTM kernel runs
    interpreted, as the JAX package's own tests run it)."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, feats = {"iris": _jax_iris, "char_rnn": _jax_char_rnn,
                   "gpt": _jax_gpt}[which](tmp_path)
    model = str(tmp_path / f"{which}.zip")
    JSerializer.write_model(jnet, model)
    files = []
    for i, f in enumerate(feats):
        files.append(str(tmp_path / f"x{i}.npy"))
        np.save(files[-1], f)
    answers = {}
    for name, mk, cli_cls in (
            ("jax", lambda: jserver.KerasServer(max_batch=8,
                                                max_wait_ms=30.0),
             jserver.KerasClient),
            ("port", lambda: Server(max_batch=8, max_wait_ms=30.0),
             KerasClient)):
        srv = mk()
        try:
            answers[name] = _ragged_predicts(srv, cli_cls, model, files)
        finally:
            srv.drain(grace_s=5.0)
    for i, (a, b) in enumerate(zip(answers["port"], answers["jax"])):
        assert a.shape == b.shape == (len(feats[i]),) + b.shape[1:]
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_JAX,
                                   err_msg=f"{which} request {i}")


def test_generate_tokens_equal_the_jax_gateway(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, _ = _jax_gpt(tmp_path)
    model = str(tmp_path / "gpt.zip")
    JSerializer.write_model(jnet, model)
    asks = [([1, 2, 3], None), ([4, 5, 6, 7, 8], None),
            ([9, 3], {"temperature": 0.8, "seed": 7})]
    tokens = {}
    for name, mk, cli_cls in (
            ("jax", lambda: jserver.KerasServer(max_batch=4),
             jserver.KerasClient),
            ("port", lambda: Server(max_batch=4), KerasClient)):
        srv = mk()
        try:
            cli = cli_cls(srv.host, srv.port)
            tokens[name] = [
                cli.generate(p, 6, model=model,
                             **({"sampling": s} if s else {}))["tokens"]
                for p, s in asks]
            cli.close()
        finally:
            srv.drain(grace_s=5.0)
    assert tokens["port"] == tokens["jax"]


def _error_codes(mk, client_cls, fi, model, x, nan_x, missing):
    """Drive one gateway through the five structured refusals; returns
    each case's answer code."""
    codes = {}
    srv = mk(max_concurrency=1, queue_depth=0, breaker_failures=2,
             breaker_cooldown_base=30.0, breaker_cooldown_max=30.0)
    try:
        cli = client_cls(srv.host, srv.port)
        cli.predict(x, model=model)                      # warm
        codes["nonfinite"] = _code(lambda: cli.request(
            op="predict", features=nan_x, model=model))
        fi.set_schedule(fi.FaultSchedule(
            [fi.Fault("hang_backend", at_call=1, duration=0.4)]))
        codes["deadline"] = _code(lambda: cli.request(
            op="predict", features=x, model=model, deadline_ms=100))
        # the only slot held by a hung request, no queue: SHED
        fi.set_schedule(fi.FaultSchedule(
            [fi.Fault("hang_backend", at_call=1, duration=0.8)]))
        holder = threading.Thread(
            target=lambda: _code(lambda: client_cls(
                srv.host, srv.port).predict(x, model=model)),
            daemon=True)
        holder.start()
        _wait_until(lambda: srv._guard.inflight == 1, msg="slot held")
        codes["shed"] = _code(lambda: cli.request(
            op="predict", features=x, model=model))
        holder.join(10.0)
        fi.clear()
        # two failed loads open the breaker
        codes["load"] = [_code(lambda: cli.request(
            op="predict", features=x, model=missing)) for _ in range(2)]
        codes["breaker"] = _code(lambda: cli.request(
            op="predict", features=x, model=missing))
        srv._guard.start_drain()
        codes["draining"] = _code(lambda: cli.request(
            op="predict", features=x, model=model))
        cli.close()
    finally:
        fi.clear()
        srv.drain(grace_s=5.0)
    return codes


def test_structured_errors_match_the_jax_gateway(tmp_path):
    jnet, _ = _jax_iris(tmp_path)
    model = str(tmp_path / "iris.zip")
    JSerializer.write_model(jnet, model)
    x, nan_x = str(tmp_path / "x.npy"), str(tmp_path / "nan.npy")
    np.save(x, load_iris().features[:4])
    np.save(nan_x, np.full((2, 4), np.nan, np.float32))
    missing = str(tmp_path / "missing.zip")
    jcodes = _error_codes(jserver.KerasServer, jserver.KerasClient,
                          jfaultinject, model, x, nan_x, missing)
    codes = _error_codes(Server, KerasClient, faultinject, model, x, nan_x,
                         missing)
    assert {k: v for k, v in jcodes.items() if k != "load"} == {
        "nonfinite": "NONFINITE", "deadline": "DEADLINE", "shed": "SHED",
        "breaker": "BREAKER_OPEN", "draining": "DRAINING"}
    assert codes == jcodes
