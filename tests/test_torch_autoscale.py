"""The port's fleet autoscaling and overload degradation on the CPU
(``deeplearning4j_tpu_torch/keras/autoscale.py`` and the router's
retry budget and brownout): the thirteen cases of
``tests/test_autoscale.py`` against the port.

Units pin the controller policy (hysteresis, cooldowns, brownout state
machine), the retry-budget token bucket, and the flap tracker's
probation math with injected clocks/rngs; the integration tests run a
real port router (real sockets) with replicas on ``device="cpu"`` to
prove budget-gated fail-fast, bulk-only brownout shedding, and zero-drop
scale-down through the drain seam. The same policy on the card is
``chip_smoke.py``'s ``serve_fleet`` phase."""

import json
import random
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_tpu_torch import (InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch.keras.autoscale import (FlapTracker,
                                                      FleetAutoscaler)
from deeplearning4j_tpu_torch.keras.fleet import (FleetReplica, FleetRouter,
                                                  _ForwardFailure, _Replica)
from deeplearning4j_tpu_torch.keras.server import KerasClient
from deeplearning4j_tpu_torch.nn.layers import OutputLayer
from deeplearning4j_tpu_torch.profiling.metrics import (MetricsRegistry,
                                                        get_registry,
                                                        set_registry)
from deeplearning4j_tpu_torch.resilience import faultinject, service
from deeplearning4j_tpu_torch.resilience.service import (CircuitBreaker,
                                                         RetryBudget)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = set_registry(MetricsRegistry())
    yield
    faultinject.clear()
    with service._guards_lock:
        service._guards.clear()
    set_registry(prev)


@pytest.fixture()
def workload(tmp_path):
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


def _counter(name):
    m = get_registry().get(name)
    return 0 if m is None else m.value


def _raw(router, **req):
    """One request over a raw socket: the actual wire envelope, so
    structured sheds (and their retry_after_ms) are observable."""
    with socket.create_connection((router.host, router.port),
                                  timeout=30.0) as s:
        f = s.makefile("rwb")
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        line = f.readline()
        f.close()
    return json.loads(line)


# ------------------------------------------------------------ retry budget

def test_retry_budget_token_bucket_math():
    b = RetryBudget(capacity=2.0, refill_ratio=0.5)
    assert b.tokens == 2.0
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()          # dry
    b.on_success()
    assert b.tokens == 0.5
    assert not b.try_spend()          # half a token is not a retry
    b.on_success()
    assert b.try_spend()              # 1.0 -> spendable
    for _ in range(100):              # refill caps at capacity
        b.on_success()
    assert b.tokens == 2.0


def test_retry_budget_exhaustion_fails_fast_one_free_reroute(tmp_path):
    """Dry budget: a failed dispatch gets exactly ONE reroute, then the
    structured error surfaces — never the full retries-deep storm."""
    router = FleetRouter(str(tmp_path / "fleet"), poll_s=30.0,
                         metrics_port=None, retries=4,
                         retry_budget_capacity=0.0,
                         backoff_base_s=0.001, backoff_max_s=0.002)
    try:
        with router._lock:
            for rank in (0, 1):
                router._replicas[rank] = _Replica(
                    rank, "127.0.0.1", 1,
                    CircuitBreaker(key=f"t{rank}", failures=100))
        calls = []

        def failing(rep, fwd, deadline, on_partial=None, sock_slot=None):
            calls.append(rep.rank)
            raise _ForwardFailure(rep, ConnectionError("boom"),
                                  dead_connection=False)

        router._forward = failing
        with pytest.raises(RuntimeError, match="retry budget exhausted"):
            router._handle({"op": "predict", "features": "x"})
        assert len(calls) == 2, calls  # initial + the one free reroute
        assert _counter("fleet_retry_budget_exhausted_total") == 2
    finally:
        router.close()


def test_funded_budget_allows_full_retry_storm(tmp_path):
    """Control for the fail-fast test: with tokens in the bucket the
    same failure pattern retries the full ``retries`` depth."""
    router = FleetRouter(str(tmp_path / "fleet"), poll_s=30.0,
                         metrics_port=None, retries=4,
                         retry_budget_capacity=10.0,
                         backoff_base_s=0.001, backoff_max_s=0.002)
    try:
        with router._lock:
            for rank in (0, 1):
                router._replicas[rank] = _Replica(
                    rank, "127.0.0.1", 1,
                    CircuitBreaker(key=f"t{rank}", failures=100))
        calls = []

        def failing(rep, fwd, deadline, on_partial=None, sock_slot=None):
            calls.append(rep.rank)
            raise _ForwardFailure(rep, ConnectionError("boom"),
                                  dead_connection=False)

        router._forward = failing
        with pytest.raises(RuntimeError, match="attempts exhausted"):
            router._handle({"op": "predict", "features": "x"})
        assert len(calls) == 5, calls  # initial + retries(4)
        assert _counter("fleet_retry_budget_exhausted_total") == 0
    finally:
        router.close()


def test_hedges_are_budget_gated(tmp_path):
    """A hedge is pure amplification: dry budget skips it entirely (the
    request still completes on the primary); a funded budget hedges and
    counts it."""
    router = FleetRouter(str(tmp_path / "fleet"), poll_s=30.0,
                         metrics_port=None, hedge_ms=40.0,
                         retry_budget_capacity=0.0)
    try:
        with router._lock:
            for rank in (0, 1):
                router._replicas[rank] = _Replica(
                    rank, "127.0.0.1", 1,
                    CircuitBreaker(key=f"t{rank}", failures=100))

        def slow_ok(rep, fwd, deadline, on_partial=None, sock_slot=None):
            time.sleep(0.2)
            return {"ok": True, "predictions": [[0.5, 0.5]]}, 0

        router._forward = slow_ok
        resp = router._handle({"op": "predict", "features": "x"})
        assert resp.get("ok")
        assert _counter("fleet_hedges_total") == 0
        assert _counter("fleet_retry_budget_exhausted_total") >= 1

        router._retry_budget = RetryBudget(capacity=5.0)
        resp = router._handle({"op": "predict", "features": "x"})
        assert resp.get("ok")
        assert _counter("fleet_hedges_total") == 1
    finally:
        router.close()


# ------------------------------------------------------------ flap tracker

def test_flap_tracker_strike_window_and_delay_growth():
    clock = [0.0]
    t = FlapTracker(window_s=10.0, strikes_to_quarantine=2, base_s=1.0,
                    max_s=8.0, rng=random.Random(0),
                    now_fn=lambda: clock[0])

    def cycle():
        t.on_admit(5)
        clock[0] += 0.5  # dies well inside the window
        return t.on_remove(5, "dead_connection")

    assert cycle() is None            # strike 1: not yet quarantined
    assert not t.blocked(5)
    d1 = cycle()                      # strike 2: probation starts
    assert d1 is not None and 0.5 <= d1 < 1.0   # base episode, jittered
    assert t.blocked(5)
    clock[0] += d1 + 0.01
    assert not t.blocked(5)           # delay elapsed: admissible again
    d2 = cycle()                      # strike 3: delay grows
    assert d2 is not None and 1.0 <= d2 < 2.0
    clock[0] += d2 + 0.01
    d3 = cycle()
    assert d3 is not None and 2.0 <= d3 < 4.0   # exponential, bounded
    assert t.strikes(5) == 4


def test_flap_tracker_clean_leave_and_long_tenure_never_strike():
    clock = [0.0]
    t = FlapTracker(window_s=5.0, strikes_to_quarantine=2,
                    now_fn=lambda: clock[0])
    # a drained replica retires its heartbeat: not a flap
    t.on_admit(3)
    clock[0] += 0.1
    assert t.on_remove(3, "heartbeat_gone") is None
    assert t.strikes(3) == 0
    # a member that served past the window then died: failure, not flap
    t.on_admit(3)
    clock[0] += 0.2
    t.on_remove(3, "dead_connection")       # strike 1 (inside window)
    t.on_admit(3)
    clock[0] += 60.0                        # long, healthy tenure
    assert t.on_remove(3, "stale_heartbeat") is None
    assert t.strikes(3) == 0                # tenure reset the count
    # a removal with no admission on record can't strike
    assert t.on_remove(9, "dead_connection") is None


# ----------------------------------------------- autoscaler (stub router)

class _StubRouter:
    """The load_snapshot/set_brownout surface the controller ticks on,
    with instantly-admitting membership."""

    def __init__(self):
        self.stats = {}
        self.queued = 0
        self.epoch = 0
        self.brownout_calls = []

    def add(self, rank, **st):
        base = {"inflight": 0, "queued": 0, "ttft_p99_ms": 0.0,
                "breaker": 0, "score": 0.0}
        base.update(st)
        self.stats[int(rank)] = base

    def load_snapshot(self):
        return {"queued": self.queued, "inflight": 0,
                "max_concurrency": 8, "epoch": self.epoch,
                "brownout": False,
                "replicas": {k: dict(v) for k, v in self.stats.items()}}

    def set_brownout(self, active, reason=""):
        self.brownout_calls.append((bool(active), reason))


def _stub_autoscaler(stub, clock, **kw):
    spawned = []

    def spawn(rank):
        stub.add(rank)  # joins instantly (the stub's readyz gate)
        spawned.append(rank)
        handle = SimpleNamespace(rank=rank)
        handle.drain = lambda grace_s: (stub.stats.pop(rank, None),
                                        True)[1]
        return handle

    defaults = dict(min_replicas=1, max_replicas=3, queue_high=4,
                    up_ticks=3, down_ticks=3, up_cooldown_s=5.0,
                    down_cooldown_s=5.0, brownout=False, start=False,
                    now_fn=lambda: clock[0])
    defaults.update(kw)
    auto = FleetAutoscaler(stub, spawn, **defaults)
    return auto, spawned


def test_scale_up_needs_sustained_breach_not_a_blip():
    clock = [100.0]
    stub = _StubRouter()
    stub.add(0)
    auto, spawned = _stub_autoscaler(stub, clock, up_ticks=3)
    # transient blip: 2 breach ticks, then calm, resets the streak
    stub.queued = 8
    assert auto.tick()["action"] == "hold"
    assert auto.tick()["action"] == "hold"
    stub.queued = 0
    assert auto.tick()["action"] == "hold"
    stub.queued = 8
    auto.tick()
    auto.tick()
    assert spawned == []              # hysteresis held
    d = auto.tick()                   # third consecutive breach tick
    assert d["action"] == "up" and spawned == [1]
    assert "queue_depth" in d["reason"]
    assert _counter("fleet_autoscale_up_total") == 1
    assert get_registry().get("fleet_target_replicas").value == 2
    auto.drain()


def test_scale_up_cooldown_and_max_replicas_cap():
    clock = [100.0]
    stub = _StubRouter()
    stub.add(0)
    auto, spawned = _stub_autoscaler(stub, clock, up_ticks=1,
                                     up_cooldown_s=5.0, max_replicas=3)
    stub.queued = 8
    assert auto.tick()["action"] == "up"
    assert auto.tick()["reason"] == "up_cooldown"   # still breaching
    assert spawned == [1]
    clock[0] += 6.0
    assert auto.tick()["action"] == "up"
    assert spawned == [1, 2]
    clock[0] += 6.0
    assert auto.tick()["reason"] == "at_max"        # 3 members: capped
    assert len(stub.stats) == 3
    auto.drain()


def test_scale_down_after_idle_through_drain_seam_with_floor():
    clock = [100.0]
    stub = _StubRouter()
    stub.add(0)                       # pre-existing: not ours to drain
    auto, spawned = _stub_autoscaler(stub, clock, up_ticks=1,
                                     down_ticks=3, up_cooldown_s=0.0,
                                     down_cooldown_s=5.0)
    stub.queued = 8
    auto.tick()
    clock[0] += 1.0
    auto.tick()
    assert sorted(stub.stats) == [0, 1, 2]
    stub.queued = 0                   # idle from here on
    auto.tick()
    auto.tick()
    d = auto.tick()                   # third idle tick: first drain
    assert d["action"] == "down" and d["emptied"]
    assert len(stub.stats) == 2
    assert auto.tick()["reason"] == "down_cooldown"
    clock[0] += 6.0
    # streak kept building through the cooldown: next tick drains again
    assert auto.tick()["action"] == "down"
    assert sorted(stub.stats) == [0]
    # at the floor with no owned members left: hold forever
    clock[0] += 6.0
    for _ in range(4):
        assert auto.tick()["action"] == "hold"
    assert sorted(stub.stats) == [0]
    assert _counter("fleet_autoscale_down_total") == 2
    auto.drain()


def test_brownout_state_machine_enters_at_max_only_and_exits_on_calm():
    clock = [100.0]
    stub = _StubRouter()
    stub.add(0)
    auto, spawned = _stub_autoscaler(
        stub, clock, max_replicas=1, up_ticks=2, brownout=True,
        brownout_enter_ticks=3, brownout_exit_ticks=2)
    stub.queued = 8
    auto.tick()
    auto.tick()
    assert stub.brownout_calls == []  # breaching, but not long enough
    auto.tick()                       # enter_ticks reached at max size
    assert stub.brownout_calls == [(True, "queue_depth=8>=4")]
    auto.tick()                       # still in brownout: no re-entry
    assert len(stub.brownout_calls) == 1
    stub.queued = 0
    auto.tick()
    assert len(stub.brownout_calls) == 1   # one calm tick: not yet
    auto.tick()
    assert stub.brownout_calls[-1][0] is False
    assert _counter("fleet_brownout_entries_total") == 1
    auto.drain()


def test_spawn_failure_is_counted_and_survived():
    clock = [100.0]
    stub = _StubRouter()
    stub.add(0)

    def bad_spawn(rank):
        raise RuntimeError("launcher down")

    auto = FleetAutoscaler(stub, bad_spawn, min_replicas=1,
                           max_replicas=3, queue_high=4, up_ticks=1,
                           brownout=False, start=False,
                           now_fn=lambda: clock[0])
    stub.queued = 8
    assert auto.tick()["reason"] == "spawn_failed"
    assert _counter("fleet_autoscale_spawn_failures_total") == 1
    clock[0] += 10.0
    assert auto.tick()["reason"] == "spawn_failed"  # keeps trying
    auto.drain()


# -------------------------------------------------- integration (real fleet)

def _mini_fleet(tmp_path, model, ranks, **router_kw):
    fdir = str(tmp_path / "fleet")
    kw = dict(poll_s=0.1, heartbeat_timeout_s=1.0, metrics_port=None,
              default_deadline_ms=60_000)
    kw.update(router_kw)
    router = FleetRouter(fdir, **kw)
    reps = {r: FleetReplica(fdir, r, model=model, max_batch=4,
                            default_deadline_ms=30_000, device="cpu")
            for r in ranks}
    assert router.wait_for_replicas(len(ranks), timeout_s=30.0)
    return fdir, router, reps


def _teardown(router, reps):
    faultinject.clear()
    router.close()
    for rep in reps.values():
        rep.drain(grace_s=5.0)


def test_brownout_sheds_bulk_only_with_structured_shed(tmp_path,
                                                       workload):
    """In brownout, bulk-class requests get a structured SHED (with
    retry_after_ms, on a connection that stays up) while interactive
    requests are served; leaving brownout restores bulk."""
    model, x = workload
    fdir, router, reps = _mini_fleet(tmp_path, model, (0,))
    try:
        router.set_brownout(True, reason="test")
        shed = _raw(router, op="predict", features=x, model=model,
                    priority="bulk")
        assert shed.get("error") == "SHED", shed
        assert shed.get("retry_after_ms") is not None
        ok = _raw(router, op="predict", features=x, model=model,
                  priority="interactive")
        assert ok.get("ok"), ok
        # the shed is an envelope, not a hangup: one connection takes a
        # shed then serves the next request
        cli = KerasClient(router.host, router.port)
        try:
            with pytest.raises(RuntimeError, match="SHED"):
                cli.request(op="predict", features=x, model=model,
                            priority="bulk")
            assert cli.request(op="predict", features=x, model=model,
                               priority="interactive").get("ok")
        finally:
            cli.close()
        rz = router._readyz()
        assert rz["brownout"] is True
        assert any("brownout" in r for r in rz["reasons"])
        assert _counter("fleet_brownout_sheds_total") >= 2
        assert get_registry().get("fleet_brownout").value == 1
        router.set_brownout(False)
        assert _raw(router, op="predict", features=x, model=model,
                    priority="bulk").get("ok")
        assert get_registry().get("fleet_brownout").value == 0
    finally:
        _teardown(router, reps)


def test_zero_drop_scale_down_via_drain_seam(tmp_path, workload):
    """The controller's scale-down retires an owned member through the
    replica drain seam under live load: zero client-visible failures,
    membership shrinks to the floor."""
    model, x = workload
    fdir, router, reps = _mini_fleet(tmp_path, model, (0,))
    rep1 = FleetReplica(fdir, 1, model=model, max_batch=4,
                        default_deadline_ms=30_000, device="cpu")
    auto = None
    try:
        assert router.wait_for_replicas(2, timeout_s=30.0)
        auto = FleetAutoscaler(
            router, spawn_fn=lambda rank: None, min_replicas=1,
            max_replicas=3, queue_high=4, down_ticks=3,
            down_cooldown_s=0.0, drain_grace_s=10.0, brownout=False,
            start=False)
        with auto._lock:      # adopt rank 1 as controller-owned
            auto._owned[1] = rep1
            auto._was_member.add(1)
        stop = threading.Event()
        failures = []

        def load():
            while not stop.is_set():
                try:
                    cli = KerasClient(router.host, router.port)
                    try:
                        if not cli.request(op="predict", features=x,
                                           model=model).get("ok"):
                            raise RuntimeError("not ok")
                    finally:
                        cli.close()
                except Exception as e:  # noqa: BLE001 — the assertion
                    failures.append(str(e))
                    return
                time.sleep(0.02)

        t = threading.Thread(target=load, daemon=True)
        t.start()
        time.sleep(0.2)
        deadline = time.monotonic() + 30.0
        while 1 in router.replicas() and time.monotonic() < deadline:
            auto.tick()
            time.sleep(0.05)
        time.sleep(0.3)       # post-leave load lands on the survivor
        stop.set()
        t.join(30.0)
        assert not failures, failures
        assert router.replicas() == [0]
        assert _counter("fleet_autoscale_down_total") == 1
        assert auto.handles() == {}
    finally:
        if auto is not None:
            auto.drain()
        _teardown(router, {0: reps[0]})


# ------------------------------------------- parity with the JAX package

def _decisions(autoscaler_cls, registry_mod):
    """One scripted run of a controller over the stub router: breach,
    blip, cooldown, the cap, brownout at the cap, calm, idle drains to
    the floor. Returns every tick's decision and the brownout calls."""
    prev = registry_mod.set_registry(registry_mod.MetricsRegistry())
    try:
        clock = [100.0]
        stub = _StubRouter()
        stub.add(0)

        def spawn(rank):
            stub.add(rank)
            handle = SimpleNamespace(rank=rank)
            handle.drain = lambda grace_s: (stub.stats.pop(rank, None),
                                            True)[1]
            return handle

        auto = autoscaler_cls(
            stub, spawn, min_replicas=1, max_replicas=3, queue_high=4,
            up_ticks=2, down_ticks=3, up_cooldown_s=2.0,
            down_cooldown_s=2.0, brownout=True, brownout_enter_ticks=4,
            brownout_exit_ticks=2, start=False, now_fn=lambda: clock[0])
        out = []
        for queued in [8, 0, 8, 8, 8, 8, 8, 8, 8, 8] + [0] * 12:
            stub.queued = queued
            out.append(auto.tick())
            clock[0] += 1.0
        auto.drain()
        return out, stub.brownout_calls
    finally:
        registry_mod.set_registry(prev)


def test_autoscaler_decisions_match_the_jax_package():
    from deeplearning4j_tpu.keras.autoscale import (
        FleetAutoscaler as JFleetAutoscaler)
    from deeplearning4j_tpu.profiling import metrics as jmetrics
    from deeplearning4j_tpu_torch.profiling import metrics

    port, port_brownouts = _decisions(FleetAutoscaler, metrics)
    ref, ref_brownouts = _decisions(JFleetAutoscaler, jmetrics)
    assert port == ref
    assert port_brownouts == ref_brownouts
    actions = [d["action"] for d in port]
    assert actions.count("up") == 2 and actions.count("down") == 2
    assert [a for a, _ in port_brownouts] == [True, False]


def test_flap_tracker_delays_match_the_jax_package():
    from deeplearning4j_tpu.keras.autoscale import (
        FlapTracker as JFlapTracker)

    def run(cls):
        clock = [0.0]
        t = cls(window_s=10.0, strikes_to_quarantine=2, base_s=1.0,
                max_s=8.0, rng=random.Random(7), now_fn=lambda: clock[0])
        out = []
        for reason in ("dead_connection", "stale_heartbeat",
                       "heartbeat_gone", "dead_connection",
                       "dead_connection", "stale_heartbeat"):
            t.on_admit(4)
            clock[0] += 0.5
            out.append((t.on_remove(4, reason), t.strikes(4),
                        t.blocked(4)))
            clock[0] += 9.0
        return out

    assert run(FlapTracker) == run(JFlapTracker)
