"""The port's streaming routes and training UI against the JAX package's,
on the CPU.

The port's counterparts of the JAX package's streaming cases
(``tests/test_streaming_gateway.py``), of ``tests/test_ui.py``, of the UI
cases of ``tests/test_ui_components_tokenizers.py``, of
``tests/test_profiling.py::test_ui_server_serves_metrics_endpoints``, of
the stream-frame, broker and UI-probe cases of
``tests/test_serving_resilience.py`` and of the consumer-reconnect cases
of ``tests/test_resilience.py``, with the port's nets on the CPU.

Then the cross-framework checks: the wire both ways between a JAX and a
port endpoint (the same frame bytes, a JAX broker serving port clients
and the reverse); ``StatsReport`` bytes equal; a ``FileStatsStorage``
written by one package read by the other; the components' JSON and page
equal. The teardown tests: ``NDArrayServer``, ``ServeRoute``,
``UIServer`` drain and stop and ``RemoteStatsStorageRouter`` close each
leave no thread behind. And the port's four wire fault hooks
(``corrupt_wire``, ``slow_loris_s``, ``on_pub_send``,
``on_stream_recv``).

The UI cases that need no fresh server share one ``UIServer`` and one
``NDArrayServer`` per module.
"""

import json
import os
import socket
import struct
import threading
import time
import urllib.request
import zlib
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.streaming import ndarray_channel as jchan
from deeplearning4j_tpu.ui import listeners as jlisteners

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iris import (
    IrisDataSetIterator, load_iris,
)
from deeplearning4j_tpu_torch.keras.server import KerasClient, KerasServer
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.profiling.watchdog import BUNDLE_FORMAT
from deeplearning4j_tpu_torch.resilience import faultinject, service
from deeplearning4j_tpu_torch.resilience.faultinject import (
    Fault, FaultSchedule,
)
from deeplearning4j_tpu_torch.streaming import (
    NDArrayConsumer, NDArrayPublisher, NDArrayServer, ServeRoute,
    StreamingPipeline,
)
from deeplearning4j_tpu_torch.streaming.ndarray_channel import (
    ProtocolError, _recv_array, _send_array, _Topic,
)
from deeplearning4j_tpu_torch.ui import (
    ChartLine, Component, ComponentTable,
    ComponentText, ConvolutionalIterationListener, FileStatsStorage,
    FlowIterationListener, InMemoryStatsStorage, RemoteStatsStorageRouter,
    StatsInitializationReport, StatsListener, StatsReport, UIServer,
    render_html, tile_activations,
)
from deeplearning4j_tpu_torch.ui import codec as codec_mod
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer


@pytest.fixture(autouse=True)
def _fresh_registry_and_schedule():
    """Isolate every test's counters, disarm leftover fault schedules,
    and drop the guard registrations a test leaked (a draining guard left
    behind would flip every later /readyz); the module's shared servers
    keep theirs."""
    prev = set_registry(MetricsRegistry())
    with service._guards_lock:
        kept = dict(service._guards)
    yield
    faultinject.clear()
    with service._guards_lock:
        service._guards.clear()
        service._guards.update(kept)
    set_registry(prev)


def _counter(name: str) -> float:
    m = get_registry().get(name)
    return 0.0 if m is None else m.value


def _wait_until(cond, timeout=5.0, msg="condition"):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.02)


def _threads():
    return {t for t in threading.enumerate() if t.is_alive()}


def _settled(baseline, timeout=5.0):
    _wait_until(lambda: not (_threads() - baseline), timeout,
                msg=f"threads back to baseline: {_threads() - baseline}")


@pytest.fixture(scope="module")
def ui():
    srv = UIServer(port=0).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def broker():
    srv = NDArrayServer()
    yield srv
    srv.stop()


def _get(url):
    return json.loads(urlopen(url, timeout=5).read())


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

def _tiny_net():
    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater("adam", learning_rate=0.05)
            .list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(5))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _tiny_data(n=32):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return DataSet(x, y)


def _iris_conf(updater="adam", lr=0.05, seed=7, hidden=16):
    b = (NeuralNetConfiguration.builder().updater(updater).learning_rate(lr)
         .seed(seed).list())
    if hidden:
        b = b.layer(DenseLayer(n_out=hidden, activation="relu"))
    return (b.layer(OutputLayer(n_out=3, activation="softmax",
                                loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())


@pytest.fixture(scope="module")
def iris_net():
    net = MultiLayerNetwork(_iris_conf(), device="cpu").init()
    net.fit(IrisDataSetIterator(50), epochs=20)
    return net


def _sample_report(pkg=None):
    cls = StatsReport if pkg is None else pkg.StatsReport
    return cls(
        iteration=42, timestamp_ms=1234567, score=0.5,
        samples_per_sec=100.0, batches_per_sec=3.125,
        series={"param_norm:0.W": np.array([1.5], np.float32),
                "hist_param:0.W#counts": np.arange(10, dtype=np.float32)})


# ---------------------------------------------------------------------------
# streaming routes (tests/test_streaming_gateway.py)
# ---------------------------------------------------------------------------

def test_ndarray_pubsub_roundtrip(broker):
    pub = NDArrayPublisher(broker.host, broker.port, "t1")
    sub = NDArrayConsumer(broker.host, broker.port, "t1")
    arrs = [np.arange(6, dtype=np.float32).reshape(2, 3),
            np.ones((3, 1), np.float64)]
    for a in arrs:
        pub.publish(a)
    got = sub.get_arrays(2)
    for a, b in zip(arrs, got):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    pub.close()
    sub.close()


def test_serve_route(broker, iris_net):
    route = ServeRoute(iris_net, broker.host, broker.port).start()
    pub = NDArrayPublisher(broker.host, broker.port, "features")
    sub = NDArrayConsumer(broker.host, broker.port, "predictions")
    x = load_iris().features[:8]
    pub.publish(x)
    preds = sub.get_array()
    assert preds.shape == (8, 3) and isinstance(preds, np.ndarray)
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(preds, iris_net.output(x).numpy())
    route.stop()
    pub.close()
    sub.close()


def test_serve_route_refuses_nonfinite_outputs(broker, iris_net):
    """A NaN prediction is never published: it is counted as
    ``serving_nonfinite_outputs_total`` and the next batch flows."""
    route = ServeRoute(iris_net, broker.host, broker.port, in_topic="nf.in",
                       out_topic="nf.out").start()
    pub = NDArrayPublisher(broker.host, broker.port, "nf.in")
    sub = NDArrayConsumer(broker.host, broker.port, "nf.out", timeout=10.0)
    x = load_iris().features[:4].copy()
    bad = x.copy()
    bad[0, 0] = np.nan
    pub.publish(bad)
    pub.publish(x)
    np.testing.assert_array_equal(sub.get_array(), iris_net.output(x).numpy())
    assert _counter("serving_nonfinite_outputs_total") == 1
    route.stop()
    pub.close()
    sub.close()


def test_streaming_pipeline_trains(broker):
    net = MultiLayerNetwork(_iris_conf("sgd", 0.1, 3, hidden=0),
                            device="cpu").init()
    twin = MultiLayerNetwork(_iris_conf("sgd", 0.1, 3, hidden=0),
                             device="cpu").init()
    px = NDArrayPublisher(broker.host, broker.port, "train.features")
    py = NDArrayPublisher(broker.host, broker.port, "train.labels")
    ds = load_iris()
    for _ in range(6):
        px.publish(ds.features[:64])
        py.publish(ds.labels[:64])
    pipe = StreamingPipeline(net, broker.host, broker.port)
    scores = pipe.run(6)
    assert scores[-1] < scores[0]
    # bit for bit the plain fit_batch of the same batches
    plain = [float(twin.fit_batch(DataSet(ds.features[:64],
                                          ds.labels[:64])))
             for _ in range(6)]
    assert scores == plain
    pipe.close()
    px.close()
    py.close()


def test_streaming_crosses_processes(broker):
    """The broker protocol works across OS processes: a child python
    process publishes onto one topic and echoes a doubled array back on
    another; this process consumes it."""
    import subprocess
    import sys
    import textwrap

    child_src = textwrap.dedent(f"""
        import numpy as np
        from deeplearning4j_tpu_torch.streaming.ndarray_channel import (
            NDArrayConsumer, NDArrayPublisher)
        pub = NDArrayPublisher("127.0.0.1", {broker.port}, "child_out")
        con = NDArrayConsumer("127.0.0.1", {broker.port}, "child_in",
                              timeout=30.0)
        pub.publish(np.arange(6, dtype=np.float32).reshape(2, 3))
        x = con.get_array()
        pub.publish(x * 2.0)
        pub.close(); con.close()
    """)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", child_src], env=env,
                            stderr=subprocess.PIPE)
    try:
        con = NDArrayConsumer("127.0.0.1", broker.port, "child_out",
                              timeout=30.0)
        np.testing.assert_array_equal(
            con.get_array(), np.arange(6, dtype=np.float32).reshape(2, 3))
        pub = NDArrayPublisher("127.0.0.1", broker.port, "child_in")
        sent = np.asarray([[1.5, -2.0], [0.25, 4.0]], np.float32)
        pub.publish(sent)
        np.testing.assert_array_equal(con.get_array(), sent * 2.0)
        rc = proc.wait(timeout=60)
        assert rc == 0, proc.stderr.read().decode()[-2000:]
        pub.close()
        con.close()
    finally:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# the wire (tests/test_serving_resilience.py, tests/test_resilience.py)
# ---------------------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _npy_bytes(arr):
    import io as _io
    buf = _io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def test_v1_frame_still_accepted():
    tx, rx = _pair()
    data = _npy_bytes(np.arange(12, dtype=np.float32).reshape(3, 4))
    tx.sendall(struct.pack(">Q", len(data)) + data)  # v1: no flag, no CRC
    np.testing.assert_array_equal(
        _recv_array(rx), np.arange(12, dtype=np.float32).reshape(3, 4))
    tx.close()
    rx.close()


def test_v2_roundtrip_has_crc_and_flag():
    tx, rx = _pair()
    arr = np.ones((2, 2), np.float64)
    _send_array(tx, arr)
    np.testing.assert_array_equal(_recv_array(rx), arr)
    _send_array(tx, arr)
    raw = b""
    while len(raw) < 8:
        raw += rx.recv(8 - len(raw))
    (word,) = struct.unpack(">Q", raw)
    assert word >> 63 == 1
    length = word & ((1 << 63) - 1)
    payload = b""
    while len(payload) < length + 4:
        payload += rx.recv(length + 4 - len(payload))
    (crc,) = struct.unpack(">I", payload[-4:])
    assert crc == zlib.crc32(payload[:-4]) & 0xFFFFFFFF
    tx.close()
    rx.close()


def test_corrupt_length_header_rejected_not_allocated():
    tx, rx = _pair()
    tx.sendall(struct.pack(">Q", 1 << 40))  # v1 framing, absurd length
    with pytest.raises(ProtocolError, match="corrupt or malicious"):
        _recv_array(rx)
    assert _counter("streaming_frame_errors_total") == 1
    tx.close()
    rx.close()


def test_corrupt_frame_trio_never_yields_garbage():
    """``faultinject.corrupt_wire``: each corruption is a clean protocol
    error, never a garbage array."""
    arr = np.linspace(0, 1, 32, dtype=np.float32)
    for mode, match in (("length", "corrupt or malicious"),
                        ("crc", "CRC-32 mismatch"), ("truncate", "truncated")):
        faultinject.set_schedule(FaultSchedule(
            [Fault("corrupt_frame", at_call=1, mode=mode)]))
        tx, rx = _pair()
        _send_array(tx, arr)
        if mode == "truncate":
            tx.close()
        with pytest.raises(ProtocolError, match=match):
            _recv_array(rx)
        tx.close()
        rx.close()
    assert _counter("streaming_frame_errors_total") == 3
    assert _counter("resilience_faults_injected_total") == 3


def test_oversized_send_refused_at_source():
    tx, rx = _pair()
    with pytest.raises(ProtocolError, match="refusing to send"):
        _send_array(tx, np.zeros(64, np.float32), frame_cap=128)
    tx.close()
    rx.close()


def test_stalled_frame_times_out_as_protocol_error():
    tx, rx = _pair()
    data = _npy_bytes(np.zeros(8, np.float32))
    tx.sendall(struct.pack(">Q", len(data)) + data[:4])  # ...and stall
    with pytest.raises(ProtocolError, match="stalled"):
        _recv_array(rx, io_timeout=0.2)
    tx.close()
    rx.close()


def test_dribbled_frame_bounded_by_per_frame_budget():
    tx, rx = _pair()
    data = _npy_bytes(np.zeros(64, np.float32))
    frame = struct.pack(">Q", len(data)) + data
    stop = threading.Event()

    def dribble():
        for i in range(len(frame)):
            if stop.is_set():
                return
            try:
                tx.sendall(frame[i:i + 1])
            except OSError:
                return
            time.sleep(0.05)

    t = threading.Thread(target=dribble, daemon=True)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(ProtocolError, match="stalled"):
        _recv_array(rx, io_timeout=0.3)
    assert time.monotonic() - t0 < 2.0
    stop.set()
    tx.close()
    rx.close()
    t.join(5.0)


def test_slow_loris_fault_dribbles_the_header():
    """``faultinject.slow_loris_s``: the scheduled send dribbles its
    header over ``duration`` seconds; a receiver with a shorter per-frame
    budget cuts it off, a patient one gets the array whole."""
    arr = np.arange(5, dtype=np.float32)
    for budget, ok in ((0.1, False), (5.0, True)):
        faultinject.set_schedule(FaultSchedule(
            [Fault("slow_loris", at_call=1, duration=0.4)]))
        tx, rx = _pair()
        t = threading.Thread(target=_send_array, args=(tx, arr), daemon=True)
        t0 = time.monotonic()
        t.start()
        if ok:
            np.testing.assert_array_equal(_recv_array(rx, io_timeout=budget),
                                          arr)
            assert time.monotonic() - t0 >= 0.3
        else:
            with pytest.raises(ProtocolError, match="stalled"):
                _recv_array(rx, io_timeout=budget)
        t.join(5.0)
        tx.close()
        rx.close()
    assert _counter("resilience_faults_injected_total") == 2


def test_topic_drop_oldest_bounds_queue():
    srv = NDArrayServer(max_depth=3)
    try:
        pub = NDArrayPublisher(srv.host, srv.port, "t")
        for k in range(5):
            pub.publish(np.full((2,), k, np.float32))
        _wait_until(lambda: _counter("streaming_dropped_total") >= 2,
                    msg="2 drops counted")
        sub = NDArrayConsumer(srv.host, srv.port, "t", timeout=5.0)
        assert [int(sub.get_array()[0]) for _ in range(3)] == [2, 3, 4]
        pub.close()
        sub.close()
    finally:
        srv.stop()


def test_topic_block_policy_honors_deadline():
    topic = _Topic(max_depth=1, policy="block")
    assert topic.put(np.zeros(1))
    t0 = time.monotonic()
    assert not topic.put(np.ones(1), deadline_s=0.15)
    assert 0.1 <= time.monotonic() - t0 < 2.0
    assert _counter("streaming_dropped_total") == 1


def test_publisher_reconnects_after_drop(broker):
    """``faultinject.on_pub_send``: the publisher's socket is closed under
    it and the frame goes out whole on a new connection."""
    pub = NDArrayPublisher(broker.host, broker.port, "pubdrop",
                           backoff_base=0.01, backoff_max=0.05)
    sub = NDArrayConsumer(broker.host, broker.port, "pubdrop", timeout=10.0)
    pub.publish(np.full((2,), 1, np.float32))
    np.testing.assert_array_equal(sub.get_array(),
                                  np.full((2,), 1, np.float32))
    faultinject.set_schedule(FaultSchedule(
        [Fault("drop_connection", at_call=1, mode="pub")]))
    pub.publish(np.full((2,), 2, np.float32))  # reconnects inside
    np.testing.assert_array_equal(sub.get_array(),
                                  np.full((2,), 2, np.float32))
    assert _counter("streaming_pub_reconnects_total") >= 1
    pub.close()
    sub.close()


def test_consumer_reconnects_after_drop(broker):
    """``faultinject.on_stream_recv``: the consumer's socket is dropped at
    its next recv, it re-subscribes and the stream keeps flowing."""
    pub = NDArrayPublisher(broker.host, broker.port, "recvdrop")
    consumer = NDArrayConsumer(broker.host, broker.port, "recvdrop",
                               timeout=10.0, max_retries=3,
                               backoff_base=0.01, backoff_max=0.05)
    arrays = [np.full((3, 2), k, np.float32) for k in range(3)]
    pub.publish(arrays[0])
    np.testing.assert_array_equal(consumer.get_array(), arrays[0])
    faultinject.set_schedule(FaultSchedule(
        [Fault("drop_connection", at_call=1)]))
    timer = threading.Timer(0.5, lambda: pub.publish(arrays[1]))
    timer.start()
    try:
        np.testing.assert_array_equal(consumer.get_array(), arrays[1])
    finally:
        timer.join()
    assert _counter("streaming_reconnects_total") >= 1
    pub.publish(arrays[2])
    np.testing.assert_array_equal(consumer.get_array(), arrays[2])
    consumer.close()
    pub.close()


def test_consumer_bounded_retries_exhaust():
    server = NDArrayServer()
    consumer = NDArrayConsumer(server.host, server.port, "t", timeout=0.2,
                               max_retries=2, backoff_base=0.01,
                               backoff_max=0.02)
    server.stop()  # broker gone for good
    with pytest.raises(ConnectionError, match="reconnect"):
        consumer.get_array()
    consumer.close()


def test_broker_slow_loris_header_reclaimed():
    srv = NDArrayServer(header_timeout=0.2)
    try:
        s = socket.create_connection((srv.host, srv.port))
        s.settimeout(5.0)
        s.sendall(b"PU")  # ...and never finish the header
        assert s.recv(1) == b""
        s.close()
        assert _counter("serving_idle_timeouts_total") >= 1
        assert _counter("streaming_frame_errors_total") >= 1
    finally:
        srv.stop()


def test_broker_connection_admission_sheds():
    srv = NDArrayServer(max_connections=1)
    try:
        keep = socket.create_connection((srv.host, srv.port))
        keep.settimeout(5.0)
        keep.sendall(b"SUB t\n")
        time.sleep(0.1)  # let the handler claim the only slot
        extra = socket.create_connection((srv.host, srv.port))
        extra.settimeout(5.0)
        extra.sendall(b"SUB t\n")
        assert extra.recv(1) == b""  # shed: closed without service
        assert _counter("serving_shed_total") >= 1
        keep.close()
        extra.close()
    finally:
        srv.stop()


def test_broker_drain_flushes_then_stops():
    srv = NDArrayServer()
    pub = NDArrayPublisher(srv.host, srv.port, "t")
    pub.publish(np.full((2,), 7, np.float32))
    _wait_until(lambda: sum(len(t) for t in srv._topics.values()) == 1,
                msg="array queued on the broker")
    sub = NDArrayConsumer(srv.host, srv.port, "t", timeout=10.0)
    time.sleep(0.2)  # subscriber handler admitted before drain begins
    done = {}
    t = threading.Thread(target=lambda: done.update(ok=srv.drain(5.0)),
                         daemon=True)
    t.start()
    np.testing.assert_array_equal(sub.get_array(),
                                  np.full((2,), 7, np.float32))
    t.join(10.0)
    assert done.get("ok") is True
    pub.close()
    sub.close()


def test_broker_drain_zero_grace_on_empty_broker_is_clean():
    srv = NDArrayServer()
    assert srv.drain(grace_s=0.0) is True
    assert _counter("serving_drain_timeouts_total") == 0


def test_broker_dead_reader_subscriber_releases_slot():
    srv = NDArrayServer(max_connections=2, io_timeout=0.3)
    try:
        bad = socket.create_connection((srv.host, srv.port))
        bad.sendall(b"SUB t\n")  # ...and never read a byte
        pub = NDArrayPublisher(srv.host, srv.port, "t")
        big = np.arange(2 << 20, dtype=np.float64)  # 16 MiB > buffers
        pub.publish(big)
        pub.close()
        _wait_until(lambda: srv._guard.inflight <= 0, timeout=10.0,
                    msg="dead-reader handler reclaimed")
        sub = NDArrayConsumer(srv.host, srv.port, "t", timeout=10.0,
                              io_timeout=10.0)
        np.testing.assert_array_equal(sub.get_array(), big)
        sub.close()
        bad.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the wire across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.linspace(-1, 1, 7, dtype=np.float64),
    np.array([[1, 2], [3, 4]], np.int64)], ids=["f32", "f64", "i64"])
def test_wire_frames_equal_the_jax_packages(arr):
    """Both packages put the same bytes on the wire for one array, and
    each reads the other's frame."""
    frames = []
    for send in (_send_array, jchan._send_array):
        tx, rx = _pair()
        send(tx, arr)
        tx.close()
        buf = b""
        while True:
            c = rx.recv(1 << 16)
            if not c:
                break
            buf += c
        rx.close()
        frames.append(buf)
    assert frames[0] == frames[1]
    for send, recv in ((_send_array, jchan._recv_array),
                       (jchan._send_array, _recv_array)):
        tx, rx = _pair()
        send(tx, arr)
        got = recv(rx)
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == arr.dtype
        tx.close()
        rx.close()


@pytest.mark.parametrize("side", ["jax_broker", "port_broker"])
def test_jax_and_port_endpoints_exchange_arrays(side):
    """A JAX publisher feeds a port consumer and the reverse, through a
    broker of either package."""
    srv = (jchan.NDArrayServer() if side == "jax_broker"
           else NDArrayServer())
    try:
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        jpub = jchan.NDArrayPublisher(srv.host, srv.port, "j2p")
        psub = NDArrayConsumer(srv.host, srv.port, "j2p", timeout=10.0)
        jpub.publish(a)
        np.testing.assert_array_equal(psub.get_array(), a)
        ppub = NDArrayPublisher(srv.host, srv.port, "p2j")
        jsub = jchan.NDArrayConsumer(srv.host, srv.port, "p2j",
                                     timeout=10.0)
        ppub.publish(a * 3)
        np.testing.assert_array_equal(jsub.get_array(), a * 3)
        for e in (jpub, psub, ppub, jsub):
            e.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# stats, codec and storage (tests/test_ui.py)
# ---------------------------------------------------------------------------

def test_codec_roundtrip():
    out = StatsReport.decode(_sample_report().encode())
    assert out.iteration == 42 and out.timestamp_ms == 1234567
    assert out.score == pytest.approx(0.5)
    assert out.samples_per_sec == pytest.approx(100.0)
    np.testing.assert_allclose(out.series["param_norm:0.W"], [1.5])
    np.testing.assert_allclose(out.series["hist_param:0.W#counts"],
                               np.arange(10))


def test_codec_python_fallback_matches_native(monkeypatch):
    """The native codec is built here (``native_loader`` maps
    ``statscodec`` to ``native/stats_codec.cc``) and the Python path
    writes the same bytes."""
    assert codec_mod.native_available()
    rep = _sample_report()
    native_bytes = rep.encode()
    monkeypatch.setattr(codec_mod, "_native", lambda: None)
    py_bytes = rep.encode()
    assert native_bytes == py_bytes
    out = StatsReport.decode(py_bytes)
    assert out.iteration == 42
    np.testing.assert_allclose(out.series["param_norm:0.W"], [1.5])


def test_stats_report_bytes_equal_the_jax_packages():
    rep, jrep = _sample_report(), _sample_report(jui)
    assert rep.encode() == jrep.encode()
    back = jui.StatsReport.decode(rep.encode())
    assert back.series.keys() == rep.series.keys()
    with pytest.raises(ValueError, match="bad stats record"):
        StatsReport.decode(b"\0" * 60)


def test_stats_listener_collects():
    storage = InMemoryStatsStorage()
    net = _tiny_net()
    listener = StatsListener(storage, session_id="s1", histogram_frequency=2)
    net.set_listeners(listener)
    ds = _tiny_data()
    for _ in range(4):
        net.fit_batch(ds)
    assert storage.list_sessions() == ["s1"]
    reports = storage.get_reports("s1")
    assert len(reports) == 4
    keys = set(reports[-1].series.keys())
    for k in ("param_norm:0.W", "update_norm:0.W", "ratio:0.W",
              "grad_norm:0.W"):
        assert k in keys
    assert any(k.startswith("hist_param:") for k in keys)
    init = storage.get_init_report("s1")
    assert init is not None and init.model["n_layers"] == "2"
    assert init.hardware["backend"] == "cpu"
    for r in reports:
        assert StatsReport.decode(r.encode()).iteration == r.iteration
    # the norms are the params' and the last step's gradients'
    w = net.params[0]["W"]
    np.testing.assert_allclose(reports[-1].series["param_norm:0.W"][0],
                               float(torch.linalg.vector_norm(w)), rtol=1e-5)
    np.testing.assert_allclose(
        reports[-1].series["grad_norm:0.W"][0],
        float(torch.linalg.vector_norm(net.last_grads[0]["W"])), rtol=1e-5)


def test_stats_listener_matches_the_jax_listener():
    """The same weights and batches through both packages' listeners give
    the same series names and norms (1e-5)."""
    from deeplearning4j_tpu import (InputType as JIT, MultiLayerNetwork as
                                    JNet, NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.layers import (DenseLayer as JDense,
                                              OutputLayer as JOut)
    from deeplearning4j_tpu_torch.convert import params_from_jax
    import jax
    jconf = (JNNC.builder().seed(7).updater("adam", learning_rate=0.05)
             .list().layer(JDense(n_out=8, activation="tanh"))
             .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(JIT.feed_forward(5)).build())
    jnet = JNet(jconf).init()
    net = MultiLayerNetwork(_tiny_net().conf, device="cpu").init(
        params=params_from_jax(_tiny_net().conf,
                               jax.tree.map(np.asarray, jnet.params)))
    js, ps = jui.InMemoryStatsStorage(), InMemoryStatsStorage()
    jnet.set_listeners(jui.StatsListener(js, session_id="x",
                                         histogram_frequency=2))
    net.set_listeners(StatsListener(ps, session_id="x",
                                    histogram_frequency=2))
    ds = _tiny_data()
    for _ in range(2):
        jnet.fit_batch(JDataSet(ds.features, ds.labels))
        net.fit_batch(ds)
    for jr, pr in zip(js.get_reports("x"), ps.get_reports("x")):
        assert jr.series.keys() == pr.series.keys()
        for k in jr.series:
            if k.startswith(("param_norm:", "grad_norm:")):
                np.testing.assert_allclose(pr.series[k], jr.series[k],
                                           rtol=1e-5)


def test_file_storage_replay(tmp_path):
    path = str(tmp_path / "stats.bin")
    storage = FileStatsStorage(path)
    net = _tiny_net()
    net.set_listeners(StatsListener(storage, session_id="file-sess"))
    ds = _tiny_data()
    for _ in range(3):
        net.fit_batch(ds)
    storage.close()
    reopened = FileStatsStorage(path)
    assert reopened.list_sessions() == ["file-sess"]
    reports = reopened.get_reports("file-sess")
    assert len(reports) == 3 and reports[0].iteration == 1
    assert reopened.get_init_report("file-sess") is not None
    reopened.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_storage_crosses_the_packages(tmp_path, writer):
    """A stats file written by one package replays in the other, report
    for report."""
    path = str(tmp_path / "stats.bin")
    w_pkg, r_pkg = (jui, None) if writer == "jax" else (None, jui)
    W = FileStatsStorage if w_pkg is None else w_pkg.FileStatsStorage
    R = FileStatsStorage if r_pkg is None else r_pkg.FileStatsStorage
    w = W(path)
    init_cls = (jui.StatsInitializationReport if writer == "jax"
                else StatsInitializationReport)
    w.put_init_report(init_cls(session_id="s", timestamp_ms=5,
                               software={"python": "3"}, model={"a": "b"}))
    wanted = []
    for i in range(3):
        rep = _sample_report(w_pkg)
        rep.iteration = i
        w.put_report("s", rep)
        wanted.append(rep.encode())
    w.close()
    r = R(path)
    assert r.list_sessions() == ["s"]
    got = r.get_reports("s")
    assert [g.iteration for g in got] == [0, 1, 2]
    assert [g.encode() for g in got] == wanted
    assert r.get_init_report("s").model == {"a": "b"}
    r.close()


def test_file_storage_truncated_tail(tmp_path):
    path = str(tmp_path / "stats.bin")
    storage = FileStatsStorage(path)
    storage.put_report("s", _sample_report())
    storage.put_report("s", _sample_report())
    storage.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)  # tear the second record
    re = FileStatsStorage(path)
    assert len(re.get_reports("s")) == 1
    re.put_report("s", _sample_report())
    re.close()
    re2 = FileStatsStorage(path)
    assert len(re2.get_reports("s")) == 2
    re2.close()


def test_stats_listener_frequency_interval_norms():
    storage = InMemoryStatsStorage()
    net = _tiny_net()
    net.set_listeners(StatsListener(storage, session_id="f3", frequency=3))
    ds = _tiny_data()
    for _ in range(9):
        net.fit_batch(ds)
    reports = storage.get_reports("f3")
    assert [r.iteration for r in reports] == [3, 6, 9]
    assert "update_norm:0.W" in reports[1].series


def test_stats_listener_copies_nothing_on_a_skipped_iteration(monkeypatch):
    """A skipped iteration makes no device-to-host copy: the flattening
    that copies runs on reporting iterations only."""
    from deeplearning4j_tpu_torch.ui import stats as stats_mod
    calls = []
    real = stats_mod._flat_params
    monkeypatch.setattr(stats_mod, "_flat_params",
                        lambda p: calls.append(1) or real(p))
    net = _tiny_net()
    net.set_listeners(StatsListener(InMemoryStatsStorage(), frequency=3))
    for _ in range(6):
        net.fit_batch(_tiny_data())
    assert len(calls) == 2 * 2   # params and gradients, at 3 and 6


def test_remote_router_survives_dead_server():
    router = RemoteStatsStorageRouter("http://127.0.0.1:1", max_failures=2,
                                      timeout=0.5)
    net = _tiny_net()
    net.set_listeners(StatsListener(router, session_id="dead"))
    ds = _tiny_data()
    for _ in range(4):
        net.fit_batch(ds)
    _wait_until(lambda: router._consecutive_failures >= 2, timeout=10.0,
                msg="two failed posts")
    router.close()


# ---------------------------------------------------------------------------
# the UI server
# ---------------------------------------------------------------------------

def test_ui_server_and_remote_router(ui):
    router = RemoteStatsStorageRouter(ui.url)
    net = _tiny_net()
    net.set_listeners(StatsListener(router, session_id="remote-sess"))
    ds = _tiny_data()
    for _ in range(2):
        net.fit_batch(ds)
    router.flush()
    assert "remote-sess" in _get(ui.url + "/api/sessions")
    data = _get(ui.url + "/api/session?id=remote-sess")
    assert len(data["reports"]) == 2
    assert data["reports"][-1]["score"] > 0
    assert any(k.startswith("param_norm:")
               for k in data["reports"][-1]["scalars"])
    assert data["init"]["model"]["n_layers"] == "2"
    assert b"training dashboard" in urlopen(ui.url + "/", timeout=5).read()
    router.close()


def test_histogram_endpoint_and_tsne_view(ui):
    net = _tiny_net()
    net.set_listeners(StatsListener(ui.storage, session_id="h1",
                                    histogram_frequency=1))
    ds = _tiny_data()
    for _ in range(2):
        net.fit_batch(ds)
    h = _get(ui.url + "/api/histograms?id=h1")
    assert h["iteration"] == 2
    assert len(h["param"]["0.W"]["counts"]) == 20
    assert len(h["param"]["0.W"]["edges"]) == 21
    assert "0.W" in h["grad"]
    ui.post_tsne(np.array([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]),
                 labels=["a", "b", "a"])
    t = _get(ui.url + "/api/tsne")
    assert t["x"] == [0.0, 2.0, 4.0] and t["labels"] == ["a", "b", "a"]
    page = urlopen(ui.url + "/", timeout=5).read()
    assert b"Histograms" in page and b"t-SNE" in page


def test_histogram_scrubber_iterations(ui):
    net = _tiny_net()
    net.set_listeners(StatsListener(ui.storage, session_id="sc",
                                    histogram_frequency=1))
    ds = _tiny_data()
    for _ in range(4):
        net.fit_batch(ds)
    h = _get(ui.url + "/api/histograms?id=sc")
    assert h["iterations"] == [1, 2, 3, 4] and h["iteration"] == 4
    h1 = _get(ui.url + "/api/histograms?id=sc&iter=1")
    assert h1["iteration"] == 1 and "0.W" in h1["param"]
    assert _get(ui.url + "/api/histograms?id=sc&iter=100")["iteration"] == 4
    assert b"histslider" in urlopen(ui.url + "/", timeout=5).read()


def test_flow_view_roundtrip(ui):
    net = _tiny_net()
    listener = FlowIterationListener()
    net.set_listeners(listener)
    net.fit_batch(_tiny_data())
    assert listener.snapshot is not None
    ui.post_flow(listener.snapshot)
    f = _get(ui.url + "/api/flow")
    names = [n["name"] for n in f["nodes"]]
    assert names[0] == "input" and len(names) == 1 + len(net.layers)
    assert {"from": "input", "to": "layer0"} in f["edges"]
    assert f["score"] is not None
    ui.post_flow(net, score=1.23)
    assert _get(ui.url + "/api/flow")["score"] == 1.23
    assert b"Network graph" in urlopen(ui.url + "/", timeout=5).read()


def test_activation_grid_endpoint(ui):
    grid = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    ui.post_conv_activations({0: grid, "conv1": grid * 0.5})
    a = _get(ui.url + "/api/activations")
    assert {"0", "conv1"} <= set(a)
    assert a["0"].startswith("data:image/") and "base64," in a["0"]
    req = Request(ui.url + "/api/activations",
                  data=json.dumps({"layer": "x",
                                   "grid": [[0, 1], [1, 0]]}).encode(),
                  method="POST")
    urlopen(req, timeout=5)
    assert "x" in _get(ui.url + "/api/activations")


def test_system_endpoint(ui):
    s = _get(ui.url + "/api/system")
    assert s["cpus"] >= 1 and s["rss_mb"] > 0
    assert "mem_total_mb" in s and "load_avg" in s
    assert "devices" not in s   # CUDA never initialized by the dashboard
    assert b"System" in urlopen(ui.url + "/", timeout=5).read()


def test_ui_server_serves_metrics_endpoints(ui):
    get_registry().counter("bench_smoke_total").inc(7)
    text = urlopen(f"{ui.url}/api/metrics").read().decode()
    assert "bench_smoke_total 7" in text
    assert "# TYPE bench_smoke_total counter" in text
    assert _get(f"{ui.url}/api/metrics.json")["bench_smoke_total"] == 7
    dbg = _get(f"{ui.url}/api/debug")
    assert dbg["format"] == BUNDLE_FORMAT and dbg["reason"] == "live"
    assert "heartbeats" in dbg and "threads" in dbg


def test_ui_server_auth_token():
    srv = UIServer(port=0, auth_token="sekrit").start()
    try:
        url = f"http://127.0.0.1:{srv.port}/api/sessions"
        with pytest.raises(HTTPError) as e:
            urlopen(url, timeout=5)
        assert e.value.code == 401
        assert urlopen(Request(url, headers={
            "Authorization": "Bearer sekrit"}), timeout=5).status == 200
        assert urlopen(url + "?token=sekrit", timeout=5).status == 200
        with pytest.raises(HTTPError) as e:
            urlopen(url + "?token=%C3%A9", timeout=5)
        assert e.value.code == 401
        # the cookie a query token sets carries the dashboard's fetches
        base = f"http://127.0.0.1:{srv.port}"
        cookie = urlopen(base + "/?token=sekrit",
                         timeout=5).headers.get("Set-Cookie", "")
        assert "ui_token=sekrit" in cookie
        assert "Max-Age=" in cookie and "HttpOnly" in cookie
        assert "SameSite=Strict" in cookie and "Secure" not in cookie
        assert urlopen(Request(base + "/api/sessions", headers={
            "Cookie": "ui_token=sekrit"}), timeout=5).status == 200
        # the probes bypass auth, the api does not
        assert urlopen(base + "/healthz", timeout=5).status == 200
    finally:
        srv.stop()
    srv = UIServer(port=0, auth_token="sekrit", secure_cookie=True).start()
    try:
        cookie = urlopen(f"http://127.0.0.1:{srv.port}/?token=sekrit",
                         timeout=5).headers.get("Set-Cookie", "")
        assert "Secure" in cookie
    finally:
        srv.stop()


def _http_get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, json.loads(r.read() or b"{}")
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_ui_healthz_readyz_flip_on_drain(tmp_path, ui):
    net = MultiLayerNetwork(_iris_conf(hidden=8), device="cpu").init()
    model = str(tmp_path / "iris.zip")
    ModelSerializer.write_model(net, model)
    x = str(tmp_path / "x.npy")
    np.save(x, load_iris().features[:4])
    srv = KerasServer(device="cpu")
    try:
        assert _http_get(ui.port, "/healthz") == (200, {"live": True})
        code, body = _http_get(ui.port, "/readyz")
        assert code == 503  # the gateway's guard: no model loaded
        kname = srv._guard.name
        assert "model_loaded" in body["guards"][kname]["reasons"]
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)
        code, body = _http_get(ui.port, "/readyz")
        assert code == 200 and body["ready"]
        srv._guard.start_drain()
        code, body = _http_get(ui.port, "/readyz")
        assert code == 503
        assert "draining" in body["guards"][kname]["reasons"]
        cli.close()
    finally:
        srv.stop()


def test_ui_probes_bypass_auth_but_api_does_not():
    srv = UIServer(port=0, auth_token="sekrit").start()
    try:
        assert _http_get(srv.port, "/healthz")[0] == 200
        assert _http_get(srv.port, "/readyz")[0] in (200, 503)
        assert _http_get(srv.port, "/api/sessions")[0] == 401
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# components and listeners (tests/test_ui_components_tokenizers.py)
# ---------------------------------------------------------------------------

def _components(pkg):
    return pkg.ComponentDiv().add(
        pkg.ComponentText(text="hello <b>"),
        pkg.ComponentTable(header=["a", "b"], content=[["1", "2"]],
                           title="t"),
        pkg.ChartLine(title="score").add_series("s", [0, 1, 2],
                                                [3.0, 2.0, 1.0]),
        pkg.ChartHistogram(title="h").add_bin(0, 1, 5).add_bin(1, 2, 3),
    )


def test_component_json_roundtrip():
    import deeplearning4j_tpu_torch.ui as pui
    d = _components(pui).to_dict()
    assert Component.from_dict(json.loads(json.dumps(d))).to_dict() == d


def test_components_json_and_page_equal_the_jax_packages(tmp_path):
    import deeplearning4j_tpu_torch.ui as pui
    p, j = _components(pui), _components(jui)
    assert p.to_json() == j.to_json()
    assert (render_html([p], title="R")
            == jui.render_html([j], title="R"))


def test_component_validation():
    with pytest.raises(ValueError, match="x vs"):
        ChartLine().add_series("s", [1, 2], [1.0])
    with pytest.raises(ValueError, match="Unknown component"):
        Component.from_dict({"type": "Nope"})


def test_render_html(tmp_path):
    page = render_html(
        [ComponentText(text="<script>x</script>"),
         ChartLine(title="t").add_series("a", [0, 1], [1.0, 2.0]),
         ComponentTable(header=["h"], content=[["v"]])],
        title="Report", path=str(tmp_path / "r.html"))
    assert "&lt;script&gt;" in page and "<polyline" in page
    assert (tmp_path / "r.html").exists()


def test_tile_activations():
    act = np.zeros((4, 4, 5), np.float32)
    for c in range(5):
        act[..., c] = c
    grid = tile_activations(act)
    assert grid.shape == (2 * 5 - 1, 3 * 5 - 1)
    assert grid.max() == 1.0 and grid.min() == 0.0
    np.testing.assert_array_equal(grid, jlisteners.tile_activations(act))


def _conv_conf(graph=False):
    b = (NeuralNetConfiguration.builder().updater("adam")
         .learning_rate(0.01).seed(1))
    conv = ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu")
    dense = DenseLayer(n_out=8, activation="relu")
    out = OutputLayer(n_out=3, activation="softmax", loss="mcxent")
    if graph:
        return (b.graph_builder().add_inputs("in")
                .add_layer("conv", conv, "in").add_layer("d", dense, "conv")
                .add_layer("out", out, "d").set_outputs("out")
                .set_input_types(InputType.convolutional(8, 8, 1)).build())
    return (b.list().layer(conv).layer(dense).layer(out)
            .set_input_type(InputType.convolutional(8, 8, 1)).build())


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
def test_conv_listener_and_flow_listener(graph, ui):
    """Both containers: the conv listener renders its conv layer (through
    the port's ``feed_forward`` / the graph's walk: nothing swallowed, the
    renders not empty) and the flow listener's snapshot posts."""
    conf = _conv_conf(graph)
    net = (ComputationGraph if graph else MultiLayerNetwork)(
        conf, device="cpu").init()
    conv_l = ConvolutionalIterationListener(frequency=1)
    flow_l = FlowIterationListener()
    net.set_listeners(conv_l, flow_l)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    net.fit_batch(DataSet(x, y))
    key = "conv" if graph else 0
    assert list(conv_l.renders) == [key]
    grid = conv_l.renders[key]
    assert grid.shape == (2 * 7 - 1, 2 * 7 - 1) and grid.max() == 1.0
    snap = json.loads(flow_l.to_json())
    names = [n["name"] for n in snap["nodes"]]
    if graph:
        assert names.count("in") == 1 and len(names) == 4
        assert {"from": "conv", "to": "d"} in snap["edges"]
    else:
        assert names[0] == "input" and len(names) == 4
        assert {"from": "layer0", "to": "layer1"} in snap["edges"]
    assert "score" in snap
    ui.post_flow(snap)
    assert _get(ui.url + "/api/flow")["nodes"] == snap["nodes"]
    ui.post_conv_activations(conv_l.renders)
    assert str(key) in _get(ui.url + "/api/activations")


def test_flow_listener_graph_no_duplicate_inputs():
    conf = (NeuralNetConfiguration.builder().updater("sgd")
            .learning_rate(0.1).seed(1).graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_out=4, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(3)).build())
    net = ComputationGraph(conf, device="cpu").init()
    fl = FlowIterationListener()
    fl.iteration_done(net, 0, 1.0)
    snap = json.loads(fl.to_json())
    names = [n["name"] for n in snap["nodes"]]
    assert names.count("in") == 1
    assert all(n["layerType"] != "NoneType" for n in snap["nodes"])


# ---------------------------------------------------------------------------
# thread teardown
# ---------------------------------------------------------------------------

def test_ndarray_server_and_serve_route_leave_no_thread(iris_net):
    baseline = _threads()
    srv = NDArrayServer()
    route = ServeRoute(iris_net, srv.host, srv.port).start()
    pub = NDArrayPublisher(srv.host, srv.port, "features")
    sub = NDArrayConsumer(srv.host, srv.port, "predictions")
    pub.publish(load_iris().features[:2])
    assert sub.get_array().shape == (2, 3)
    route.stop()
    for e in (pub, sub):
        e.close()
    srv.stop()
    _settled(baseline)


def test_ui_server_drain_and_stop_leave_no_thread():
    baseline = _threads()
    srv = UIServer(port=0).start()
    assert _http_get(srv.port, "/healthz")[0] == 200
    assert srv.drain(grace_s=1.0) is True
    _settled(baseline)
    srv = UIServer(port=0).start()
    srv.stop()
    _settled(baseline)


def test_remote_router_close_leaves_no_thread(ui):
    baseline = _threads()
    router = RemoteStatsStorageRouter(ui.url)
    router.put_report("teardown", _sample_report())
    router.close()
    _settled(baseline)
    assert len(ui.storage.get_reports("teardown")) == 1
