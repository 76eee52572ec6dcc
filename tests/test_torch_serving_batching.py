"""The port's continuous-batching scheduler (``deeplearning4j_tpu_torch/
keras/batching.py``) behind its ``KerasServer``, on the CPU: the
counterpart of every case of ``tests/test_serving_batching.py``.

The contract under test:

(a) bucket policy — next power-of-two rows up to ``max_batch``
    (normalized down to a power of two), oversize requests run alone;
(b) padding correctness — for RAGGED request sizes, batched predictions
    are held to the singleton predictions of the same rows by the C2
    gate (ROADMAP C2: batched vs singleton is not bitwise in the
    reference either): the same argmax, and probabilities within 1e-5;
(c) compile discipline — one runner per (model, bucket), none rebuilt
    for repeated same-bucket traffic, the cache evicted with the LRU
    model (on the CPU a runner is the eager ``output()``: nothing is
    captured, so ``_infer_traces`` stays 0 and ``compiles`` counts the
    runners built);
(d) flush taxonomy — full / deadline / idle flushes are counted by
    reason on the labeled ``serving_batch_flushes_total`` family;
(e) the admission-time model resolution — a queued predict can never be
    retargeted by an LRU swap mid-flight.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import (InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch.keras.batching import (BatchScheduler,
                                                     bucket_rows)
from deeplearning4j_tpu_torch.keras.server import KerasClient, KerasServer
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.profiling.metrics import (MetricsRegistry,
                                                        get_registry,
                                                        set_registry)
from deeplearning4j_tpu_torch.resilience import service
from deeplearning4j_tpu_torch.resilience.service import (Deadline,
                                                         DrainingError)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

#: ROADMAP C2: a batched row against its singleton — argmax equal and
#: max |dprob| within this (probabilities are <= 1, so also relative)
C2_ATOL = 1e-5


def Server(**kw):
    return KerasServer(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = set_registry(MetricsRegistry())
    yield
    with service._guards_lock:
        service._guards.clear()
    set_registry(prev)


@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    conf = (NeuralNetConfiguration.builder().updater("adam")
            .learning_rate(0.05).seed(7).list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    path = tmp_path_factory.mktemp("batching") / "mlp.zip"
    ModelSerializer.write_model(net, str(path))
    return str(path), net


def _feature_file(tmp_path, rng, rows, idx=0, cols=4):
    p = tmp_path / f"x{rows}_{idx}.npy"
    np.save(p, rng.normal(size=(rows, cols)).astype(np.float32))
    return str(p)


def _singleton(net, path):
    return net.output(np.load(path)).numpy()


def _assert_c2(got, want, what):
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"{what}: argmax differs")
    np.testing.assert_allclose(got, want, rtol=0, atol=C2_ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# bucket policy
# ---------------------------------------------------------------------------

def test_bucket_rows_power_of_two():
    assert [bucket_rows(r) for r in (1, 2, 3, 4, 5, 8, 9, 16, 17)] \
        == [1, 2, 4, 4, 8, 8, 16, 16, 32]
    # oversize requests get their own pow2 bucket (no coalescing)
    assert bucket_rows(33) == 64
    with pytest.raises(ValueError):
        bucket_rows(0)


def test_global_cache_budget_follows_the_card(monkeypatch):
    """The process-global cache's byte budget: the JAX package's 512 MiB
    without a card, a quarter of the card's memory with one (its entries
    are CUDA graphs' private pools)."""
    from deeplearning4j_tpu_torch.keras import batching
    assert batching._default_cache_bytes() == 512 * 1024 * 1024

    class Props:
        total_memory = 80 * 1024 ** 3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    assert batching._default_cache_bytes() == 20 * 1024 ** 3
    prev = batching.set_compile_cache(None)
    try:
        assert batching.get_compile_cache().max_bytes == 20 * 1024 ** 3
    finally:
        batching.set_compile_cache(prev)


def test_max_batch_normalized_to_power_of_two():
    assert BatchScheduler(max_batch=24).max_batch == 16
    assert BatchScheduler(max_batch=32).max_batch == 32
    assert BatchScheduler(max_batch=1).max_batch == 1
    with pytest.raises(ValueError):
        BatchScheduler(max_batch=0)


# ---------------------------------------------------------------------------
# padding correctness: batched against singleton, the C2 gate
# ---------------------------------------------------------------------------

def test_ragged_batches_match_singleton(tmp_path, mlp_zip):
    """Mixed per-request row counts (1..max_batch) fired concurrently;
    every batched prediction is held to the singleton prediction of the
    same rows by the C2 gate."""
    model, net = mlp_zip
    rng = np.random.default_rng(0)
    sizes = [1, 2, 3, 5, 7, 8, 4, 6, 1, 8, 2, 3]
    files = [_feature_file(tmp_path, rng, rows, idx=i)
             for i, rows in enumerate(sizes)]
    srv = Server(max_concurrency=len(sizes), queue_depth=2 * len(sizes),
                 max_batch=8, max_wait_ms=40.0)
    try:
        warm = KerasClient(srv.host, srv.port)
        warm.predict(files[0], model=model)
        warm.close()
        results = {}
        lock = threading.Lock()
        start = threading.Barrier(len(files))

        def one(i, path):
            cli = KerasClient(srv.host, srv.port)
            try:
                start.wait(10.0)
                got = cli.predict(path, model=model)
                with lock:
                    results[i] = got
            finally:
                cli.close()

        threads = [threading.Thread(target=one, args=(i, p), daemon=True)
                   for i, p in enumerate(files)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert sorted(results) == list(range(len(files)))
        for i, path in enumerate(files):
            _assert_c2(results[i], _singleton(net, path),
                       f"request {i} (rows={sizes[i]}) against its "
                       "singleton prediction")
        # multi-request coalescing actually happened (12 concurrent
        # requests against max_batch=8 cannot all run alone)
        mix = srv._batcher.stats()["batch_size_mix"]
        assert any(int(k) >= 2 for k in mix), mix
        assert get_registry().get(
            "serving_batched_requests_total").value >= len(files)
    finally:
        srv.drain(grace_s=5.0)


def test_oversize_request_runs_alone_bitwise(tmp_path, mlp_zip):
    model, net = mlp_zip
    rng = np.random.default_rng(1)
    big = _feature_file(tmp_path, rng, 11)  # > max_batch=4 -> bucket 16
    srv = Server(max_batch=4, max_wait_ms=5.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        got = cli.predict(big, model=model)
        # alone in its bucket, padded to 16 rows: the MLP's rows are
        # independent row by row on the CPU, so this one is bitwise
        np.testing.assert_array_equal(got, _singleton(net, big))
        assert srv._batcher.stats()["bucket_mix"] == {"(4,):float32:16": 1}
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


# ---------------------------------------------------------------------------
# compile discipline
# ---------------------------------------------------------------------------

def test_zero_recompiles_for_repeated_bucket(tmp_path, mlp_zip):
    model, _ = mlp_zip
    rng = np.random.default_rng(2)
    x = _feature_file(tmp_path, rng, 4)
    srv = Server(max_batch=8, max_wait_ms=2.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)  # load + build bucket 4's runner
        net = next(iter(srv._models.values()))
        traces = net._infer_traces
        compiles = srv._batcher.stats()["compiles"]
        for _ in range(5):  # identical bucket: nothing built again
            cli.predict(x, model=model)
        assert net._infer_traces == traces == 0   # the CPU captures none
        assert srv._batcher.stats()["compiles"] == compiles == 1
        assert get_registry().get(
            "serving_compile_seconds_total").value > 0
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


def test_compile_cache_evicted_with_lru_model(tmp_path, mlp_zip):
    model, _ = mlp_zip
    rng = np.random.default_rng(3)
    x = _feature_file(tmp_path, rng, 2)
    clones = []
    for i in range(3):
        p = tmp_path / f"clone{i}.zip"
        shutil.copy(model, p)
        clones.append(str(p))
    srv = Server(keep_models=2, max_batch=8, max_wait_ms=2.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        for p in clones:
            cli.predict(x, model=p)
        # clone0 was evicted: its runners went with it (cache keys are
        # (scheduler id, model key, bucket, shape))
        cached_keys = {k[1] for k in srv._batcher._compiled.keys()
                       if k[0] == srv._batcher._cache_owner}
        assert clones[0] not in cached_keys
        assert len(srv._models) <= 2
        # an evicted model transparently reloads AND rebuilds
        got = cli.predict(x, model=clones[0])
        assert got.shape == (2, 3)
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


# ---------------------------------------------------------------------------
# flush taxonomy on the labeled counter family
# ---------------------------------------------------------------------------

def _flush_count(reason: str) -> float:
    fam = get_registry().get("serving_batch_flushes_total")
    return 0.0 if fam is None else fam.labels(reason=reason).value


def test_full_flush_when_bucket_fills(tmp_path, mlp_zip):
    model, _ = mlp_zip
    rng = np.random.default_rng(4)
    x1 = _feature_file(tmp_path, rng, 1)
    srv = Server(max_concurrency=4, max_batch=2, max_wait_ms=2000.0)
    try:
        start = threading.Barrier(2)

        def one():
            c = KerasClient(srv.host, srv.port)
            start.wait(10.0)
            c.predict(x1, model=model)
            c.close()

        threads = [threading.Thread(target=one, daemon=True)
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        # the two 1-row requests fill the max_batch=2 bucket: neither
        # waited out the 2s idle window
        assert _flush_count("full") >= 1
    finally:
        srv.drain(grace_s=5.0)


def test_idle_flush_at_low_load(tmp_path, mlp_zip):
    model, _ = mlp_zip
    rng = np.random.default_rng(5)
    x = _feature_file(tmp_path, rng, 1)
    srv = Server(max_batch=8, max_wait_ms=10.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)  # alone: must flush on the idle timer
        assert _flush_count("idle") >= 1
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


def test_labeled_counter_prometheus_render():
    reg = get_registry()
    fam = reg.labeled_counter("serving_batch_flushes_total",
                              help="batches dispatched, by flush reason")
    fam.labels(reason="full").inc(2)
    fam.labels(reason="deadline").inc()
    text = reg.to_prometheus()
    assert "# TYPE serving_batch_flushes_total counter" in text
    assert 'serving_batch_flushes_total{reason="full"} 2' in text
    assert 'serving_batch_flushes_total{reason="deadline"} 1' in text
    assert fam.value == 3  # family value sums children
    assert reg.snapshot("serving_")[
        "serving_batch_flushes_total"] == 3
    # JSON view keys by label set
    assert reg.to_dict()["serving_batch_flushes_total"] == {
        '{reason="deadline"}': 1.0, '{reason="full"}': 2.0}


# ---------------------------------------------------------------------------
# scheduler lifecycle + admission-time key resolution
# ---------------------------------------------------------------------------

def test_submit_after_stop_raises_draining():
    sched = BatchScheduler(max_batch=4)
    sched.stop()
    with pytest.raises(DrainingError):
        sched.submit("k", object(), threading.Lock(),
                     np.zeros((1, 4), np.float32), Deadline.from_ms(None))


def test_predict_without_model_resolves_at_admission(tmp_path, mlp_zip):
    """The model name is resolved ONCE at admission; an LRU swap between
    admission and dispatch can never retarget the request. Observable
    contract: a model-less predict on a single-model server works and
    targets that model (its rows ride a bucket of 4: the C2 gate)."""
    model, net = mlp_zip
    rng = np.random.default_rng(6)
    x = _feature_file(tmp_path, rng, 3)
    srv = Server(max_batch=8, max_wait_ms=2.0)
    try:
        cli = KerasClient(srv.host, srv.port)
        cli.predict(x, model=model)
        got = cli.predict(x)  # no 'model': resolved at admission
        _assert_c2(got, _singleton(net, x), "model-less predict")
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


def test_batching_disabled_still_serves(tmp_path, mlp_zip):
    model, net = mlp_zip
    rng = np.random.default_rng(7)
    x = _feature_file(tmp_path, rng, 2)
    srv = Server(batching=False)
    try:
        assert srv._batcher is None
        cli = KerasClient(srv.host, srv.port)
        got = cli.predict(x, model=model)
        np.testing.assert_array_equal(got, _singleton(net, x))
        cli.close()
    finally:
        srv.drain(grace_s=5.0)
