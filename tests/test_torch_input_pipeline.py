"""The port's streaming input pipeline (``datasets/pipeline.py``), its
fault seams, ``multihost.shard_sources`` / ``input_pipeline`` /
``global_array`` and ``models/gpt.char_lm_sources`` against the JAX
package's, on the CPU:

- a counterpart of every case of ``tests/test_input_pipeline.py`` (the
  port stages host tensors with ``device="cpu"``; the JAX package's
  ``place=False`` emits numpy);
- the same batches in the same order as the JAX pipeline on the same
  sources (in order, under skewed decode, sharded, shuffled, resumed),
  and ``windowed_shuffle_order``, ``cursor_state()`` and
  ``shuffle_signature()`` equal to the JAX package's;
- ``char_lm_sources``: the JAX package's charset and batches, emitted
  shard-major (ROADMAP C32);
- ``gpt_tiny`` (the JAX net's weights carried in) trained through the
  port's pipeline against the JAX net trained through the JAX pipeline,
  at ``tests/test_torch_gpt_train.py``'s loss tolerance;
- one group of four gloo ranks (``tests/torch_parallel_worker.py``; the
  dp = 2 cases on each half): ``ParallelTrainer`` fed by
  ``multihost.input_pipeline`` is bitwise the trainer fed the global
  batches, under gradient accumulation too, with and without batch norm;
  the pipeline trainer on a 2 x 2 (dp x pp) mesh likewise; a model axis
  gives both ranks of a replica the same rows, and a pipeline sharded by
  process is refused there;
- the trainers' ``attach`` hooks, the threads' teardown, lockcheck on the
  port's ``datasets``, and GC013 against a real pipeline.
"""

import logging
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu.datasets import pipeline as jpipe
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.resilience import faultinject as jfault

from deeplearning4j_tpu_torch.datasets import cloud_io
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.pipeline import (
    IdxPair, StreamingInputPipeline, _idx_read_python, shard_sources,
    windowed_shuffle_order,
)
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.faultinject import (
    Fault, FaultInjected, FaultSchedule,
)

ROOT = Path(__file__).resolve().parent.parent
#: tests/test_torch_gpt_train.py's loss tolerance (relative)
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_armed_faults():
    faultinject.clear()
    jfault.clear()
    yield
    faultinject.clear()
    jfault.clear()


def _tagged(i: int, n: int = 4, cls=DataSet) -> DataSet:
    """A batch whose features carry its source index (order probe)."""
    x = np.full((n, 3), float(i), dtype=np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(n) % 3]
    return cls(x, y)


def _pipe(sources, **kw):
    kw.setdefault("num_shards", 1)
    kw.setdefault("shard_index", 0)
    kw.setdefault("device", "cpu")
    return StreamingInputPipeline(sources, **kw)


def _drain(pipe) -> list:
    out = []
    try:
        for ds in pipe:
            out.append(ds)
    finally:
        pipe.close()
    return out


def _tags(batches) -> list:
    return [int(np.asarray(ds.features)[0, 0]) for ds in batches]


def _bytes(batches) -> list:
    return [(np.asarray(b.features).tobytes(), np.asarray(b.labels).tobytes())
            for b in batches]


# ------------------------------------------------------------ source shards

def test_shard_sources_disjoint_and_covering():
    sources = list(range(10))
    shards = [shard_sources(sources, 3, k) for k in range(3)]
    seen = [s for shard in shards for s in shard]
    assert sorted(seen) == sources
    assert [len(s) for s in shards] == [4, 3, 3]
    assert shards[0] == [0, 3, 6, 9]
    assert shards == [jpipe.shard_sources(sources, 3, k) for k in range(3)]


def test_shard_sources_single_process_default_is_identity():
    assert shard_sources(["a", "b"]) == ["a", "b"]


def test_shard_sources_rejects_bad_spec():
    with pytest.raises(ValueError):
        shard_sources([1, 2], 2, 2)
    with pytest.raises(ValueError):
        shard_sources([1, 2], 0, 0)
    with pytest.raises(ValueError):
        StreamingInputPipeline([], num_shards=2)


def test_pipeline_shards_are_disjoint_across_instances():
    sources = [(lambda i=i: _tagged(i)) for i in range(6)]
    halves = [_tags(_drain(_pipe(sources, num_shards=2, shard_index=k)))
              for k in range(2)]
    assert halves == [[0, 2, 4], [1, 3, 5]]


# ------------------------------------------------------- order determinism

def _skewed(i, cls=DataSet):
    def synth():
        # early sources decode slowest: a completion-order emission
        # would invert the stream
        time.sleep(0.03 * (8 - i) / 8)
        return _tagged(i, cls=cls)
    return synth


def test_emission_order_is_source_order_despite_skewed_decode():
    pipe = _pipe([_skewed(i) for i in range(8)], reader_workers=4,
                 decode_workers=4)
    assert _tags(_drain(pipe)) == list(range(8))


def test_reset_reproduces_the_stream():
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(5)])
    first = _tags([ds for ds in pipe])
    pipe.reset()
    assert _tags(_drain(pipe)) == first == list(range(5))


def test_batch_size_slices_dataset_sources_in_order(rng):
    x = rng.normal(size=(20, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 20)]
    pipe = _pipe([DataSet(x, y)], batch_size=8)
    got = _drain(pipe)
    assert [b.num_examples() for b in got] == [8, 8, 4]
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(b.features) for b in got]), x)
    assert pipe.samples_emitted == 20 and pipe.batches_emitted == 3


# ------------------------------------------------------------ decode paths

def test_decode_fn_over_local_paths(tmp_path):
    for i in range(3):
        (tmp_path / f"s{i}.txt").write_text(str(i))

    def decode(payload, source):
        return _tagged(int(payload.read_text()))  # payload: the local Path

    pipe = _pipe([str(tmp_path / f"s{i}.txt") for i in range(3)],
                 decode_fn=decode)
    assert _tags(_drain(pipe)) == [0, 1, 2]


def test_byte_range_sources_through_cloud_client(monkeypatch):
    class Client(cloud_io.CloudStorageClient):
        def read(self, url, start=None, length=None):
            return bytes(range(16))[start:start + length]

        def list(self, url):
            return []

    monkeypatch.setitem(cloud_io._CLIENTS, "gs", Client())
    pipe = _pipe([("gs://b/o", 2, 4), ("gs://b/o", 7, 4)],
                 decode_fn=lambda payload, source: _tagged(payload[0]))
    assert _tags(_drain(pipe)) == [2, 7]


def test_raw_source_without_decode_fn_is_rejected():
    with pytest.raises(ValueError, match="decode_fn"):
        StreamingInputPipeline(["/data/x.bin"])
    with pytest.raises(TypeError):
        StreamingInputPipeline([42])


def _write_idx(path, arr):
    arr = np.asarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 0x08, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


def test_idx_pair_source_decodes_mnist_shaped_batches(tmp_path, rng):
    imgs = rng.integers(0, 256, (10, 5, 5)).astype(np.uint8)
    labels = rng.integers(0, 3, (10,)).astype(np.uint8)
    _write_idx(tmp_path / "imgs.idx", imgs)
    _write_idx(tmp_path / "labels.idx", labels)
    kw = dict(scale=1.0 / 255.0, num_classes=3, add_channel_dim=True)
    pipe = _pipe([IdxPair(str(tmp_path / "imgs.idx"),
                          str(tmp_path / "labels.idx"), **kw)], batch_size=4)
    got = _drain(pipe)
    assert [b.num_examples() for b in got] == [4, 4, 2]
    feats = np.concatenate([np.asarray(b.features) for b in got])
    want = _idx_read_python(tmp_path / "imgs.idx", 1.0 / 255.0)[..., None]
    assert feats.tobytes() == want.astype(np.float32).tobytes()
    labs = np.concatenate([np.asarray(b.labels) for b in got])
    np.testing.assert_array_equal(labs.argmax(-1), labels)
    # the JAX pipeline decodes the same pair into the same bytes
    jgot = _drain(jpipe.StreamingInputPipeline(
        [jpipe.IdxPair(str(tmp_path / "imgs.idx"),
                       str(tmp_path / "labels.idx"), **kw)],
        batch_size=4, num_shards=1, shard_index=0, place=False))
    assert _bytes(got) == _bytes(jgot)


# ----------------------------------------------------------- device stage

class _StubMesh:
    """A data rank of a dp = 2 mesh on the CPU (what the device stage
    reads of a ``MeshContext``)."""

    n_data, data_index, device = 2, 1, torch.device("cpu")
    batch_slice = MeshContext.batch_slice
    holds_local_rows = MeshContext.holds_local_rows

    def __init__(self):
        self.cuts = []

    def rank_rows(self, n, k=1):
        self.cuts.append((n, k))
        return MeshContext.rank_rows(self, n, k)


def test_attach_mesh_places_batches_in_its_layout():
    mesh = _StubMesh()
    pipe = _pipe([lambda: _tagged(0)])
    assert not pipe.places_sharded
    pipe.attach(mesh=mesh)
    assert pipe.places_sharded
    (ds,) = _drain(pipe)
    # a global batch (num_shards=1): this data rank's rows, cut on the
    # host, staged as tensors on the mesh's device and marked
    assert mesh.cuts == [(4, 1)]
    assert isinstance(ds.features, torch.Tensor)
    assert ds.num_examples() == 2 and ds.data_ranks == 2
    np.testing.assert_array_equal(np.asarray(ds.labels),
                                  _tagged(0).labels[2:])


def test_a_global_batch_is_cut_for_the_trainers_microbatches():
    """Attached with 2 microbatches (a trainer's gradient accumulation),
    data rank 1 of 2 takes its share of each microbatch of a global batch
    of 8 rows: rows 2-3 and 6-7, in that order."""
    mesh = _StubMesh()
    rows = DataSet(np.arange(8, dtype=np.float32)[:, None].repeat(3, 1),
                   np.eye(3, dtype=np.float32)[np.arange(8) % 3])
    pipe = _pipe([lambda: rows]).attach(mesh=mesh, microbatches=2)
    (ds,) = _drain(pipe)
    assert mesh.cuts == [(8, 2)] and ds.data_ranks == 2
    assert np.asarray(ds.features)[:, 0].tolist() == [2.0, 3.0, 6.0, 7.0]
    with pytest.raises(ValueError, match="not divisible into 3"):
        _drain(_pipe([lambda: rows]).attach(mesh=_StubMesh(),
                                           microbatches=3))


def test_a_pipeline_sharded_by_data_index_is_not_cut_again():
    mesh = _StubMesh()
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(4)],
                 num_shards=2, shard_index=1, mesh=mesh)
    got = _drain(pipe)
    assert mesh.cuts == [] and _tags(got) == [1, 3]
    assert all(b.num_examples() == 4 and b.data_ranks == 2 for b in got)
    with pytest.raises(ValueError, match="data rank"):
        _drain(_pipe([lambda: _tagged(0)], num_shards=2, shard_index=0,
                     mesh=_StubMesh()))


def test_attach_place_false_keeps_batches_host_side():
    pipe = _pipe([lambda: _tagged(0)])
    pipe.attach(place=False)   # the ParallelWrapper path
    (ds,) = _drain(pipe)
    assert isinstance(ds.features, np.ndarray)


def test_device_none_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    pipe = StreamingInputPipeline([lambda: _tagged(0)], num_shards=1,
                                  shard_index=0)
    with pytest.raises(RuntimeError):
        pipe.has_next()
    pipe.close()


def test_dtype_casts_features_and_labels_not_masks():
    src = DataSet(np.ones((4, 3), np.float32), np.ones((4, 2), np.float32),
                  np.ones((4, 3), np.float32), None)
    (ds,) = _drain(_pipe([src], dtype="bfloat16"))
    assert ds.features.dtype == ds.labels.dtype == torch.bfloat16
    assert ds.features_mask.dtype == torch.float32
    multi = MultiDataSet([np.ones((2, 3), np.float32)],
                         [np.ones((2, 2), np.float32)])
    (m,) = _drain(_pipe([multi], dtype="bfloat16"))
    assert m.features[0].dtype == torch.bfloat16


def test_attach_is_frozen_after_iteration_starts():
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(2)], place=False)
    assert pipe.has_next()
    pipe.attach(mesh=_StubMesh())
    assert not pipe.places_sharded
    assert all(b.data_ranks is None for b in _drain(pipe))


# ------------------------------------------------------------- error paths

def test_decode_error_surfaces_in_order_after_good_batches():
    def boom():
        raise RuntimeError("decode exploded")

    pipe = _pipe([lambda: _tagged(0), boom, lambda: _tagged(2)])
    assert pipe.has_next()
    assert _tags([pipe.next()]) == [0]
    with pytest.raises(RuntimeError, match="decode exploded"):
        pipe.next()
    assert not pipe.has_next()
    pipe.close()


# -------------------------------------------------------------- chaos kinds

def test_slow_input_lands_in_stall_with_input_wait_span():
    faultinject.set_schedule(FaultSchedule(
        [Fault("slow_input", at_call=2, duration=0.25)]))
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(3)])
    tracer = get_tracer()
    deepest, sampled = [], []
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            stack = tracer.open_span_stack()
            sampled.extend(stack)
            if stack:
                deepest.append(stack[-1])
            time.sleep(0.01)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    try:
        reg0 = get_registry().snapshot("input_")
        assert _tags(_drain(pipe)) == [0, 1, 2]
    finally:
        stop.set()
        t.join()
    assert pipe.stall_s >= 0.25
    reg1 = get_registry().snapshot("input_")
    assert (reg1["input_stall_seconds_total"]
            - reg0.get("input_stall_seconds_total", 0.0)) >= 0.25
    assert "input:wait" in sampled and "input:wait" in deepest


def test_slow_input_lands_in_the_training_stats_input_stall():
    from deeplearning4j_tpu_torch.optimize.training_stats import (
        TrainingStats,
    )
    faultinject.set_schedule(FaultSchedule(
        [Fault("slow_input", at_call=1, duration=0.2)]))
    stats = TrainingStats()
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(2)])
    assert _tags(list(stats.timed_iter(pipe))) == [0, 1]
    pipe.close()
    assert stats.export()["input_stall_s"] >= 0.2


def test_io_error_absorbed_by_retry_policy():
    faultinject.set_schedule(FaultSchedule([Fault("io_error", at_call=1)]))
    reg0 = get_registry().snapshot("input_")
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(2)],
                 reader_workers=1, retry_base_s=0.01)
    assert _tags(_drain(pipe)) == [0, 1]
    reg1 = get_registry().snapshot("input_")
    assert (reg1["input_read_retries_total"]
            - reg0.get("input_read_retries_total", 0)) >= 1


def test_io_error_exhausting_retries_is_a_clean_in_order_error():
    faultinject.set_schedule(FaultSchedule(
        [Fault("io_error", at_call=1), Fault("io_error", at_call=2)]))
    pipe = _pipe([lambda: _tagged(0), lambda: _tagged(1)],
                 reader_workers=1, read_retries=1, retry_base_s=0.01)
    with pytest.raises(FaultInjected):
        _drain(pipe)
    assert not pipe.has_next()
    pipe.close()


def test_fault_seams_count_from_arming_and_clear_resets_them():
    faultinject.set_schedule(FaultSchedule(
        [Fault("slow_input", at_call=2, duration=0.0),
         Fault("io_error", at_call=2)]))
    assert faultinject.on_input_next() == 0.0
    faultinject.on_reader_read("a")
    faultinject.clear()
    assert faultinject.on_input_next() == 0.0     # disarmed
    faultinject.on_reader_read("b")
    faultinject.set_schedule(FaultSchedule([Fault("io_error", at_call=1)]))
    with pytest.raises(FaultInjected, match="reader read 1"):
        faultinject.on_reader_read("c")


# --------------------------------------------------------------- metrics

def test_throughput_counters_accumulate():
    reg0 = get_registry().snapshot("input_")
    _drain(_pipe([(lambda i=i: _tagged(i)) for i in range(3)]))
    reg1 = get_registry().snapshot("input_")

    def delta(k):
        return reg1.get(k, 0) - reg0.get(k, 0)

    assert delta("input_batches_total") == 3
    assert delta("input_samples_total") == 12
    assert delta("input_decode_seconds_total") > 0
    assert delta("input_h2d_seconds_total") > 0
    assert "input_queue_depth" in reg1


# ------------------------------------------------- review-hardening cases

def test_a_marked_batch_is_not_cut_again_by_the_mesh():
    """The counterpart of the JAX package's "shard_batch passes
    pre-placed arrays through": a batch marked ``data_ranks`` holds this
    rank's rows, and the mesh's ``local_rows`` leaves them whole."""
    from deeplearning4j_tpu_torch.datasets.dataset import global_rows

    class Mesh(_StubMesh):
        world, n_seq = 2, 1

        def seq_length(self, batch):
            return None
    mesh = Mesh()
    marked = DataSet(np.ones((4, 3), np.float32), np.ones((4, 2)),
                     data_ranks=2)
    assert MeshContext.local_rows(mesh, marked) is marked
    assert global_rows(marked) == 8
    host = DataSet(np.ones((4, 3), np.float32), np.ones((4, 2)))
    assert MeshContext.local_rows(mesh, host).num_examples() == 2
    assert global_rows(host) == 4


def test_uneven_shards_warn_about_spmd_desync(caplog):
    log = "deeplearning4j_tpu_torch.datasets.pipeline"
    with caplog.at_level(logging.WARNING, logger=log):
        shard_sources(list(range(5)), 2, 0)
    assert any("UNEVEN" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=log):
        shard_sources(list(range(6)), 2, 0)
    assert not caplog.records


def test_reorder_buffer_is_bounded_by_run_ahead_window():
    def make(i):
        def synth():
            if i == 0:
                time.sleep(0.25)
            return _tagged(i)
        return synth

    pipe = _pipe([make(i) for i in range(10)], reader_workers=2,
                 decode_workers=2, reorder_window=2)
    high_water = 0
    stop = threading.Event()
    saw_buffer = threading.Event()

    def sampler():
        nonlocal high_water
        while not stop.is_set():
            try:
                depth = len(pipe._gen.ready)
            except AttributeError:
                depth = 0
            if depth:
                saw_buffer.set()
            high_water = max(high_water, depth)
            time.sleep(0.005)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    try:
        assert _tags(_drain(pipe)) == list(range(10))
    finally:
        stop.set()
        t.join()
    assert saw_buffer.is_set(), "sampler never saw the reorder buffer"
    assert high_water <= 2 + 2, high_water


def test_workers_stop_after_stream_ends_without_close():
    def boom():
        raise RuntimeError("dead source")

    pipe = _pipe([lambda: _tagged(0), boom]
                 + [(lambda i=i: _tagged(i)) for i in range(2, 8)],
                 reader_workers=2, decode_workers=2, reorder_window=2)
    with pytest.raises(RuntimeError, match="dead source"):
        while pipe.has_next():
            pipe.next()
    deadline = time.time() + 3.0
    while time.time() < deadline and any(t.is_alive()
                                         for t in pipe._threads):
        time.sleep(0.02)
    assert not any(t.is_alive() for t in pipe._threads)


def test_close_wakes_a_consumer_blocked_in_next():
    release = threading.Event()

    def stalled():
        release.wait(timeout=30.0)
        return _tagged(0)

    pipe = _pipe([stalled], place=False)
    state = {}

    def consume():
        try:
            state["batches"] = _tags(list(pipe))
        except BaseException as e:  # noqa: BLE001 — recorded for assert
            state["error"] = e

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    pipe.close()
    t.join(timeout=10.0)
    release.set()
    assert not t.is_alive(), "consumer stayed hung after close()"
    assert state.get("batches") == [] and "error" not in state


def test_close_sticks_for_a_consumer_not_blocked_in_next():
    pipe = _pipe([_tagged(i) for i in range(3)], place=False)
    assert _tags([pipe.next()]) == [0]
    pipe.close()
    assert not pipe.has_next()
    with pytest.raises(StopIteration):
        pipe.next()
    assert not pipe._started, "close() restarted the worker pool"
    pipe.reset()
    assert _tags(_drain(pipe)) == [0, 1, 2]


def test_reset_with_stuck_straggler_cannot_corrupt_the_new_run():
    gate = threading.Event()
    first_call = threading.Event()

    def slow_then(i):
        def synth():
            if i == 1 and not first_call.is_set():
                first_call.set()
                gate.wait(timeout=30.0)
            return _tagged(i)
        return synth

    pipe = _pipe([slow_then(i) for i in range(4)], place=False,
                 reader_workers=1, decode_workers=1)
    assert pipe.has_next() and _tags([pipe.next()]) == [0]
    first_call.wait(timeout=5.0)
    old_threads = list(pipe._threads)
    pipe.reset()
    assert any(t.is_alive() for t in old_threads), \
        "test needs a live straggler to mean anything"
    try:
        gate.set()
        assert _tags(_drain(pipe)) == [0, 1, 2, 3]
    finally:
        gate.set()


def test_close_reaps_every_worker_thread():
    """The counterpart of ``tests/test_thread_hygiene.py``'s pipeline
    case: after ``close()`` mid-stream every worker is gone and
    ``threading.enumerate()`` is back at its baseline."""
    base = {t.ident for t in threading.enumerate()}
    pipe = _pipe([(lambda i=i: _tagged(i)) for i in range(6)],
                 reader_workers=3, decode_workers=3)
    assert pipe.has_next() and pipe.next() is not None
    workers = list(pipe._threads)
    assert len(workers) == 3 + 3 + 1
    pipe.close()
    assert not any(t.is_alive() for t in workers)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and [
            t for t in threading.enumerate() if t.ident not in base]:
        time.sleep(0.02)
    assert not [t.name for t in threading.enumerate()
                if t.ident not in base]


def test_lockcheck_is_clean_on_the_ports_datasets():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "lockcheck.py"),
         str(ROOT / "deeplearning4j_tpu_torch" / "datasets")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----------------------------------------------------- windowed shuffle

def _shuffled(srcs, seed=11, window=4, **kw):
    kw.setdefault("place", False)
    return _pipe(srcs, shuffle_window=window, shuffle_seed=seed, **kw)


def test_windowed_shuffle_order_is_bounded_deterministic_permutation():
    rng = np.random.default_rng([7, 0])
    order = windowed_shuffle_order(50, 8, rng)
    assert sorted(order) == list(range(50))
    assert order != list(range(50))
    assert all(pos >= v - 7 for pos, v in enumerate(order))
    assert order == windowed_shuffle_order(
        50, 8, np.random.default_rng([7, 0]))
    assert windowed_shuffle_order(9, 1, rng) == list(range(9))


@pytest.mark.parametrize("n,window,seed", [(50, 8, [7, 0]), (10, 4, [11, 0]),
                                           (10, 4, [11, 1]), (7, 3, 5)])
def test_windowed_shuffle_order_equals_the_jax_packages(n, window, seed):
    assert windowed_shuffle_order(n, window, np.random.default_rng(seed)) \
        == jpipe.windowed_shuffle_order(n, window,
                                        np.random.default_rng(seed))


def test_shuffled_emission_deterministic_per_seed_and_epoch():
    srcs = [_tagged(i) for i in range(10)]
    o1 = _tags(_drain(_shuffled(srcs)))
    o2 = _tags(_drain(_shuffled(srcs)))
    assert o1 == o2
    assert sorted(o1) == list(range(10))
    assert o1 != list(range(10))
    assert _tags(_drain(_shuffled(srcs, seed=99))) != o1
    pipe = _shuffled(srcs)
    first = _tags([b for b in pipe])
    pipe.reset()
    second = _tags(_drain(pipe))
    assert first == o1 and sorted(second) == list(range(10))
    assert second != first


def test_shuffle_cursor_resume_replays_tail_exactly_once():
    srcs = [_tagged(i) for i in range(10)]
    unbroken = _tags(_drain(_shuffled(srcs)))
    broken = _shuffled(srcs)
    head = [broken.next() for _ in range(4)]
    state = broken.cursor_state()
    broken.close()
    assert state == {"shuffle_seed": 11, "shuffle_window": 4,
                     "epoch": 0, "emitted": 4}
    tail = _drain(_shuffled(srcs).restore_cursor(state))
    assert _tags(head) + _tags(tail) == unbroken


def test_restore_cursor_rejects_mismatched_shuffle_identity():
    srcs = [_tagged(i) for i in range(4)]
    state = _shuffled(srcs).cursor_state()
    with pytest.raises(ValueError, match="different emission order"):
        _shuffled(srcs, seed=99).restore_cursor(state)
    with pytest.raises(ValueError, match="different emission order"):
        _shuffled(srcs, window=2).restore_cursor(state)
    started = _shuffled(srcs)
    started.next()
    with pytest.raises(RuntimeError, match="before iteration"):
        started.restore_cursor(state)
    started.close()


def test_shuffle_signature_present_only_when_shuffling():
    srcs = [_tagged(i) for i in range(3)]
    assert _shuffled(srcs).shuffle_signature() == {
        "kind": "windowed_shuffle", "seed": 11, "window": 4}
    plain = _pipe(srcs, place=False)
    assert plain.shuffle_signature() is None
    assert _tags(_drain(plain)) == [0, 1, 2]


def test_cursor_state_after_close_describes_interrupted_epoch():
    srcs = [_tagged(i) for i in range(8)]
    unbroken = _tags(_drain(_shuffled(srcs, window=3)))
    pipe = _shuffled(srcs, window=3)
    head = [pipe.next() for _ in range(3)]
    before = pipe.cursor_state()
    pipe.close()
    after = pipe.cursor_state()
    assert after == before == {"shuffle_seed": 11, "shuffle_window": 3,
                               "epoch": 0, "emitted": 3}
    resumed = _shuffled(srcs, window=3).restore_cursor(after)
    assert _tags(head) + _tags(_drain(resumed)) == unbroken


# ------------------------------------------- the JAX package's pipeline

def _jpipe(sources, **kw):
    kw.setdefault("num_shards", 1)
    kw.setdefault("shard_index", 0)
    return jpipe.StreamingInputPipeline(sources, place=False, **kw)


def _pair_sources(n, rows=4, seed=3):
    r = np.random.default_rng(seed)
    arrays = [(r.normal(size=(rows, 3)).astype(np.float32),
               np.eye(3, dtype=np.float32)[r.integers(0, 3, rows)])
              for _ in range(n)]
    return ([DataSet(*a) for a in arrays], [JDataSet(*a) for a in arrays])


@pytest.mark.parametrize("case", ["in_order", "skewed", "sharded",
                                  "shuffled", "batch_size"])
def test_the_same_batches_in_the_same_order_as_the_jax_pipeline(case):
    port, jax_ = _pair_sources(8)
    kw = {}
    if case == "skewed":
        port = [_skewed(i) for i in range(8)]
        jax_ = [_skewed(i, JDataSet) for i in range(8)]
        kw = dict(reader_workers=4, decode_workers=4)
    elif case == "sharded":
        kw = dict(num_shards=3, shard_index=1)
    elif case == "shuffled":
        kw = dict(shuffle_window=4, shuffle_seed=7)
    elif case == "batch_size":
        port = [DataSet.merge(port)]
        jax_ = [JDataSet(np.concatenate([b.features for b in jax_]),
                         np.concatenate([b.labels for b in jax_]))]
        kw = dict(batch_size=5)
    got, want = _drain(_pipe(port, **kw)), _drain(_jpipe(jax_, **kw))
    assert len(got) == len(want) > 0
    assert _bytes(got) == _bytes(want)


def test_cursor_and_signature_equal_the_jax_pipelines():
    port, jax_ = _pair_sources(10)
    kw = dict(shuffle_window=4, shuffle_seed=7)
    p, j = _pipe(port, place=False, **kw), _jpipe(jax_, **kw)
    assert p.cursor_state() == j.cursor_state()
    assert p.shuffle_signature() == j.shuffle_signature()
    for _ in range(3):
        p.next()
        j.next()
    assert p.cursor_state() == j.cursor_state()
    state = p.cursor_state()
    p.close()
    j.close()
    assert p.cursor_state() == j.cursor_state() == state
    tail = _drain(_pipe(port, place=False, **kw).restore_cursor(state))
    jtail = _drain(_jpipe(jax_, **kw).restore_cursor(state))
    assert _bytes(tail) == _bytes(jtail) and len(tail) == 7


# ------------------------------------------------------ char_lm_sources

TEXT = jgpt.synthetic_char_text(40 * 9 + 1, seed=3)


def test_char_lm_sources_equal_the_jax_packages_and_emit_shard_major():
    sources, cs = tgpt.char_lm_sources(TEXT, 8, 4, n_sources=3)
    jsources, jcs = jgpt.char_lm_sources(TEXT, 8, 4, n_sources=3)
    assert cs == jcs
    for s, js in zip(sources, jsources):
        assert _bytes(s()) == _bytes(js())
    plain = tgpt.char_lm_batches(TEXT, 8, 4, charset=cs)
    got = _drain(_pipe(sources, reader_workers=2, decode_workers=2))
    # C32: shard-major, not the plain in-order stream
    want = [b for s in range(3) for b in plain[s::3]]
    assert _bytes(got) == _bytes(want)
    assert _bytes(got) != _bytes(plain)
    assert _bytes(got) == _bytes(_drain(_jpipe(jsources)))


def test_tiny_gpt_fit_through_the_pipeline_matches_the_jax_package(
        monkeypatch):
    """``gpt_tiny`` with the JAX net's weights: ``fit`` through the port's
    pipeline (world 1: the plain ``fit`` over the staged host tensors)
    against the JAX net's ``fit`` through the JAX pipeline, 6 steps, and
    bitwise the port's own fit of the same batches in shard-major
    order."""
    import jax

    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    V, T, B = 16, 8, 4
    text = "".join(chr(97 + i % V) for i in
                   np.random.default_rng(5).integers(0, 64, 6 * B * (T + 1)
                                                     + 1))
    sources, cs = tgpt.char_lm_sources(text, T, B, n_sources=3)
    jsources, _ = jgpt.char_lm_sources(text, T, B, n_sources=3, charset=cs)
    assert len(cs) == V
    jnet = JGraph(jgpt.gpt_tiny(vocab_size=V, seq_len=T)).init()
    conf = tgpt.gpt_tiny(vocab_size=V, seq_len=T)
    params = jax.tree.map(np.asarray, jnet.params)

    def losses_of(net):
        seen = []
        fit_batch = net.fit_batch

        def spy(b):
            loss = fit_batch(b)
            seen.append(float(loss))
            return loss
        net.fit_batch = spy
        return seen

    jl = losses_of(jnet)
    jnet.fit(_jpipe(jsources))
    net = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, params))
    tl = losses_of(net)
    net.fit(_pipe(sources))
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    plain = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, params))
    pl = losses_of(plain)
    batches = tgpt.char_lm_batches(text, T, B, charset=cs)
    plain.fit(ListDataSetIterator([b for s in range(3)
                                   for b in batches[s::3]]))
    assert np.float32(tl).tobytes() == np.float32(pl).tobytes()
    assert net.params_flat().tobytes() == plain.params_flat().tobytes()


# ------------------------------------------------------------- multihost

def test_multihost_input_half_at_world_1():
    from deeplearning4j_tpu_torch.parallel import MeshContext, multihost
    assert multihost.shard_sources(list(range(5))) == list(range(5))
    mesh = MeshContext.create(device="cpu")
    assert multihost.shard_sources(list(range(5)), mesh) == list(range(5))
    pipe = multihost.input_pipeline([_tagged(i) for i in range(3)], mesh)
    assert isinstance(pipe, StreamingInputPipeline) and pipe.places_sharded
    got = _drain(pipe)
    assert _tags(got) == [0, 1, 2]
    assert all(isinstance(b.features, torch.Tensor) for b in got)
    marked = multihost.global_array(_tagged(4), mesh)
    assert marked.data_ranks == 1 and isinstance(marked.labels, torch.Tensor)
    with pytest.raises(TypeError, match="DataSet"):
        multihost.global_array(np.ones((2, 3)), mesh)


def test_a_marked_batch_trains_as_the_global_one_under_accumulation():
    """World 1: a batch ``global_array`` marks is cut into its
    microbatches only, bitwise the unmarked batch; a mark of another
    data axis's width is refused."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer, multihost,
    )
    r = np.random.default_rng(2)
    ds = DataSet(r.normal(size=(8, 3)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)])
    mesh = MeshContext.create(device="cpu")
    runs = []
    for batch in (ds, multihost.global_array(ds, mesh)):
        tr = ParallelTrainer(_mlp(), mesh, gradient_accumulation=2)
        runs.append((float(tr.fit_batch(batch)), tr.net.params_flat(),
                     tr.net.last_batch_size))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2] == 8
    assert runs[0][1].tobytes() == runs[1][1].tobytes()
    with pytest.raises(ValueError, match="data axis is 1 wide"):
        ParallelTrainer(_mlp(), mesh).fit_batch(
            DataSet(ds.features, ds.labels, data_ranks=2))


# ------------------------------------------------------------------ attach

def _mlp():
    return W.build("mlp", hidden=8, n_in=3)


def _spy_pipe(sources, **kw):
    calls = []
    pipe = _pipe(sources, **kw)
    attach = pipe.attach

    def spy(**a):
        calls.append(a)
        return attach(**a)
    pipe.attach = spy
    return pipe, calls


def test_parallel_trainer_fit_attaches_its_mesh():
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    tr = ParallelTrainer(_mlp(), device="cpu")
    pipe, calls = _spy_pipe([_tagged(i) for i in range(3)])
    tr.fit(pipe)
    assert calls == [dict(mesh=tr.mesh, place=None, microbatches=1)]
    assert pipe.places_sharded and tr.net.iteration_count == 3


def test_a_scan_window_fit_keeps_the_batches_on_the_host():
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    tr = ParallelTrainer(_mlp(), device="cpu")
    pipe, calls = _spy_pipe([_tagged(i) for i in range(4)])
    seen = []
    scan = tr.fit_batches_scan

    def spy(batches):
        seen.extend(type(b.features) for b in batches)
        return scan(batches)
    tr.fit_batches_scan = spy
    tr.fit(pipe, scan_window=2)
    assert calls == [dict(mesh=tr.mesh, place=False, microbatches=1)]
    assert seen == [np.ndarray] * 4


def test_parallel_wrapper_fit_keeps_the_batches_on_the_host():
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    wrapper = ParallelWrapper(_mlp(), workers=2, device="cpu")
    pipe, calls = _spy_pipe([_tagged(i) for i in range(4)])
    wrapper.fit(pipe)
    assert calls == [dict(place=False)] and not pipe.places_sharded


def test_early_stopping_parallel_trainer_attaches_the_mesh():
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingParallelTrainer,
        MaxEpochsTerminationCondition,
    )
    pipe, calls = _spy_pipe([_tagged(i) for i in range(2)])
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(1)])
    es = EarlyStoppingParallelTrainer(cfg, _mlp(), pipe, device="cpu")
    assert calls == [dict(mesh=es.trainer.mesh)] and pipe.places_sharded
    es.fit()
    assert es.trainer.net.iteration_count == 2


# ------------------------------------------------------------------ GC013

def test_gc013_quiet_for_a_pipeline_and_fires_for_a_list_iterator():
    from deeplearning4j_tpu import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.analysis.graphcheck import validate_config as jv
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.analysis.graphcheck import validate_config
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration,
    )
    jconf = (NeuralNetConfiguration.builder().seed(1).list()
             .layer(DenseLayer(n_out=8, activation="relu"))
             .layer(OutputLayer(n_out=3, activation="softmax"))
             .set_input_type(InputType.feed_forward(3)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    pipe = _pipe([_tagged(0)], place=False)
    got = [(f.rule, f.location) for f in validate_config(
        conf, mesh={"data": 2}, batch_size=8, input_iterator=pipe)]
    want = [(f.rule, f.location) for f in jv(
        jconf, mesh={"dp": 2}, batch_size=8, input_iterator=_jpipe([]))]
    assert "GC013" not in [r for r, _ in got] and got == want
    found = [f for f in validate_config(
        conf, mesh={"data": 2}, batch_size=8,
        input_iterator=ListDataSetIterator([_tagged(0)]))
        if f.rule == "GC013"]
    assert [f.location for f in found] == ["ListDataSetIterator"]
    assert "StreamingInputPipeline" in found[0].hint
    assert "input_pipeline" in found[0].hint


# ----------------------------------------------------- world 2 over gloo

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    import jax

    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    tmp = tmp_path_factory.mktemp("input_pipeline")
    r = np.random.default_rng(9)
    sources = [(r.normal(size=(4, 4)).astype(np.float32),
                np.eye(3, dtype=np.float32)[r.integers(0, 3, 4)])
               for _ in range(6)]
    cs = "abcdefghijklmnop"
    text = "".join(cs[i] for i in r.integers(0, 16, 4 * 2 * 9 + 1))
    gpt = [(b.features, b.labels)
           for b in jgpt.char_lm_batches(text, 8, 2, charset=cs)]
    assert len(gpt) == 4
    jnet = JGraph(jgpt.gpt_tiny(vocab_size=16, seq_len=8)).init()
    cases = [dict(name="pipeline", fn="input_pipeline",
                  args=dict(kind="mlp", net_kw=dict(), params=None,
                            sources=sources, gpt_sources=gpt,
                            gpt_params=jax.tree.map(np.asarray,
                                                    jnet.params))),
             dict(name="replica", fn="input_replica_rows",
                  args=dict(sources=[(np.full((2, 4), float(i), np.float32),
                                      np.eye(3, dtype=np.float32)[:2])
                                     for i in range(4)])),
             dict(name="accumulation", fn="input_accumulation",
                  args=dict(sources=sources[:4])),
             dict(name="pipe_stages", fn="input_pipe_stages",
                  args=dict(sources=sources[:4]))]
    return W.run_group(cases, tmp, world=4)


@pytest.mark.parametrize("fed", ["pipeline", "global_pipeline",
                                 "global_array"])
def test_world_2_trainer_fed_rank_local_batches_is_the_global_one_bitwise(
        group, fed):
    for rank in (0, 1):
        out = W.result(group, "pipeline", rank)
        got, want = out[fed], out["reference"]
        assert len(got["losses"]) == 3
        assert got["losses"] == want["losses"]
        assert got["params"].tobytes() == want["params"].tobytes()
        assert got["last_batch_size"] == want["last_batch_size"] == 8
    a, b = (W.result(group, "pipeline", r)[fed] for r in (0, 1))
    assert a["params"].tobytes() == b["params"].tobytes()


def test_world_2_pipeline_stages_the_ranks_disjoint_local_rows(group):
    for rank in (0, 1):
        out = W.result(group, "pipeline", rank)
        assert out["coords"][0] == rank
        assert out["shard_sources_mesh"] == [rank, rank + 2]
        staged = out["staged"]
        assert [s["rows"] for s in staged] == [4, 4, 4]
        assert all(s["data_ranks"] == 2 and s["tensor"] for s in staged)
    firsts = [[s["first"] for s in W.result(group, "pipeline", r)["staged"]]
              for r in (0, 1)]
    assert firsts[0] != firsts[1]


def test_world_2_tiny_gpt_through_the_pipeline_is_the_global_fit(group):
    for rank in (0, 1):
        out = W.result(group, "pipeline", rank)
        got, want = out["gpt_pipeline"], out["gpt_reference"]
        assert len(got["losses"]) == 2
        assert got["losses"] == want["losses"]
        assert got["params"].tobytes() == want["params"].tobytes()


def test_a_model_axis_gives_both_ranks_of_a_replica_the_same_rows(group):
    r0, r1 = (W.result(group, "replica", r) for r in (0, 1))
    assert r0["coords"][:2] == (0, 0) and r1["coords"][:2] == (0, 1)
    assert r0["tags"] == r1["tags"] == [0.0, 1.0, 2.0, 3.0]
    assert r0["shard_mesh"] == r1["shard_mesh"] == list(range(8))
    # sharded by process instead, the two ranks would read other rows
    assert r0["shard_process"] == [0, 4] and r1["shard_process"] == [1, 5]


def test_a_pipeline_sharded_by_process_is_refused_on_a_model_axis(group):
    """``multihost.input_pipeline(sources)`` built without the mesh shards
    by process; bound to a 1 x 2 mesh by ``ParallelTrainer.fit`` it would
    hand the replica's two ranks other rows, so it raises before a step."""
    for rank in (0, 1):
        out = W.result(group, "replica", rank)
        kind, msg = out["refused"]
        assert kind == "ValueError" and out["steps"] == 0
        assert f"shard {rank} of 4" in msg and "data rank is 0 of 1" in msg


@pytest.mark.parametrize("kind", ["mlp", "mlp_bn"])
def test_world_2_accumulation_of_marked_batches_is_the_global_step(
        group, kind):
    """Under gradient accumulation 2 at dp = 2: ``global_array``'s local
    batches train bitwise the global batches whose microbatch i is the
    ranks' microbatches i, and a pipeline of global batches
    (``num_shards=1``, cut for the trainer's microbatches) trains bitwise
    the same global batches fed whole, batch norm included."""
    for rank in range(4):
        out = W.result(group, "accumulation", rank)[kind]
        for got, want in (("global_array", "interleaved"),
                          ("global_pipeline", "concat")):
            a, b = out[got], out[want]
            assert len(a["losses"]) == 2 and a["losses"] == b["losses"]
            assert a["params"].tobytes() == b["params"].tobytes()
            assert a["last_batch_size"] == b["last_batch_size"] == 8


@pytest.mark.parametrize("kind", ["mlp", "mlp_bn"])
def test_pp_x_dp_pipeline_trainer_takes_rank_local_batches_uncut(
        group, kind):
    """The pipeline trainer on a 2 x 2 (dp x pp) mesh, 2 microbatches:
    ``multihost.input_pipeline(sources, mesh)`` and ``global_array``
    (rank-local rows, marked) train bitwise the global batches whose
    microbatch i is the replicas' microbatches i, and a pipeline of
    global batches trains bitwise the same batches fed whole; the two
    stages of a replica read the same rows."""
    outs = [W.result(group, "pipe_stages", r) for r in range(4)]
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for out in outs:
        runs = out[kind]
        for got, want in (("pipeline", "interleaved"),
                          ("global_array", "interleaved"),
                          ("global_pipeline", "concat")):
            a, b = runs[got], runs[want]
            assert len(a["losses"]) == 2 and a["losses"] == b["losses"]
            assert a["params"].tobytes() == b["params"].tobytes()
            assert a["last_batch_size"] == b["last_batch_size"] == 8
        assert [s["rows"] for s in runs["staged"]] == [4, 4]
        assert all(s["data_ranks"] == 2 for s in runs["staged"])
    firsts = [[s["first"] for s in o[kind]["staged"]] for o in outs]
    assert firsts[0] == firsts[1] and firsts[2] == firsts[3]
    assert firsts[0] != firsts[2]
