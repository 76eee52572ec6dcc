"""The port's iterators (``datasets/iterator.py``) against the JAX
package's on the same data, and their threads:

- ``ExistingDataSetIterator``, ``SamplingDataSetIterator`` (the same seed
  draws the same rows), ``MultipleEpochsIterator`` and
  ``AsyncDataSetIterator`` yield the JAX iterators' batches;
- ``DevicePrefetchIterator(device="cpu")``: the case of
  ``tests/test_records_fetchers.py`` (floats cast, masks not, a second
  epoch), and the containers take its tensors as they are;
- the iterator cases of ``tests/test_thread_hygiene.py`` and
  ``tests/test_review_regressions.py``, and a teardown test: after
  ``close()``, after an error in the base iterator and after ``reset()``
  mid-epoch, ``threading.enumerate()`` returns to its baseline;
- ``fit(use_async=True)`` trains bitwise as ``use_async=False`` and leaves
  no thread behind, also when a step raises;
- ``tools/lockcheck.py`` is clean on the port's ``datasets``.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterator as jit_
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator, DataSet, DevicePrefetchIterator,
    ExistingDataSetIterator, ListDataSetIterator, MultipleEpochsIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(7)


def _tiny_batch(i=0):
    return DataSet(np.full((2, 3), float(i), np.float32),
                   np.eye(2, dtype=np.float32))


def _baseline():
    return {t.ident for t in threading.enumerate()}


def _assert_settled(base, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        extra = [t for t in threading.enumerate() if t.ident not in base]
        if not extra:
            return
        time.sleep(0.01)
    raise AssertionError(f"threads left behind: {extra}")


def _arrays(n=5, b=4):
    return [(RNG.normal(size=(b, 3)).astype(np.float32),
             np.eye(2, dtype=np.float32)[RNG.integers(0, 2, b)])
            for _ in range(n)]


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g.features),
                                      np.asarray(r.features))
        np.testing.assert_array_equal(np.asarray(g.labels),
                                      np.asarray(r.labels))


@pytest.mark.parametrize("kind", ["existing", "sampling", "epochs",
                                  "async"])
def test_adapters_yield_the_jax_iterators_batches(kind):
    arrays = _arrays()
    full = (np.concatenate([a for a, _ in arrays]),
            np.concatenate([b for _, b in arrays]))
    if kind == "existing":
        got = list(ExistingDataSetIterator([DataSet(*a) for a in arrays]))
        ref = list(jit_.ExistingDataSetIterator(
            [JDataSet(*a) for a in arrays]))
    elif kind == "sampling":
        got = list(SamplingDataSetIterator(DataSet(*full), 3, 4, seed=5))
        ref = list(jit_.SamplingDataSetIterator(JDataSet(*full), 3, 4,
                                                seed=5))
    elif kind == "epochs":
        got = list(MultipleEpochsIterator(
            3, ListDataSetIterator([DataSet(*a) for a in arrays])))
        ref = list(jit_.MultipleEpochsIterator(
            3, jit_.ListDataSetIterator([JDataSet(*a) for a in arrays])))
        assert len(got) == 3 * len(arrays)
    else:
        it = AsyncDataSetIterator(
            ListDataSetIterator([DataSet(*a) for a in arrays]), queue_size=2)
        got = list(it) + list(it)            # two epochs through reset
        ref = 2 * [JDataSet(*a) for a in arrays]
        it.close()
    _same(got, ref)


def test_device_prefetch_iterator():
    """Batches come back as tensors on the device with the requested
    float dtype; masks are not cast, labels are (as in the JAX
    iterator); a second epoch works."""
    base = ListDataSetIterator([
        DataSet(np.ones((4, 3), np.float32), np.ones((4, 2), np.float32),
                np.ones((4,), np.float32), None)
        for _ in range(3)])
    it = DevicePrefetchIterator(base, dtype="bfloat16", device="cpu")
    got = list(it)
    assert len(got) == 3
    assert got[0].features.dtype == torch.bfloat16
    assert got[0].labels.dtype == torch.bfloat16
    assert got[0].features_mask.dtype == torch.float32
    assert got[0].labels_mask is None
    assert len(list(it)) == 3
    it.close()
    assert not it.async_supported()


def test_device_prefetch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError):
        DevicePrefetchIterator(ListDataSetIterator([_tiny_batch()]))


def _mlp():
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("adam", learning_rate=0.01).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_containers_take_prefetched_tensors_as_they_are():
    """A prefetched batch (tensors already on the net's device) trains
    bitwise as the numpy batch it came from; a bf16 prefetch casts its
    features back to the net's dtype on the device."""
    batches = [DataSet(*a) for a in _arrays(4)]
    ref, got, cast = _mlp(), _mlp(), _mlp()
    ref.fit(ListDataSetIterator(batches), use_async=False)
    got.fit(DevicePrefetchIterator(ListDataSetIterator(batches),
                                   device="cpu"))
    for a, b in zip(tree_leaves(got.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    cast.fit(DevicePrefetchIterator(ListDataSetIterator(batches),
                                    dtype="bfloat16", device="cpu"))
    assert np.isfinite(cast.params_flat()).all()
    assert cast.iteration_count == 4


def test_fit_use_async_is_bitwise_the_synchronous_fit():
    batches = [DataSet(*a) for a in _arrays(6)]
    base = _baseline()
    a, b = _mlp(), _mlp()
    a.fit(ListDataSetIterator(batches), epochs=2, use_async=True)
    b.fit(ListDataSetIterator(batches), epochs=2, use_async=False)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert a.iteration_count == b.iteration_count == 12
    _assert_settled(base)


def test_fit_closes_its_prefetch_thread_when_a_step_raises():
    """A step that raises inside ``fit`` (a label width the head does not
    take) leaves no producer thread behind: ``fit`` closes the
    ``AsyncDataSetIterator`` it made."""
    base = _baseline()
    bad = DataSet(np.zeros((5, 3), np.float32),
                  np.zeros((5, 7), np.float32))
    net = _mlp()
    with pytest.raises(ValueError):
        net.fit(ListDataSetIterator([bad] * 20), use_async=True)
    _assert_settled(base)


def test_async_iterator_close_releases_parked_producer():
    """The producer may be parked on a full queue when close() arrives;
    close() drains it loose and joins it."""
    many = [_tiny_batch(i) for i in range(64)]
    base = _baseline()
    it = AsyncDataSetIterator(ExistingDataSetIterator(iter(many)),
                              queue_size=2)
    assert it.next() is not None
    it.close()
    _assert_settled(base)
    assert not it.has_next()


def test_async_iterator_close_after_full_consumption():
    it = AsyncDataSetIterator(
        ExistingDataSetIterator(iter([_tiny_batch()])), queue_size=2)
    while it.has_next():
        it.next()
    it.close()  # must return promptly, not hang
    assert not it.has_next()


def test_async_iterator_propagates_producer_error():
    def gen():
        yield DataSet(np.zeros((2, 3), np.float32),
                      np.zeros((2, 2), np.float32))
        raise RuntimeError("boom in producer")

    base = _baseline()
    it = AsyncDataSetIterator(ExistingDataSetIterator(gen()))
    assert it.next().num_examples() == 2
    with pytest.raises(RuntimeError, match="boom in producer"):
        while it.has_next():
            it.next()
    assert not it.has_next()
    it.close()
    _assert_settled(base)


@pytest.mark.parametrize("kind", ["async", "device_prefetch"])
def test_reset_mid_epoch_then_close_returns_threads_to_baseline(kind):
    """``reset()`` mid-epoch joins the old producer (parked on a full
    queue) before it starts a new one: one producer at a time, and none
    after ``close()``; the new epoch yields every batch from the
    start."""
    many = [_tiny_batch(i) for i in range(16)]
    base = _baseline()
    if kind == "async":
        it = AsyncDataSetIterator(ListDataSetIterator(many), queue_size=2)
    else:
        it = DevicePrefetchIterator(ListDataSetIterator(many),
                                    device="cpu")
    assert float(it.next().features[0, 0]) == 0.0
    it.next()
    it.reset()
    extra = [t for t in threading.enumerate() if t.ident not in base]
    assert len(extra) <= 1
    firsts = [float(it.next().features[0, 0]) for _ in range(3)]
    assert firsts == [0.0, 1.0, 2.0]
    it.close()
    _assert_settled(base)
    assert not it.has_next()


def test_preprocessor_applies_on_direct_next():
    x = np.full((4, 2), 200.0, np.float32)
    it = ListDataSetIterator([DataSet(x, np.eye(4, 2, dtype=np.float32))])
    it.set_pre_processor(lambda ds: DataSet(ds.features / 100.0, ds.labels))
    it.reset()
    assert it.next().features.max() < 100.0


def test_lockcheck_is_clean_on_the_ports_datasets():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "lockcheck.py"),
         str(ROOT / "deeplearning4j_tpu_torch" / "datasets")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
