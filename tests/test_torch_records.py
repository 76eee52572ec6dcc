"""The port's record readers and their iterators (``datasets/records.py``),
the dataset fetchers (``datasets/fetchers.py``), the native IDX / CSV
parsers (``datasets/native_io.py`` over ``native_loader.py``'s build of
``native/dataloader.cc``) and the cloud readers (``datasets/cloud_io.py``)
against the JAX package's, on the CPU:

- a counterpart of every case of ``tests/test_records_fetchers.py``,
  ``tests/test_native_io.py`` and ``tests/test_cloud_io.py`` (offline:
  a ``MockClient`` store registered for gs:// and s3://);
- every reader and iterator gives the JAX package's ``DataSet``s byte for
  byte on the same inputs; the fetchers' synthetic data equals the JAX
  package's at the same seed; the port's native and Python IDX / CSV
  parsers are byte-identical to the JAX package's on the same files;
- the loader builds into ``deeplearning4j_tpu_torch/_build/`` only and
  reports its build to the compile watchers.
"""

import gzip
import struct
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import cloud_io as jcloud
from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.datasets import native_io as jnative
from deeplearning4j_tpu.datasets import pipeline as jpipe
from deeplearning4j_tpu.datasets import records as jrec

from deeplearning4j_tpu_torch import native_loader
from deeplearning4j_tpu_torch.datasets import cloud_io, native_io
from deeplearning4j_tpu_torch.datasets.cloud_io import (
    BucketIterator, HttpRangeClient, S3Downloader,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (
    CifarDataSetIterator, CurvesDataSetIterator, LFWDataSetIterator,
    load_cifar10, load_curves, load_lfw,
)
from deeplearning4j_tpu_torch.datasets.pipeline import (
    _idx_read_python, read_idx,
)
from deeplearning4j_tpu_torch.datasets.records import (
    CollectionRecordReader, CollectionSequenceRecordReader, CSVRecordReader,
    CSVSequenceRecordReader, ImageRecordReader, LineRecordReader,
    RecordReaderDataSetIterator, RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)

IRIS_LINES = [
    "5.1,3.5,1.4,0.2,0",
    "4.9,3.0,1.4,0.2,0",
    "6.2,2.9,4.3,1.3,1",
    "5.9,3.0,5.1,1.8,2",
    "6.3,2.8,5.1,1.5,2",
]


def _arrays(ds):
    """A DataSet's or MultiDataSet's arrays as bytes (None kept)."""
    if hasattr(ds, "features_masks"):
        arrays = [*ds.features, *ds.labels]
    else:
        arrays = [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
    return [None if a is None else (np.asarray(a).dtype.str,
                                    np.asarray(a).shape,
                                    np.asarray(a).tobytes()) for a in arrays]


def _all(it) -> list:
    out = []
    it.reset()
    while it.has_next():
        out.append(_arrays(it.next()))
    return out


# ------------------------------------------------ records (DataVec bridge)

def test_csv_reader_classification():
    rr = CSVRecordReader(IRIS_LINES)
    it = RecordReaderDataSetIterator(rr, batch_size=3, label_index=4,
                                     num_possible_labels=3)
    b1 = it.next()
    assert b1.features.shape == (3, 4)
    assert b1.labels.shape == (3, 3)
    np.testing.assert_array_equal(b1.labels[0], [1, 0, 0])
    b2 = it.next()
    assert b2.features.shape == (2, 4)
    assert not it.has_next()
    it.reset()
    assert it.has_next()
    np.testing.assert_allclose(it.next().features[0], [5.1, 3.5, 1.4, 0.2])


def test_csv_reader_regression_range():
    rr = CSVRecordReader(IRIS_LINES)
    it = RecordReaderDataSetIterator(rr, batch_size=5, label_index=2,
                                     regression=True, label_index_to=3)
    b = it.next()
    assert b.features.shape == (5, 3)
    assert b.labels.shape == (5, 2)
    np.testing.assert_allclose(b.labels[0], [1.4, 0.2])
    np.testing.assert_allclose(b.features[0], [5.1, 3.5, 0.0])


def test_default_last_column_label():
    rr = CollectionRecordReader([[0.0, 1.0, 2.0, 1], [3.0, 4.0, 5.0, 0]])
    b = RecordReaderDataSetIterator(rr, 2, num_possible_labels=2).next()
    assert b.features.shape == (2, 3)
    np.testing.assert_array_equal(b.labels, [[0, 1], [1, 0]])


def test_classification_requires_num_labels():
    it = RecordReaderDataSetIterator(CollectionRecordReader([[1.0, 0]]), 1)
    with pytest.raises(ValueError):
        it.next()


def test_line_reader():
    assert [r for r in LineRecordReader(["hello", "world"])] \
        == [["hello"], ["world"]]


SEQS = [[[0.1, 0.2, 0], [0.3, 0.4, 1], [0.5, 0.6, 2]], [[0.7, 0.8, 1]]]


def test_sequence_iterator_single_reader_padding_and_masks():
    it = SequenceRecordReaderDataSetIterator(
        CollectionSequenceRecordReader(SEQS), batch_size=2,
        num_possible_labels=3)
    b = it.next()
    assert b.features.shape == (2, 3, 2)
    assert b.labels.shape == (2, 3, 3)
    np.testing.assert_array_equal(b.features_mask, [[1, 1, 1], [1, 0, 0]])
    np.testing.assert_array_equal(b.labels[0, 2], [0, 0, 1])
    np.testing.assert_array_equal(b.features[1, 1:], np.zeros((2, 2)))


def test_sequence_iterator_align_end():
    it = SequenceRecordReaderDataSetIterator(
        CollectionSequenceRecordReader([[[1.0], [2.0], [3.0]]]), 1,
        num_possible_labels=3,
        labels_reader=CollectionSequenceRecordReader([[[2]]]),
        alignment="align_end")
    b = it.next()
    np.testing.assert_array_equal(b.labels_mask, [[0, 0, 1]])
    np.testing.assert_array_equal(b.labels[0, 2], [0, 0, 1])
    np.testing.assert_array_equal(b.features_mask, [[1, 1, 1]])


def test_csv_sequence_reader(tmp_path):
    p = tmp_path / "seqs.csv"
    p.write_text("1,10\n2,20\n\n3,30\n")
    sr = CSVSequenceRecordReader(p)
    assert sr.next_sequence() == [[1.0, 10.0], [2.0, 20.0]]
    assert sr.next_sequence() == [[3.0, 30.0]]
    assert not sr.has_next()


MULTI_ROWS = [[0.1, 0.2, 0.3, 1], [0.4, 0.5, 0.6, 0], [0.7, 0.8, 0.9, 2]]


def _multi(mod):
    return (mod.RecordReaderMultiDataSetIterator.Builder(batch_size=2)
            .add_reader("r", mod.CollectionRecordReader(MULTI_ROWS))
            .add_input("r", 0, 1).add_input("r", 2, 2)
            .add_output_one_hot("r", 3, 3).build())


def test_multi_dataset_iterator():
    from deeplearning4j_tpu_torch.datasets import records
    it = _multi(records)
    m = it.next()
    assert len(m.features) == 2 and len(m.labels) == 1
    assert m.features[0].shape == (2, 2)
    assert m.features[1].shape == (2, 1)
    np.testing.assert_array_equal(m.labels[0], [[0, 1, 0], [1, 0, 0]])
    assert it.has_next()
    it.next()
    assert not it.has_next()


def test_multi_builder_unknown_reader():
    with pytest.raises(ValueError):
        RecordReaderMultiDataSetIterator.Builder(2).add_input("nope").build()


def _image_tree(tmp_path):
    for cls in ("cat", "dog"):
        d = tmp_path / cls
        d.mkdir(parents=True)
        for i in range(2):
            np.save(d / f"{i}.npy",
                    np.full((4, 4, 3), 10.0 * (cls == "dog") + i, np.float32))
    return tmp_path


def test_image_record_reader_npy(tmp_path):
    rr = ImageRecordReader(_image_tree(tmp_path), 4, 4, 3)
    assert rr.labels == ["cat", "dog"]
    b = RecordReaderDataSetIterator(rr, batch_size=4).next()
    assert b.features.shape == (4, 4, 4, 3)
    assert b.labels.shape == (4, 2)
    assert b.labels.sum() == 4


def test_image_record_reader_png_needs_pil(tmp_path, monkeypatch):
    """PNG/JPEG go through PIL, imported lazily: without it the reader
    names the ``.npy`` way out (the card's machine has no PIL)."""
    import builtins
    d = tmp_path / "x"
    d.mkdir()
    (d / "a.png").write_bytes(b"not really a png")
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("no PIL here")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    rr = ImageRecordReader(tmp_path, 4, 4, 3)
    with pytest.raises(RuntimeError, match="Use .npy"):
        rr.next_record()


def test_cifar_iterator():
    it = CifarDataSetIterator(batch_size=32, num_examples=64)
    b = it.next()
    assert b.features.shape == (32, 32, 32, 3)
    assert b.labels.shape == (32, 10)
    assert it.total_examples() == 64
    assert isinstance(it.is_synthetic, bool)


def test_lfw_iterator():
    it = LFWDataSetIterator(batch_size=16, num_examples=32, height=32,
                            width=32, classes=5)
    b = it.next()
    assert b.features.shape == (16, 32, 32, 3)
    assert b.labels.shape[1] >= 2


def test_curves_iterator():
    it = CurvesDataSetIterator(batch_size=10, num_examples=20)
    b = it.next()
    assert b.features.shape == (10, 784)
    np.testing.assert_array_equal(b.features, b.labels)
    assert b.features.max() == 1.0


def test_csv_sequence_header_skip_once(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("h1,h2\n1,2\n3,4\n\n5,6\n7,8\n")
    sr = CSVSequenceRecordReader(p, skip_lines=1)
    assert sr.next_sequence() == [[1.0, 2.0], [3.0, 4.0]]
    assert sr.next_sequence() == [[5.0, 6.0], [7.0, 8.0]]


def test_image_reader_grayscale_expand(tmp_path):
    d = tmp_path / "x"
    d.mkdir()
    np.save(d / "g.npy", np.ones((4, 4), np.float32))
    assert len(ImageRecordReader(tmp_path, 4, 4, 3).next_record()) \
        == 4 * 4 * 3 + 1


def test_sequence_iterator_validates_num_labels():
    with pytest.raises(ValueError, match="num_possible_labels"):
        SequenceRecordReaderDataSetIterator(
            CollectionSequenceRecordReader([[[1.0, 0]]]), 1)


def test_sequence_two_reader_exhaustion():
    it = SequenceRecordReaderDataSetIterator(
        CollectionSequenceRecordReader([[[1.0]], [[2.0]], [[3.0]]]), 1,
        num_possible_labels=2,
        labels_reader=CollectionSequenceRecordReader([[[0]], [[1]]]))
    it.next()
    it.next()
    assert not it.has_next()


def test_device_prefetch_iterator_over_a_record_iterator():
    """The JAX file's prefetch case, over a record reader's batches: the
    float arrays cast, masks not, a second epoch."""
    from deeplearning4j_tpu_torch.datasets import DevicePrefetchIterator
    it = DevicePrefetchIterator(
        SequenceRecordReaderDataSetIterator(
            CollectionSequenceRecordReader(SEQS), batch_size=1,
            num_possible_labels=3), dtype="bfloat16", device="cpu")
    got = list(it)
    assert len(got) == 2
    assert got[0].features.dtype == got[0].labels.dtype == torch.bfloat16
    assert got[0].features_mask.dtype == torch.float32
    assert len(list(it)) == 2
    it.close()


def test_native_csv_reader_numeric(tmp_path):
    p = tmp_path / "num.csv"
    p.write_text("1.5,2,3\n4,5.25,6\n7,8,9.125\n")
    rr = CSVRecordReader(str(p))
    rows = []
    while rr.has_next():
        rows.append(rr.next_record())
    assert rows == [[1.5, 2.0, 3.0], [4.0, 5.25, 6.0], [7.0, 8.0, 9.125]]
    assert native_io.available() and rr._rows is not None


def test_native_csv_reader_string_fallback(tmp_path):
    p = tmp_path / "iris.csv"
    p.write_text("5.1,3.5,setosa\n6.2,2.9,versicolor\n")
    rr = CSVRecordReader(str(p))
    assert rr._rows is None
    assert rr.next_record() == [5.1, 3.5, "setosa"]
    assert rr.next_record() == [6.2, 2.9, "versicolor"]


def test_native_idx_reader_matches_python(tmp_path):
    from deeplearning4j_tpu_torch.datasets.mnist import _read_idx
    data = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    p = tmp_path / "t.idx"
    _write_idx(p, data)
    np.testing.assert_array_equal(_read_idx(p), data)
    native = native_io.idx_read(p, scale=1.0 / 255)
    np.testing.assert_allclose(native, data / 255.0, rtol=1e-6)


# --------------------------------------------- parity with the JAX package

def _parity_cases(tmp_path):
    """(port iterator, JAX iterator) pairs over the same inputs."""
    from deeplearning4j_tpu_torch.datasets import records
    r = np.random.default_rng(4)
    num = tmp_path / "num.csv"
    num.write_text("\n".join(",".join(repr(float(v)) for v in row)
                             + f",{int(row[0] > 0)}"
                             for row in r.normal(size=(7, 3))) + "\n")
    seqf = tmp_path / "seq.csv"
    seqf.write_text("h\n1,0\n2,1\n\n3,1\n4,0\n5,1\n")
    img = _image_tree(tmp_path / "img")
    return {
        "csv_lines": lambda m: m.RecordReaderDataSetIterator(
            m.CSVRecordReader(IRIS_LINES), 2, label_index=4,
            num_possible_labels=3),
        "csv_native_file": lambda m: m.RecordReaderDataSetIterator(
            m.CSVRecordReader(str(num)), 3, num_possible_labels=2),
        "regression": lambda m: m.RecordReaderDataSetIterator(
            m.CSVRecordReader(IRIS_LINES), 5, label_index=2,
            regression=True, label_index_to=3),
        "collection": lambda m: m.RecordReaderDataSetIterator(
            m.CollectionRecordReader([[0.0, 1.0, 2.0, 1],
                                      [3.0, 4.0, 5.0, 0]]), 1,
            num_possible_labels=2),
        "sequence": lambda m: m.SequenceRecordReaderDataSetIterator(
            m.CollectionSequenceRecordReader(SEQS), 2,
            num_possible_labels=3),
        "sequence_align_end": lambda m: m.SequenceRecordReaderDataSetIterator(
            m.CSVSequenceRecordReader(seqf, skip_lines=1), 2,
            regression=True,
            labels_reader=m.CSVSequenceRecordReader(seqf, skip_lines=1),
            alignment="align_end"),
        "image": lambda m: m.RecordReaderDataSetIterator(
            m.ImageRecordReader(img, 4, 4, 3), 3),
        "multi": _multi,
    }, records


@pytest.mark.parametrize("name", ["csv_lines", "csv_native_file",
                                  "regression", "collection", "sequence",
                                  "sequence_align_end", "image", "multi"])
def test_readers_and_iterators_give_the_jax_packages_datasets(tmp_path,
                                                              name):
    cases, records = _parity_cases(tmp_path)
    got, want = _all(cases[name](records)), _all(cases[name](jrec))
    assert len(got) == len(want) > 0
    assert got == want


def test_line_and_sequence_records_equal_the_jax_packages(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("a,1\nb,2\n\nc,3\n")
    assert list(LineRecordReader(p)) == list(jrec.LineRecordReader(p))
    port, jax_ = CSVSequenceRecordReader(p), jrec.CSVSequenceRecordReader(p)
    while jax_.has_next():
        assert port.next_sequence() == jax_.next_sequence()
    assert not port.has_next()


@pytest.mark.parametrize("name,port,jax_", [
    ("cifar", lambda: load_cifar10(num_examples=64),
     lambda: jfetch.load_cifar10(num_examples=64)),
    ("cifar_test", lambda: load_cifar10(False, 32, seed=3),
     lambda: jfetch.load_cifar10(False, 32, seed=3)),
    ("lfw", lambda: load_lfw(32, 16, 16, 5), lambda: jfetch.load_lfw(
        32, 16, 16, 5)),
    ("curves", lambda: load_curves(20, seed=4),
     lambda: jfetch.load_curves(20, seed=4)),
])
def test_fetchers_synthetic_data_equals_the_jax_packages(name, port, jax_):
    got, want = port(), jax_()
    assert got[2] is want[2]
    for a, b in zip(got[:2], want[:2]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_fetcher_iterators_equal_the_jax_packages():
    for port, jax_ in ((CifarDataSetIterator(16, 32),
                        jfetch.CifarDataSetIterator(16, 32)),
                       (LFWDataSetIterator(8, 16, 16, 16, 4),
                        jfetch.LFWDataSetIterator(8, 16, 16, 16, 4)),
                       (CurvesDataSetIterator(5, 10),
                        jfetch.CurvesDataSetIterator(5, 10))):
        assert _all(port) == _all(jax_)


# ----------------------------------------------------------- native IO

def _write_idx(path, arr):
    arr = np.asarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 0x08, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


@pytest.fixture
def mnist_shaped(tmp_path, rng):
    imgs = rng.integers(0, 256, (7, 28, 28)).astype(np.uint8)
    imgs[0, 0, 0], imgs[0, 0, 1] = 0, 255
    labels = rng.integers(0, 10, (7,)).astype(np.uint8)
    _write_idx(tmp_path / "images.idx", imgs)
    _write_idx(tmp_path / "labels.idx", labels)
    return tmp_path, imgs, labels


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_checked", True)
    assert not native_io.available()


def test_the_loader_builds_into_the_ports_build_directory():
    from deeplearning4j_tpu_torch.profiling.watchers import COMPILE_KINDS
    assert native_io.available()
    path = native_loader.library_path("dataloader")
    assert path.exists() and path.parent == native_loader.BUILD_DIR
    assert path.parent.name == "_build" \
        and path.parent.parent.name == "deeplearning4j_tpu_torch"
    assert "gxx" in COMPILE_KINDS
    assert native_loader.load_native("nonexistent") is None


def test_a_build_is_reported_to_the_compile_watchers(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.profiling.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.profiling.tracer import Tracer
    from deeplearning4j_tpu_torch.profiling.watchers import CompileWatcher
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
    reg = MetricsRegistry()
    w = CompileWatcher(registry=reg, tracer=Tracer()).install()
    try:
        path = native_loader.build_native("dataloader")
        again = native_loader.build_native("dataloader")
    finally:
        w.uninstall()
    assert path == again and path.parent == tmp_path / "_build"
    assert reg.counter("native_build_total").value == 1   # built once
    assert w.counts() == {"nvcc": 0, "cuda_graph": 0, "gxx": 1}


def test_a_build_blocks_no_caller_of_a_loaded_library(monkeypatch):
    """``load_native`` builds outside its lock: while one thread's build
    of a library runs, a caller of a library already loaded returns at
    once, and the build's outcome is kept once it ends."""
    import threading
    import time
    native_loader.load_native("dataloader")        # loaded, cached
    started, release = threading.Event(), threading.Event()

    def slow_build(name):
        started.set()
        release.wait(30)
        return None
    monkeypatch.setattr(native_loader, "build_native", slow_build)
    slow = threading.Thread(target=native_loader.load_native,
                            args=("slow",))
    slow.start()
    try:
        assert started.wait(30)
        t0 = time.perf_counter()
        assert native_loader.load_native("dataloader") is not None
        assert time.perf_counter() - t0 < 1.0
    finally:
        release.set()
        slow.join(30)
    assert native_loader._cache.pop("slow") is None


@pytest.mark.parametrize("scale", [1.0, 1.0 / 255.0])
def test_idx_native_matches_python_bitwise(mnist_shaped, scale):
    d, imgs, labels = mnist_shaped
    for name in ("images.idx", "labels.idx"):
        fast = native_io.idx_read(d / name, scale=scale)
        slow = _idx_read_python(d / name, scale)
        assert fast is not None
        assert fast.dtype == slow.dtype == np.float32
        assert fast.shape == slow.shape
        assert fast.tobytes() == slow.tobytes()
        # and byte-identical to the JAX package's two paths
        assert fast.tobytes() == jpipe._idx_read_python(d / name,
                                                        scale).tobytes()
        if jnative.available():
            assert fast.tobytes() == jnative.idx_read(d / name,
                                                      scale).tobytes()


def test_idx_python_parses_the_fixture_faithfully(mnist_shaped):
    d, imgs, labels = mnist_shaped
    got = _idx_read_python(d / "images.idx", 1.0 / 255.0)
    want = (imgs.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        _idx_read_python(d / "labels.idx", 1.0), labels.astype(np.float32))


def test_read_idx_raw_u8_mode_returns_the_exact_bytes(mnist_shaped):
    d, imgs, labels = mnist_shaped
    got = read_idx(d / "images.idx", scale=None)
    assert got.dtype == np.uint8
    assert got.tobytes() == imgs.tobytes()
    np.testing.assert_array_equal(read_idx(d / "labels.idx", scale=None),
                                  labels)
    bad = d / "bad.idx"
    bad.write_bytes(b"\x00\x00\x0d\x01" + struct.pack(">1I", 2) + b"\x00" * 8)
    with pytest.raises(ValueError, match="unsigned-byte"):
        read_idx(bad, scale=None)


def test_mnist_read_idx_delegates_to_the_shared_parser(mnist_shaped,
                                                       monkeypatch):
    from deeplearning4j_tpu_torch.datasets import mnist, pipeline
    d, imgs, labels = mnist_shaped
    calls = []
    real = pipeline.read_idx

    def spy(path, scale=1.0):
        calls.append(scale)
        return real(path, scale)
    monkeypatch.setattr(pipeline, "read_idx", spy)
    out = mnist._read_idx(d / "images.idx")
    assert out.dtype == np.uint8 and out.tobytes() == imgs.tobytes()
    assert calls == [None]


def test_csv_native_matches_python_float_parse(tmp_path, rng):
    rows = rng.normal(size=(12, 5))
    lines = "\n".join(",".join(repr(float(v)) for v in row) for row in rows)
    p = tmp_path / "data.csv"
    p.write_text(lines + "\n")
    parsed = native_io.csv_read(p)
    assert parsed is not None
    mat, ncols = parsed
    assert (mat.shape, ncols) == ((12, 5), 5)
    want = np.array([[float(tok) for tok in line.split(",")]
                     for line in lines.splitlines()], dtype=np.float64)
    assert mat.tobytes() == want.tobytes()
    if jnative.available():
        assert mat.tobytes() == jnative.csv_read(p)[0].tobytes()


def iter_records(rr):
    while rr.has_next():
        yield rr.next_record()


def test_csv_record_reader_same_records_with_and_without_native(
        tmp_path, rng, monkeypatch):
    rows = rng.normal(size=(6, 4))
    p = tmp_path / "r.csv"
    p.write_text("\n".join(",".join(repr(float(v)) for v in row)
                           for row in rows) + "\n")
    fast = list(iter_records(CSVRecordReader(str(p))))
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_checked", True)
    slow = list(iter_records(CSVRecordReader(str(p))))
    assert len(fast) == len(slow) == 6
    for a, b in zip(fast, slow):
        assert np.asarray(a, dtype=np.float64).tobytes() \
            == np.asarray(b, dtype=np.float64).tobytes()


def test_idx_read_falls_back_when_native_unavailable(mnist_shaped,
                                                     no_native):
    d, imgs, _ = mnist_shaped
    assert native_io.idx_read(d / "images.idx") is None
    got = read_idx(d / "images.idx", scale=1.0 / 255.0)
    want = (imgs.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    assert got.tobytes() == want.tobytes()


def test_csv_read_none_when_native_unavailable(tmp_path, no_native):
    p = tmp_path / "x.csv"
    p.write_text("1,2\n3,4\n")
    assert native_io.csv_read(p) is None
    assert list(iter_records(CSVRecordReader(str(p)))) \
        == [[1.0, 2.0], [3.0, 4.0]]


def test_gzip_idx_takes_the_python_path_everywhere(tmp_path, rng):
    imgs = rng.integers(0, 256, (3, 4, 4)).astype(np.uint8)
    plain = tmp_path / "g.idx"
    _write_idx(plain, imgs)
    gz = tmp_path / "g.idx.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    assert native_io.idx_read(gz) is None
    assert read_idx(gz, scale=1.0 / 255.0).tobytes() \
        == read_idx(plain, scale=1.0 / 255.0).tobytes()


def test_non_u8_idx_is_rejected_not_shredded(tmp_path):
    path = tmp_path / "f32.idx"
    payload = np.arange(6, dtype=">f4")
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 0x0D, 1))
        f.write(struct.pack(">I", payload.size))
        f.write(payload.tobytes())
    with pytest.raises(ValueError, match="unsigned-byte IDX"):
        read_idx(path)


def test_idx_pairs_decode_into_load_mnists_batches(tmp_path, monkeypatch):
    """MNIST-shaped IDX files written from the synthetic MNIST: ``IdxPair``
    sources through the pipeline give ``load_mnist``'s arrays on those
    files (``_find`` reads ``$MNIST_DIR``)."""
    from deeplearning4j_tpu_torch.datasets import mnist
    from deeplearning4j_tpu_torch.datasets.pipeline import (
        IdxPair, StreamingInputPipeline,
    )
    imgs, labels = mnist._synthetic_mnist(40, seed=5)
    u8 = np.round(imgs * 255).astype(np.uint8)
    _write_idx(tmp_path / "train-images-idx3-ubyte", u8)
    _write_idx(tmp_path / "train-labels-idx1-ubyte", labels)
    monkeypatch.setattr(mnist, "_SEARCH_PATHS", [tmp_path])
    x, y, synthetic = mnist.load_mnist(True, 40)
    assert not synthetic
    pair = IdxPair(str(tmp_path / "train-images-idx3-ubyte"),
                   str(tmp_path / "train-labels-idx1-ubyte"))
    pipe = StreamingInputPipeline([pair], batch_size=16, num_shards=1,
                                  shard_index=0, place=False)
    got = list(pipe)
    pipe.close()
    feats = np.concatenate([b.features for b in got])
    labs = np.concatenate([b.labels for b in got])
    np.testing.assert_array_equal(labs, y)
    # load_mnist divides by 255 in f32; the pipeline multiplies by 1/255 in
    # f64 (the C parser's arithmetic): at most one f32 ulp apart
    np.testing.assert_allclose(feats, x, rtol=0, atol=6e-8)


# ------------------------------------------------------------- cloud IO

class MockClient(cloud_io.CloudStorageClient):
    def __init__(self, objects):
        self.objects = dict(objects)
        self.reads = []
        self._lock = threading.Lock()

    def read(self, url, start=None, length=None):
        with self._lock:
            self.reads.append((url, start, length))
        data = self.objects[url]
        if start is not None:
            end = None if length is None else start + length
            return data[start:end]
        return data

    def list(self, url):
        return sorted(k for k in self.objects if k.startswith(url))


@pytest.fixture()
def store(monkeypatch):
    csv = b"5.1,3.5,1.4,0.2,0\n4.9,3.0,1.4,0.2,0\n6.3,3.3,6.0,2.5,2\n"
    client = MockClient({
        "gs://data/iris.csv": csv,
        "gs://data/lines.txt": b"alpha\nbeta\ngamma\n",
        "gs://data/shard/a.bin": b"AAAA",
        "gs://data/shard/b.bin": b"BBBB",
    })
    for clients in (cloud_io._CLIENTS, jcloud._CLIENTS):
        monkeypatch.setitem(clients, "gs", client)
        monkeypatch.setitem(clients, "s3", client)
    return client


def test_csv_record_reader_from_cloud_url(store):
    it = RecordReaderDataSetIterator(CSVRecordReader("gs://data/iris.csv"),
                                     batch_size=3, label_index=4,
                                     num_possible_labels=3)
    ds = next(iter(it))
    assert ds.features.shape == (3, 4)
    np.testing.assert_allclose(ds.features[0], [5.1, 3.5, 1.4, 0.2])
    assert ds.labels.argmax(1).tolist() == [0, 0, 2]
    want = jrec.RecordReaderDataSetIterator(
        jrec.CSVRecordReader("gs://data/iris.csv"), batch_size=3,
        label_index=4, num_possible_labels=3).next()
    assert _arrays(ds) == _arrays(want)


def test_line_record_reader_from_cloud_url(store):
    rr = LineRecordReader("gs://data/lines.txt")
    out = []
    while rr.has_next():
        out.extend(rr.next_record())
    assert out == ["alpha", "beta", "gamma"]


def test_range_read(store):
    assert cloud_io.read_url("gs://data/lines.txt", start=6, length=4) \
        == b"beta"
    assert store.reads[-1] == ("gs://data/lines.txt", 6, 4)


def test_bucket_iterator_and_downloader(store, tmp_path):
    it = BucketIterator("gs://data/shard/")
    assert it.keys() == ["gs://data/shard/a.bin", "gs://data/shard/b.bin"]
    assert list(it) == [b"AAAA", b"BBBB"]
    p = S3Downloader().download("gs://data/shard/a.bin",
                                str(tmp_path / "a.bin"))
    assert p.read_bytes() == b"AAAA"


def test_fetch_to_cache_caches(store, tmp_path):
    p1 = cloud_io.fetch_to_cache("gs://data/iris.csv", cache_dir=tmp_path)
    n_reads = len(store.reads)
    p2 = cloud_io.fetch_to_cache("gs://data/iris.csv", cache_dir=tmp_path)
    assert p1 == p2 and p1.exists()
    assert len(store.reads) == n_reads
    # the JAX package's fetcher finds the same cache entry
    assert jcloud.fetch_to_cache("gs://data/iris.csv",
                                 cache_dir=tmp_path) == p1
    assert len(store.reads) == n_reads
    with pytest.raises(ValueError, match="escapes"):
        cloud_io.fetch_to_cache("gs://data/../../x", cache_dir=tmp_path)


def test_http_range_client_url_mapping():
    c, j = HttpRangeClient(), jcloud.HttpRangeClient()
    for url in ("gs://bkt/path/f.bin", "s3://bkt/path/f.bin", "https://x/y",
                "gs://bkt/a b#c/ü.bin"):
        assert c._endpoint(url) == j._endpoint(url)
    assert c._endpoint("gs://bkt/path/f.bin") \
        == "https://storage.googleapis.com/bkt/path/f.bin"
    assert c._endpoint("s3://bkt/path/f.bin") \
        == "https://bkt.s3.amazonaws.com/path/f.bin"
    assert c._endpoint("https://x/y") == "https://x/y"
    with pytest.raises(ValueError):
        c._endpoint("ftp://x/y")


def test_unregistered_scheme_raises():
    with pytest.raises(ValueError, match="register_client"):
        cloud_io.read_url("weird://bucket/key")
    cloud_io.register_client("weird", MockClient({"weird://b/k": b"x"}))
    try:
        assert cloud_io.read_url("weird://b/k") == b"x"
        assert isinstance(cloud_io.client_for("gs://z/y"),
                          cloud_io.CloudStorageClient)
    finally:
        cloud_io._CLIENTS.pop("weird")


def _idx_bytes(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.uint8)
    header = struct.pack(">BBBB", 0, 0, 0x08, arr.ndim)
    header += b"".join(struct.pack(">I", d) for d in arr.shape)
    return header + arr.tobytes()


def test_mnist_fetcher_from_cloud_url(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (32, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 32).astype(np.uint8)
    client = MockClient({
        "gs://mybucket/mnist/train-images-idx3-ubyte": _idx_bytes(imgs),
        "gs://mybucket/mnist/train-labels-idx1-ubyte": _idx_bytes(labels),
    })
    monkeypatch.setitem(cloud_io._CLIENTS, "gs", client)
    monkeypatch.setenv("DL4J_TPU_DATA_URL", "gs://mybucket/mnist")
    monkeypatch.setenv("DL4J_TPU_CACHE", str(tmp_path))
    from deeplearning4j_tpu_torch.datasets import mnist
    monkeypatch.setattr(mnist, "_SEARCH_PATHS", [tmp_path / "nope"])
    got_imgs, got_labels, synthetic = mnist.load_mnist(train=True,
                                                       num_examples=32)
    assert not synthetic
    assert got_imgs.shape == (32, 28, 28)
    np.testing.assert_allclose(got_imgs, imgs.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got_labels, labels)


def test_fetch_to_cache_truncate_mid_fetch_never_lands_torn(store,
                                                            tmp_path):
    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule, KilledByFault,
    )
    url = "gs://data/shard/a.bin"
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", mode="crash")]))
    try:
        with pytest.raises(KilledByFault):
            cloud_io.fetch_to_cache(url, cache_dir=tmp_path)
    finally:
        faultinject.clear()
    finals = [p for p in tmp_path.rglob("*")
              if p.is_file() and not p.name.endswith(".tmp")]
    assert finals == []
    assert cloud_io.fetch_to_cache(url, cache_dir=tmp_path).read_bytes() \
        == b"AAAA"


def test_concurrent_fetch_to_cache_downloads_once_and_whole(store,
                                                            tmp_path):
    results, errors = [], []

    def fetch():
        try:
            results.append(cloud_io.fetch_to_cache("gs://data/iris.csv",
                                                   cache_dir=tmp_path))
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=fetch) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(set(results)) == 1
    assert results[0].read_bytes() == store.objects["gs://data/iris.csv"]
    assert len(store.reads) == 1
    assert not list(tmp_path.rglob("*.tmp"))
