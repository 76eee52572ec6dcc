"""The port's plain-Python HDF5 reader and writer
(``deeplearning4j_tpu_torch/keras/hdf5.py``) against libhdf5, through the
JAX package's ``Hdf5Archive`` (its native shim), and against h5py.

- every committed Keras fixture (``tests/fixtures/keras_*.h5``, written by
  Keras through h5py): the same children at every level in the same
  order, every attribute the same, every dataset bit for bit;
- files h5py writes here: a group of 120 children (a B-tree over several
  symbol-table nodes), variable-length strings (ASCII and UTF-8, scalar
  and arrays, in global heaps), fixed-length strings (NUL-terminated and
  NUL-padded), float64, int64, int32 and scalar datasets, a compact
  dataset, a continuation of the object header;
- the port writer's files (nested groups, a group of 300 children: a
  two-level B-tree) read back unchanged through the JAX reader and h5py;
- what the reader does not cover raises naming the feature: a
  gzip-chunked dataset, chunked storage, a ``libver="latest"`` file;
- where libhdf5's reader as the JAX package binds it gives no answer or a
  short one (ROADMAP C18): a UTF-8 string attribute may raise there (as
  the conversions the process made before decide), and a NUL-padded
  fixed-length string as wide as its type loses its last character; the
  port reads both as h5py does.

Floats are compared bit for bit (``tobytes``): the reader converts to
float32 as ``H5Dread`` to ``H5T_NATIVE_FLOAT`` does.
"""

from pathlib import Path

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu.keras.hdf5 import Hdf5Archive as JArchive
from deeplearning4j_tpu_torch.keras.hdf5 import (
    Hdf5Archive, Hdf5Unsupported, Hdf5Writer,
)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
KERAS_FILES = sorted(p.name for p in FIXTURES.glob("keras_*.h5"))


def _tree(archive, path="/"):
    """[(kind, path)] of every object under ``path``, depth first."""
    out = []
    for kind, name in archive.list_children(path):
        child = f"{path.rstrip('/')}/{name}"
        out.append((kind, child))
        if kind == "g":
            out += _tree(archive, child)
    return out


def _h5py_string(value):
    """An attribute as h5py reads it, as a str or a list of str."""
    def one(v):
        return v.decode() if isinstance(v, bytes) else str(v)
    if isinstance(value, np.ndarray) and value.ndim:
        return [one(v) for v in value]
    return one(value.item() if isinstance(value, np.ndarray) else value)


def _same_as_libhdf5_and_h5py(path: Path):
    """The port's reader against the JAX one (libhdf5) and h5py on one
    file; returns the attributes libhdf5 could not read (C18)."""
    port, jax_reader = Hdf5Archive(str(path)), JArchive(str(path))
    tree = _tree(port)
    assert tree == _tree(jax_reader)
    refused = []
    with h5py.File(path, "r") as h:
        for kind, obj in [("g", "/")] + tree:
            if kind == "d":
                got = port.read_dataset(obj)
                want = jax_reader.read_dataset(obj)
                assert got.dtype == want.dtype == np.float32
                assert got.shape == want.shape == h[obj].shape
                assert got.tobytes() == want.tobytes(), obj
                np.testing.assert_array_equal(
                    got, np.asarray(h[obj][()]).astype(np.float32))
            for attr in h[obj].attrs:
                value = h[obj].attrs[attr]
                got = port.read_attribute_as_string_list(attr, obj)
                if isinstance(value, np.ndarray) and value.size == 0:
                    assert got == []
                    continue
                want = _h5py_string(value)
                listed = want if isinstance(want, list) else [want]
                # a lone empty string lists as [], as libhdf5's reader
                # carries the list through one newline-joined buffer
                assert got == ([] if listed == [""] else listed)
                try:
                    jwant = jax_reader.read_attribute_as_string_list(attr,
                                                                     obj)
                except OSError:
                    refused.append((obj, attr))
                    continue
                assert got == jwant, (obj, attr)
                if not isinstance(want, list):
                    assert port.read_attribute_as_string(attr, obj) == \
                        jax_reader.read_attribute_as_string(attr, obj) == want
    return refused


@pytest.mark.parametrize("name", KERAS_FILES)
def test_reader_agrees_with_libhdf5_on_the_keras_fixtures(name):
    refused = _same_as_libhdf5_and_h5py(FIXTURES / name)
    # at most the UTF-8 root attributes (C18); the Keras import reads none
    assert set(refused) <= {("/", "backend"), ("/", "keras_version")}
    port = Hdf5Archive(str(FIXTURES / name))
    assert port.read_attribute_as_string("model_config") is not None
    assert port.read_attribute_as_string("missing") is None
    assert port.read_attribute_as_string_list("missing", "/nope") is None
    assert port.list_children("/nope") == []


def _h5py_file(path: Path):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as h:
        big = h.create_group("big")
        for i in range(120):
            big.create_dataset(f"w{i:03d}", data=rng.normal(size=(3,)))
        big.attrs["names"] = [f"w{i:03d}" for i in range(120)]
        h.attrs["ascii"] = np.array(b"plain ascii", dtype=h5py.string_dtype(
            "ascii"))
        h.attrs["utf8"] = "grüße ✓"
        h.attrs["vlen_list"] = np.array(["alpha", "", "gamma"],
                                        dtype=h5py.string_dtype("ascii"))
        h.attrs["fixed_pad"] = np.array([b"ab", b"cdef"], dtype="S6")
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(8)
        tid.set_strpad(h5py.h5t.STR_NULLTERM)
        space = h5py.h5s.create_simple((2,))
        attr = h5py.h5a.create(h.id, b"fixed_term", tid, space)
        attr.write(np.array([b"one", b"seventh"], dtype="S8"), mtype=tid)
        h.attrs["empty"] = np.zeros((0,), np.float64)
        g = h.create_group("data")
        g.create_dataset("f64", data=rng.normal(size=(4, 5)))
        g.create_dataset("i64", data=np.arange(-6, 6, dtype="<i8")
                         .reshape(3, 4))
        g.create_dataset("i32", data=np.arange(7, dtype="<i4"))
        g.create_dataset("scalar", data=np.float32(2.5))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(g.id, b"compact", h5py.h5t.IEEE_F32LE,
                             h5py.h5s.create_simple((2, 3)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 np.arange(6, dtype="<f4").reshape(2, 3))
        # enough attributes to spill the header into a continuation block
        for i in range(40):
            g.attrs[f"note{i:02d}"] = f"value {i}" * 4


def test_reader_agrees_with_libhdf5_and_h5py_on_h5py_files(tmp_path):
    path = tmp_path / "h5py.h5"
    _h5py_file(path)
    refused = _same_as_libhdf5_and_h5py(path)
    assert set(refused) <= {("/", "utf8")}
    port = Hdf5Archive(str(path))
    assert len(port.list_children("/big")) == 120
    assert port.read_attribute_as_string("utf8") == "grüße ✓"
    assert port.read_attribute_as_string_list("fixed_pad") == ["ab", "cdef"]
    assert port.read_attribute_as_string_list("fixed_term") == [
        "one", "seventh"]
    assert port.read_attribute_as_string("note39", "/data") == "value 39" * 4
    np.testing.assert_array_equal(port.read_dataset("/data/compact"),
                                  np.arange(6, dtype="<f4").reshape(2, 3))


def test_archive_takes_the_files_bytes(tmp_path):
    path = tmp_path / "h5py.h5"
    _h5py_file(path)
    a, b = Hdf5Archive(str(path)), Hdf5Archive(path.read_bytes())
    assert _tree(a) == _tree(b)
    assert a.read_dataset("/data/f64").tobytes() == \
        b.read_dataset("/data/f64").tobytes()
    with pytest.raises(FileNotFoundError):
        Hdf5Archive(str(tmp_path / "absent.h5"))
    with pytest.raises(IOError, match="not an HDF5 file"):
        Hdf5Archive(b"plain bytes, no signature")
    with pytest.raises(IOError, match="Cannot read dataset"):
        a.read_dataset("/data/absent")


def _writer_file(path: Path):
    rng = np.random.default_rng(1)
    data = {"/grp/data": rng.normal(size=(3, 4)).astype(np.float32),
            "/grp/sub/deep": rng.normal(size=(2, 2, 2)).astype(np.float32),
            "/scalar": np.asarray(3.5, np.float32)}
    with Hdf5Writer(str(path)) as w:
        w.write_attr_str("/", "greeting", "hello hdf5")
        w.write_attr_str("/", "empty", "")
        w.create_group("/grp")
        w.create_group("/grp/sub")
        for k, v in data.items():
            w.write_dataset(k, v)
        w.write_attr_strlist("/grp", "names", ["alpha", "beta", "gamma3"])
        w.write_attr_str("/grp/data", "unit", "m/s")
        w.create_group("/big")
        for i in range(300):
            data[f"/big/d{i:03d}"] = np.full((2,), i, np.float32)
            w.write_dataset(f"/big/d{i:03d}", data[f"/big/d{i:03d}"])
        w.write_attr_strlist("/big", "names", [f"n{i}" for i in range(300)])
    return data


def test_writer_files_read_back_through_libhdf5_and_h5py(tmp_path):
    path = tmp_path / "w.h5"
    data = _writer_file(path)
    for reader in (JArchive(str(path)), Hdf5Archive(str(path))):
        assert reader.read_attribute_as_string("greeting") == "hello hdf5"
        assert reader.read_attribute_as_string("empty") == ""
        assert reader.read_attribute_as_string_list("names", "/grp") == [
            "alpha", "beta", "gamma3"]
        assert reader.read_attribute_as_string("unit", "/grp/data") == "m/s"
        assert reader.list_children("/") == [
            ("g", "big"), ("g", "grp"), ("d", "scalar")]
        big = reader.list_children("/big")
        assert big == [("d", f"d{i:03d}") for i in range(300)]
        for k, v in data.items():
            assert reader.read_dataset(k).tobytes() == v.tobytes(), k
    with h5py.File(path, "r") as h:
        assert h.attrs["greeting"] == b"hello hdf5"
        assert [s.decode() for s in h["grp"].attrs["names"]] == [
            "alpha", "beta", "gamma3"]
        assert len(h["big"]) == 300
        for k, v in data.items():
            assert h[k].dtype == np.float32
            np.testing.assert_array_equal(h[k][()], v)
    assert _same_as_libhdf5_and_h5py(path) == []


def test_writer_refuses_what_libhdf5_refuses(tmp_path):
    with Hdf5Writer(str(tmp_path / "r.h5")) as w:
        with pytest.raises(IOError, match="no group"):
            w.create_group("/a/b")
        w.create_group("/a")
        with pytest.raises(IOError):
            w.create_group("/a")
        with pytest.raises(IOError, match="no group"):
            w.write_attr_str("/missing", "x", "y")
        w.write_attr_str("/a", "big", "x" * 70000)
        with pytest.raises(IOError, match="version-1 object header"):
            w.close()


def _gzip_chunked(path):
    with h5py.File(path, "w") as h:
        h.create_dataset("z", data=np.arange(100, dtype="<f4"),
                         compression="gzip", chunks=(10,))


def _chunked(path):
    with h5py.File(path, "w") as h:
        h.create_dataset("z", data=np.arange(100, dtype="<f4"),
                         chunks=(10,))


def _latest(path):
    with h5py.File(path, "w", libver="latest") as h:
        h.create_dataset("z", data=np.arange(4, dtype="<f4"))


@pytest.mark.parametrize("make,words", [
    (_gzip_chunked, "chunked storage with a filter pipeline"),
    (_chunked, "chunked storage"),
    (_latest, "superblock version"),
])
def test_outside_the_subset_raises_naming_the_feature(tmp_path, make, words):
    path = tmp_path / "x.h5"
    make(path)
    with pytest.raises(Hdf5Unsupported, match=words):
        Hdf5Archive(str(path)).read_dataset("/z")
    assert JArchive(str(path)).read_dataset("/z").size > 0


def test_jax_reader_string_limits_c18(tmp_path):
    """ROADMAP C18: libhdf5 read through a NUL-terminated ASCII memory
    type (``native/hdf5_reader.cc``) cuts a NUL-padded string as wide as
    its type by one character (and may refuse a UTF-8 one); the port's
    reader gives h5py's answer."""
    path = tmp_path / "s.h5"
    with h5py.File(path, "w") as h:
        h.attrs["utf8"] = "café"
        h.attrs["full"] = np.bytes_("hello")
        h.attrs["wide"] = np.array([b"abc", b"de"], dtype="S3")
    j, p = JArchive(str(path)), Hdf5Archive(str(path))
    assert j.read_attribute_as_string("full") == "hell"
    assert j.read_attribute_as_string_list("wide") == ["ab", "de"]
    assert p.read_attribute_as_string("utf8") == "café"
    assert p.read_attribute_as_string("full") == "hello"
    assert p.read_attribute_as_string_list("wide") == ["abc", "de"]
