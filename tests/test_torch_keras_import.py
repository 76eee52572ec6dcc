"""The port's Keras import (``deeplearning4j_tpu_torch/keras/
keras_import.py`` over its own HDF5 reader) against the JAX package's,
both importing the same file, and the port's gateway serving Keras files.

- every golden fixture of ``tests/test_keras_golden.py`` (Keras-saved
  ``.h5``: MLP, CNN with batch norm, LSTM, functional with Add /
  Concatenate, two inputs, GRU + SimpleRNN, shape layers, RepeatVector,
  nested submodels): the config JSON equal (the serde of the port's
  configs), the params and layer states equal bit for bit, ``output()``
  within the goldens' own tolerance (1e-5 for the MLP, two-input and
  nested models, 1e-4 for the others) of the JAX net's and of Keras's;
- the written cases of ``tests/test_keras_import.py`` (Keras-2 MLP, CNN
  with Flatten, LSTM, Conv1D, LayerNormalization), written here by the
  port's ``Hdf5Writer``, and its mapper cases;
- the Keras-3 ``.keras`` zips of ``tests/test_keras_v3.py`` (saved here by
  Keras; skipped without it): params bit for bit with the JAX import,
  ``output()`` within 1e-5 / 1e-4 of Keras's;
- an imported Keras LSTM keeps ``forget_gate_bias_init`` 0 (Keras's bias
  already holds ``unit_forget_bias``; the fused LSTM adds the layer's at
  run time) and takes the fused path;
- a functional import trains: its first losses within 1e-5 of the JAX
  net's from the same file;
- the gateway: ``KerasServer(device="cpu")`` serves a Keras ``.h5``
  model and ``.h5`` batch files, answers within 1e-5 of the JAX net's
  ``output()`` on the same file; a ``fit`` op on the Keras path against
  the JAX gateway's on the same file (``.npy`` batch files: the JAX
  gateway's ``.h5`` batch path raises, ROADMAP C17, pinned here).
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.keras import server as jserver
from deeplearning4j_tpu.keras.keras_import import (
    KerasLayerMapper as JMapper,
)
from deeplearning4j_tpu.keras.keras_import import KerasModelImport as JImport
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.keras.hdf5 import Hdf5Writer
from deeplearning4j_tpu_torch.keras.keras_import import (
    KerasLayerMapper, KerasModelImport,
)
from deeplearning4j_tpu_torch.keras.server import KerasClient, KerasServer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import LSTM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FIXTURES = Path(__file__).resolve().parent / "fixtures"
RNG = np.random.default_rng(42)


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(FIXTURES / "keras_goldens.npz"))


def _both(path, sequential=False):
    """The JAX net and the port's (on the CPU) from one file."""
    if sequential:
        return (JImport.import_keras_sequential_model_and_weights(str(path)),
                KerasModelImport.import_keras_sequential_model_and_weights(
                    str(path), device="cpu"))
    return (JImport.import_keras_model_and_weights(str(path)),
            KerasModelImport.import_keras_model_and_weights(str(path),
                                                            device="cpu"))


def _states(net) -> dict:
    items = (net.states.items() if isinstance(net.states, dict)
             else enumerate(net.states))
    return {(k, n): np.asarray(v) for k, s in items for n, v in s.items()}


def _same_net(jnet, pnet):
    """Config JSON equal, params and states bit for bit."""
    assert type(pnet).__name__ == type(jnet).__name__
    assert json.loads(pnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert pnet.params_flat().tobytes() == \
        np.asarray(jnet.params_flat()).tobytes()
    want = _states(jnet)
    got = _states(pnet)
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].astype(got[k].dtype).tobytes(), k


def _out(net, x):
    y = net.output(x)
    return y.numpy() if hasattr(y, "numpy") else np.asarray(y)


GOLDEN = {
    "mlp": ("keras_mlp.h5", "mlp_x", "mlp_y", 1e-5),
    "cnn": ("keras_cnn.h5", "cnn_x", "cnn_y", 1e-4),
    "lstm": ("keras_lstm.h5", "lstm_x", "lstm_y", 1e-4),
    "functional": ("keras_functional.h5", "functional_x", "functional_y",
                   1e-4),
    "two_input": ("keras_two_input.h5", ("two_xa", "two_xb"), "two_y", 1e-5),
    "gru_simplernn": ("keras_gru.h5", "gru_x", "gru_y", 1e-4),
    "shape_layers": ("keras_shapes.h5", "shapes_x", "shapes_y", 1e-4),
    "repeat_vector": ("keras_repeat.h5", "repeat_x", "repeat_y", 1e-4),
    "nested": ("keras_nested.h5", "nested_x", "nested_y", 1e-5),
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_fixture_matches_the_jax_import(goldens, case):
    name, xk, yk, tol = GOLDEN[case]
    jnet, pnet = _both(FIXTURES / name)
    _same_net(jnet, pnet)
    x = ([goldens[k] for k in xk] if isinstance(xk, tuple) else goldens[xk])
    got = _out(pnet, x)
    np.testing.assert_allclose(got, _out(jnet, x), atol=tol)
    np.testing.assert_allclose(got, goldens[yk], atol=tol)
    if case == "two_input":
        assert pnet.conf.network_inputs == ["in_a", "in_b"]
    if case == "nested":
        assert {"feat.n_d1", "funsub.n_fd"} <= set(pnet.conf.nodes)


def test_sequential_entry_refuses_a_functional_file():
    with pytest.raises(ValueError, match="Not a Sequential model"):
        KerasModelImport.import_keras_sequential_model_and_weights(
            str(FIXTURES / "keras_functional.h5"), device="cpu")
    net = KerasModelImport.import_keras_model_and_weights(
        str(FIXTURES / "keras_mlp.h5"), device="cpu")
    assert isinstance(net, MultiLayerNetwork)


def test_imported_lstm_keeps_the_keras_forget_bias_and_the_fused_path(
        goldens):
    net = KerasModelImport.import_keras_sequential_model_and_weights(
        str(FIXTURES / "keras_lstm.h5"), device="cpu")
    lstms = [layer for layer in net.layers if isinstance(layer, LSTM)]
    assert lstms and all(layer.forget_gate_bias_init == 0.0
                         for layer in lstms)
    assert all(layer._fused_kernel_ok(None) for layer in lstms)
    np.testing.assert_allclose(_out(net, goldens["lstm_x"]),
                               goldens["lstm_y"], atol=1e-4)
    # a forget-gate bias of 1 added at run time (the layer's default)
    # would move every answer off the golden
    for layer in lstms:
        layer.forget_gate_bias_init = 1.0
    assert np.abs(_out(net, goldens["lstm_x"])
                  - goldens["lstm_y"]).max() > 1e-3


def test_functional_import_trains_as_the_jax_import():
    jnet, pnet = _both(FIXTURES / "keras_functional.h5")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 8)]
    jl = [float(jnet.fit_batch(JDataSet(x, y))) for _ in range(3)]
    pl = [float(pnet.fit_batch(DataSet(x, y))) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for _ in range(10):
        last = float(pnet.fit_batch(DataSet(x, y)))
    assert last < pl[0]


# ---------------------------------------------------------------------------
# the written cases of tests/test_keras_import.py, through the port's writer
# ---------------------------------------------------------------------------

def _write_keras(path, layers, weights, layer_names=None):
    """A Keras-2-style Sequential file: model_config, and each layer's
    weights under /model_weights/<name>/<name>/<weight>."""
    model_config = {"class_name": "Sequential", "config": {"layers": layers}}
    with Hdf5Writer(str(path)) as w:
        w.write_attr_str("/", "model_config", json.dumps(model_config))
        w.create_group("/model_weights")
        for name, arrays in weights.items():
            g = f"/model_weights/{name}"
            w.create_group(g)
            w.create_group(f"{g}/{name}")
            for an, av in arrays.items():
                w.write_dataset(f"{g}/{name}/{an}", av)
            w.write_attr_strlist(g, "weight_names",
                                 [f"{name}/{k}" for k in arrays])
        if layer_names:
            w.write_attr_strlist("/model_weights", "layer_names",
                                 layer_names)


def _dense(name, units, act, in_dim=None):
    cfg = {"name": name, "units": units, "activation": act}
    if in_dim is not None:
        cfg["batch_input_shape"] = [None, in_dim]
    return {"class_name": "Dense", "config": cfg}


def _f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _mlp_file(path):
    _write_keras(path, [_dense("dense_1", 8, "relu", 4),
                        _dense("dense_2", 3, "softmax")],
                 {"dense_1": {"kernel:0": _f32(4, 8), "bias:0": _f32(8)},
                  "dense_2": {"kernel:0": _f32(8, 3), "bias:0": _f32(3)}},
                 ["dense_1", "dense_2"])
    return _f32(5, 4)


def _cnn_file(path):
    _write_keras(path, [
        {"class_name": "Conv2D",
         "config": {"name": "conv", "filters": 4, "kernel_size": [3, 3],
                    "strides": [1, 1], "padding": "valid",
                    "activation": "relu",
                    "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "pool", "pool_size": [2, 2], "strides": [2, 2],
                    "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        _dense("fc", 2, "softmax")],
        {"conv": {"kernel:0": _f32(3, 3, 1, 4), "bias:0": _f32(4)},
         "fc": {"kernel:0": _f32(36, 2), "bias:0": _f32(2)}})
    return _f32(2, 8, 8, 1)


def _lstm_file(path):
    F, H, C = 3, 5, 2
    _write_keras(path, [
        {"class_name": "LSTM",
         "config": {"name": "lstm", "units": H, "activation": "tanh",
                    "recurrent_activation": "sigmoid",
                    "return_sequences": True,
                    "batch_input_shape": [None, 7, F]}},
        {"class_name": "GlobalAveragePooling1D", "config": {"name": "gap"}},
        _dense("out", C, "softmax")],
        {"lstm": {"kernel:0": _f32(F, 4 * H),
                  "recurrent_kernel:0": _f32(H, 4 * H),
                  "bias:0": _f32(4 * H)},
         "out": {"kernel:0": _f32(H, C), "bias:0": np.zeros(C, np.float32)}})
    return _f32(2, 7, F)


def _conv1d_file(path):
    T, F, K, O = 8, 3, 3, 4
    _write_keras(path, [
        {"class_name": "Conv1D",
         "config": {"name": "c1", "filters": O, "kernel_size": [K],
                    "strides": [1], "padding": "valid", "activation": "relu",
                    "batch_input_shape": [None, T, F]}},
        {"class_name": "MaxPooling1D",
         "config": {"name": "p1", "pool_size": 2, "strides": 2,
                    "padding": "valid"}},
        {"class_name": "GlobalMaxPooling1D", "config": {"name": "g1"}},
        _dense("fc", 2, "softmax")],
        {"c1": {"kernel:0": _f32(K, F, O), "bias:0": _f32(O)},
         "fc": {"kernel:0": _f32(O, 2), "bias:0": np.zeros(2, np.float32)}},
        ["c1", "p1", "g1", "fc"])
    return _f32(2, T, F)


def _layernorm_file(path):
    F = 5
    _write_keras(path, [
        {"class_name": "LayerNormalization",
         "config": {"name": "ln", "epsilon": 1e-5, "axis": -1,
                    "batch_input_shape": [None, F]}},
        _dense("fc", 2, "softmax")],
        {"ln": {"gamma:0": _f32(F) + 1.0, "beta:0": _f32(F)},
         "fc": {"kernel:0": _f32(F, 2), "bias:0": np.zeros(2, np.float32)}})
    return _f32(3, F)


WRITTEN = {"mlp": _mlp_file, "cnn_flatten": _cnn_file, "lstm": _lstm_file,
           "conv1d": _conv1d_file, "layernorm": _layernorm_file}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_file_imports_as_the_jax_import(tmp_path, case):
    path = tmp_path / f"{case}.h5"
    x = WRITTEN[case](path)
    jnet, pnet = _both(path, sequential=True)
    _same_net(jnet, pnet)
    np.testing.assert_allclose(_out(pnet, x), _out(jnet, x), atol=1e-5)


@pytest.mark.parametrize("cls,cfg,in_type", [
    ("Conv1D", {"filters": 3, "kernel_size": [3], "strides": [1],
                "padding": "valid", "dilation_rate": [2],
                "activation": "linear"}, ("recurrent", 5, 20)),
    ("ZeroPadding1D", {"padding": 2}, ("recurrent", 3, 5)),
    ("TimeDistributedDense", {"output_dim": 4, "activation": "tanh"},
     ("recurrent", 3, 5)),
    ("LSTM", {"units": 6, "recurrent_activation": "hard_sigmoid"},
     ("recurrent", 3, 5)),
    ("Dropout", {"rate": 0.25}, ("feed_forward", 4)),
])
def test_mapper_matches_the_jax_mapper(cls, cfg, in_type):
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
    kind, *dims = in_type
    got, want = KerasLayerMapper.map(cls, dict(cfg)), JMapper.map(cls,
                                                                  dict(cfg))
    got.set_n_in(getattr(InputType, kind)(*dims))
    want.set_n_in(getattr(JInputType, kind)(*dims))
    assert got.to_dict() == want.to_dict()
    assert got.infer_output_type(getattr(InputType, kind)(*dims)).to_dict() \
        == want.infer_output_type(getattr(JInputType, kind)(*dims)).to_dict()


@pytest.mark.parametrize("cls,cfg,words", [
    ("LayerNormalization", {"axis": 1}, "axis"),
    ("LayerNormalization", {"scale": False}, "scale"),
    ("Conv1D", {"filters": 2, "kernel_size": [2], "padding": "causal"},
     "causal"),
    ("Bogus", {}, "Unsupported Keras layer"),
])
def test_mapper_refuses_what_the_jax_mapper_refuses(cls, cfg, words):
    with pytest.raises(ValueError, match=words):
        JMapper.map(cls, cfg)
    with pytest.raises(ValueError, match=words):
        KerasLayerMapper.map(cls, cfg)


# ---------------------------------------------------------------------------
# Keras-3 .keras zips (saved here by Keras)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keras():
    return pytest.importorskip("keras")


def _v3_models(keras):
    L = keras.layers
    rng = np.random.default_rng(0)

    def mlp():
        keras.utils.set_random_seed(1)
        return keras.Sequential([L.Input(shape=(6,)),
                                 L.Dense(8, activation="relu", name="d1"),
                                 L.Dense(3, activation="softmax",
                                         name="out")]), rng.normal(
            size=(4, 6)).astype(np.float32), 1e-5

    def cnn_bn():
        keras.utils.set_random_seed(2)
        m = keras.Sequential([
            L.Input(shape=(8, 8, 3)),
            L.Conv2D(4, 3, padding="same", activation="relu", name="c1"),
            L.BatchNormalization(name="bn"),
            L.Conv2D(5, 3, padding="same", name="c2"), L.Flatten(),
            L.Dense(3, activation="softmax", name="out")])
        m.compile(optimizer="sgd", loss="categorical_crossentropy")
        m.fit(rng.normal(size=(16, 8, 8, 3)).astype(np.float32),
              np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)],
              epochs=1, verbose=0)   # BN moving stats become non-trivial
        return m, rng.normal(size=(3, 8, 8, 3)).astype(np.float32), 1e-4

    def merge():
        keras.utils.set_random_seed(3)
        ia = L.Input(shape=(5,), name="in_a")
        ib = L.Input(shape=(4,), name="in_b")
        add = L.Add(name="add")([L.Dense(6, activation="relu", name="da")(ia),
                                 L.Dense(6, activation="relu", name="db")(ib)])
        m = keras.Model([ia, ib], L.Dense(2, activation="softmax",
                                           name="out")(add))
        return m, [rng.normal(size=(5, 5)).astype(np.float32),
                   rng.normal(size=(5, 4)).astype(np.float32)], 1e-5

    def gru_lstm():
        keras.utils.set_random_seed(4)
        return keras.Sequential([
            L.Input(shape=(6, 5)),
            L.GRU(7, return_sequences=True, name="g"),
            L.LSTM(6, name="l", unit_forget_bias=False),
            L.Dense(3, activation="softmax", name="out")]), rng.normal(
            size=(4, 6, 5)).astype(np.float32), 1e-4

    def time_distributed():
        keras.utils.set_random_seed(6)
        return keras.Sequential([
            L.Input(shape=(8, 8, 3)),
            L.Conv2D(3, 3, padding="same", activation="relu", name="c"),
            L.Reshape((64, 3), name="rs"),
            L.TimeDistributed(L.Dense(4, activation="tanh"), name="td"),
            L.GRU(5, name="g"),
            L.Dense(2, activation="softmax", name="out")]), rng.normal(
            size=(3, 8, 8, 3)).astype(np.float32), 1e-4

    return {"mlp": mlp, "cnn_bn": cnn_bn, "merge": merge,
            "gru_lstm": gru_lstm, "time_distributed": time_distributed}


@pytest.mark.parametrize("case", ["mlp", "cnn_bn", "merge", "gru_lstm",
                                  "time_distributed"])
def test_keras_v3_zip_imports_as_the_jax_import(tmp_path, keras, case):
    model, x, tol = _v3_models(keras)[case]()
    want = model.predict(x, verbose=0)
    path = tmp_path / f"{case}.keras"
    model.save(str(path))
    assert zipfile.is_zipfile(path)
    jnet, pnet = _both(path)
    _same_net(jnet, pnet)
    np.testing.assert_allclose(_out(pnet, x), want, atol=tol)
    np.testing.assert_allclose(_out(pnet, x), _out(jnet, x), atol=tol)


def test_keras_v3_nested_and_wrong_class_raise(tmp_path, keras):
    L = keras.layers
    keras.utils.set_random_seed(5)
    inner = keras.Sequential([L.Input(shape=(4,)), L.Dense(3, name="i1")])
    inp = L.Input(shape=(4,))
    m = keras.Model(inp, L.Dense(2, name="h")(inner(inp)))
    path = str(tmp_path / "nested.keras")
    m.save(path)
    with pytest.raises(ValueError, match="nested"):
        KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    with pytest.raises(ValueError, match="Not a Sequential model"):
        KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu")


# ---------------------------------------------------------------------------
# the gateway on Keras files
# ---------------------------------------------------------------------------

def test_gateway_serves_a_keras_model_and_h5_batch_files(tmp_path, goldens):
    """A Keras ``.h5`` model predicted from ``.h5`` batch files (the
    port's writer; one array each) answers within 1e-5 of the JAX net's
    ``output()`` on the same file."""
    model = str(FIXTURES / "keras_lstm.h5")
    jnet = JImport.import_keras_model_and_weights(model)
    x = goldens["lstm_x"]
    files = []
    for k, rows in enumerate((1, 2, 3)):
        files.append(str(tmp_path / f"x{k}.h5"))
        with Hdf5Writer(files[-1]) as w:
            w.create_group("/meta")
            w.write_dataset("/b_second", np.zeros((1,), np.float32))
            w.write_dataset("/a_features", x[:rows])
    srv = KerasServer(device="cpu", max_batch=8)
    try:
        cli = KerasClient(srv.host, srv.port)
        for k, rows in enumerate((1, 2, 3)):
            got = cli.predict(files[k], model=model)
            np.testing.assert_allclose(got, np.asarray(jnet.output(x[:rows])),
                                       atol=1e-5)
        cli.close()
    finally:
        srv.stop()


def _fit_dirs(tmp_path, x, y, n=2):
    fdir, ldir = tmp_path / "f", tmp_path / "l"
    fdir.mkdir()
    ldir.mkdir()
    for k in range(n):
        np.save(fdir / f"{k:02d}.npy", x[k::n])
        np.save(ldir / f"{k:02d}.npy", y[k::n])
    return str(fdir), str(ldir)


def test_gateway_fit_on_a_keras_path_matches_the_jax_gateway(tmp_path,
                                                             goldens):
    model = str(FIXTURES / "keras_mlp.h5")
    x = goldens["mlp_x"].astype(np.float32)
    n_out = goldens["mlp_y"].shape[-1]
    y = np.eye(n_out, dtype=np.float32)[np.arange(len(x)) % n_out]
    fdir, ldir = _fit_dirs(tmp_path, x, y)
    probe = str(tmp_path / "probe.npy")
    np.save(probe, x)
    answers = {}
    for label, make, client in (
            ("jax", lambda: jserver.KerasServer(), jserver.KerasClient),
            ("port", lambda: KerasServer(device="cpu"), KerasClient)):
        srv = make()
        try:
            cli = client(srv.host, srv.port)
            before = cli.predict(probe, model=model)
            resp = cli.fit(model, fdir, ldir, nb_epoch=2)
            answers[label] = (resp["score"], before,
                              cli.predict(probe, model=model))
            cli.close()
        finally:
            srv.stop()
    (js, jb, ja), (ps, pb, pa) = answers["jax"], answers["port"]
    np.testing.assert_allclose(pb, jb, atol=1e-5)
    np.testing.assert_allclose(ps, js, rtol=1e-5)
    np.testing.assert_allclose(pa, ja, atol=1e-5)
    assert np.abs(pa - pb).max() > 1e-5


def test_jax_h5_batch_raises_c17(tmp_path):
    """ROADMAP C17: the JAX gateway's ``.h5`` batch path calls
    ``Hdf5Archive.dataset_names``, which its reader lacks; the port reads
    the file's first dataset."""
    path = tmp_path / "x.h5"
    with Hdf5Writer(str(path)) as w:
        w.write_dataset("/x", np.ones((2, 3), np.float32))
    with pytest.raises(AttributeError, match="dataset_names"):
        jserver._load_array(path)
    from deeplearning4j_tpu_torch.keras.server import _load_array
    np.testing.assert_array_equal(_load_array(path), np.ones((2, 3)))


def test_import_onto_the_card_needs_one(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasModelImport.import_keras_model_and_weights(
            str(FIXTURES / "keras_mlp.h5"))


def test_graph_import_lives_on_the_requested_device():
    net = KerasModelImport.import_keras_model_and_weights(
        str(FIXTURES / "keras_functional.h5"), device="cpu")
    assert isinstance(net, ComputationGraph)
    assert all(t.device.type == "cpu" for p in net.params.values()
               for t in p.values())
