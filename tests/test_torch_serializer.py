"""The port's ``ModelSerializer`` zip checkpoints and the container
methods they stand on (ROADMAP C10), against the JAX package's.

Three groups:

- **Port against port**: the counterparts of ``test_cg_zip_round_trip``
  and ``test_restore_model_discriminates`` (``tests/test_checkpoint.py``)
  and of the five ``ModelSerializer`` cases of ``tests/test_resilience.py``
  (an atomic crash leaves the old archive, a torn write is caught, a
  truncated member is named, int32 counts past 2^24 come back exact, a v1
  archive restores), through the port's ``truncate_checkpoint`` fault.
  The next ``fit_batch`` after a restore is bitwise the uninterrupted one.
- **Across frameworks, on copied weights**, parametrised over Adam,
  Nesterov, Adagrad, RMSProp, Adadelta, SGD with a ``step`` lr policy and
  ``minimize=False``, on a graph whose sorted node names run against its
  topological order and on a stack, both with batch norm: a zip written
  by the JAX package restores into the port and the reverse, params and
  BN states equal to the written bytes, the updater leaves equal, the
  next 5 ``fit_batch`` calls at the training-parity tolerances (loss 1e-5
  relative, params 1e-5) — the reverse direction is what proves the
  updater-state leaf map, since a JAX restore of a wrong order does not
  raise — and ``coefficients.bin`` byte-identical for the same weights.
  The GPT decoder and the char-RNN (tBPTT) cross the same way under Adam,
  their JAX side through its Pallas kernels in interpret mode.
- **C10**: ``params_flat`` equal to the JAX net's vector exactly (a graph
  and a stack), ``set_params_flat`` in place (a round trip, a wrong
  length raising with the net untouched), ``predict`` the argmax of
  ``output``, ``clone`` sharing no storage and giving equal outputs.

Dropout stays off in cross-framework parity.
"""

import json
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import char_rnn as jchar, gpt as jgpt
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf.builder import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSerializer

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import char_rnn, gpt
from deeplearning4j_tpu_torch.nn.conf import graph as tgraph
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
import deeplearning4j_tpu_torch.nn.layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import (
    CheckpointError, Fault, FaultSchedule, KilledByFault, faultinject,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

JAX = SimpleNamespace(NNC=JNNC, InputType=JInputType, L=jlayers, G=jgraph,
                      Graph=JGraph, Net=JNet, DataSet=JDataSet)
PORT = SimpleNamespace(NNC=NeuralNetConfiguration, InputType=InputType,
                       L=tlayers, G=tgraph, Graph=ComputationGraph,
                       Net=MultiLayerNetwork, DataSet=DataSet)
F_IN, N_OUT, B = 5, 3, 6
#: the training-parity tolerances (tests/test_torch_gpt_train.py,
#: tests/test_torch_multilayer_train.py): losses relative, params both
LOSS_RTOL = 1e-5
P_TOL = 1e-5
#: output() of the restored nets: f32 sums in another order
OUT_TOL = 1e-5
STEPS = 5

#: name -> (updater, learning rate, updater options, lr policy, minimize)
UPDATERS = {
    "adam": ("adam", 0.01, {}, None, True),
    "nesterovs": ("nesterovs", 0.05, {"momentum": 0.9}, None, True),
    "adagrad": ("adagrad", 0.05, {}, None, True),
    "rmsprop": ("rmsprop", 0.01, {"rho": 0.9}, None, True),
    "adadelta": ("adadelta", 1.0, {"rho": 0.95}, None, True),
    "sgd_step": ("sgd", 0.1, {}, dict(decay_rate=0.5, steps=2), True),
    "maximize": ("adam", 0.01, {}, None, False),
}


@pytest.fixture(autouse=True)
def _clean_schedule(monkeypatch):
    """The JAX side runs its Pallas kernels in interpret mode, and no
    fault schedule outlives its test."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    yield
    faultinject.clear()


def _builder(ns, updater="adam"):
    name, lr, kw, policy, minimize = UPDATERS[updater]
    b = ns.NNC.builder().seed(11).updater(name, learning_rate=lr, **kw)
    if policy:
        b = b.lr_policy("step", **policy)
    return b.minimize(minimize)


def _graph_conf(ns, updater="adam"):
    """Dense -> batch norm -> softmax head, named so that the sorted
    names (optax's moment order) run against the topological order."""
    return (_builder(ns, updater).graph_builder()
            .add_inputs("in")
            .add_layer("z_dense", ns.L.DenseLayer(n_out=8, activation="tanh"),
                       "in")
            .add_layer("m_bn", ns.L.BatchNormalization(), "z_dense")
            .add_layer("a_out", ns.L.OutputLayer(n_out=N_OUT,
                                                 activation="softmax",
                                                 loss="mcxent"), "m_bn")
            .set_outputs("a_out")
            .set_input_types(ns.InputType.feed_forward(F_IN))
            .build())


def _stack_conf(ns, updater="adam"):
    return (_builder(ns, updater).list()
            .layer(ns.L.DenseLayer(n_out=8, activation="tanh"))
            .layer(ns.L.BatchNormalization())
            .layer(ns.L.DenseLayer(n_out=4, activation="relu"))
            .layer(ns.L.OutputLayer(n_out=N_OUT, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(ns.InputType.feed_forward(F_IN))
            .build())


def _skip_graph_conf(ns):
    """The DAG of tests/test_checkpoint.py: a residual add and a merge."""
    L, G = ns.L, ns.G
    return (ns.NNC.builder().seed(7).updater("adam").learning_rate(0.01)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", L.DenseLayer(n_out=12, activation="relu"), "in")
            .add_layer("d2", L.DenseLayer(n_out=12, activation="identity"),
                       "d1")
            .add_vertex("res", G.ElementWiseVertex(op="add"), "d1", "d2")
            .add_layer("d3", L.DenseLayer(n_out=6, activation="relu"), "res")
            .add_vertex("cat", G.MergeVertex(), "res", "d3")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                            loss="mcxent"), "cat")
            .set_outputs("out")
            .set_input_types(ns.InputType.feed_forward(8))
            .build())


def _batch(seed=0, f_in=F_IN, n_out=N_OUT):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, f_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, B)]
    return x, y


def _twins(kind, updater="adam"):
    """The JAX net and the port net with its weights and states."""
    conf_fn = {"graph": _graph_conf, "stack": _stack_conf}[kind]
    jconf, tconf = conf_fn(JAX, updater), conf_fn(PORT, updater)
    jnet = (JAX.Graph if kind == "graph" else JAX.Net)(jconf).init()
    tnet = (PORT.Graph if kind == "graph" else PORT.Net)(
        tconf, device="cpu").init(
        convert.params_from_jax(tconf, jax.tree.map(np.asarray,
                                                    jnet.params)),
        convert.states_from_jax(tconf, jax.tree.map(np.asarray,
                                                    jnet.states)))
    return jnet, tnet


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _rewrite(path, members):
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for n, data in members.items():
            z.writestr(n, data)


def _jax_leaves(jnet):
    return [np.asarray(leaf)
            for leaf in jax.tree_util.tree_leaves(jnet.opt_state)]


def _assert_leaves_equal(got, want):
    """Leaf by leaf: dtype, shape and values. A step count is a scalar in
    a live state and shape [1] once restored from a JAX-format archive
    (the JAX package's writer stores scalars so)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.shape == w.shape or g.size == w.size == 1
        np.testing.assert_array_equal(g.reshape(w.shape), w)


def _state_arrays(states):
    items = (states.items() if isinstance(states, dict)
             else enumerate(states))
    return {f"{i}:{k}": (convert.states_to_numpy(v)
                         if isinstance(v, torch.Tensor) else np.asarray(v))
            for i, s in items for k, v in s.items()}


def _steps_agree(jnet, tnet, seed=1):
    """The next STEPS fit_batch calls of both nets on the same batches:
    the losses and the params after them."""
    for s in range(STEPS):
        x, y = _batch(seed + s)
        lj = float(jnet.fit_batch(JDataSet(x, y)))
        lt = float(tnet.fit_batch(DataSet(x, y)))
        assert lt == pytest.approx(lj, rel=LOSS_RTOL), s
    np.testing.assert_allclose(tnet.params_flat(),
                               np.asarray(jnet.params_flat()),
                               rtol=P_TOL, atol=P_TOL)


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------

def _trained(conf, steps=3, f_in=8):
    net = ComputationGraph(conf, device="cpu").init()
    for s in range(steps):
        net.fit_batch(DataSet(*_batch(s, f_in=f_in)))
    return net


def test_cg_zip_round_trip(tmp_path):
    net = _trained(_skip_graph_conf(PORT))
    path = tmp_path / "cg.zip"
    ModelSerializer.write_model(net, path)
    net2 = ModelSerializer.restore_computation_graph(path, device="cpu")
    x, y = _batch(9, f_in=8)
    assert torch.equal(net.output(x), net2.output(x))
    assert net2.opt_state["count"] == net.opt_state["count"] == 3
    # resume training: the restored updater gives the same next step
    assert torch.equal(net.fit_batch(DataSet(x, y)),
                       net2.fit_batch(DataSet(x, y)))
    np.testing.assert_array_equal(net.params_flat(), net2.params_flat())


def test_restore_model_discriminates(tmp_path):
    net = _trained(_skip_graph_conf(PORT), steps=0)
    cg_path = tmp_path / "cg.zip"
    ModelSerializer.write_model(net, cg_path)
    assert isinstance(ModelSerializer.restore_model(cg_path, device="cpu"),
                      ComputationGraph)
    with pytest.raises(ValueError, match="ComputationGraph"):
        ModelSerializer.restore_multi_layer_network(cg_path, device="cpu")
    mln = MultiLayerNetwork(_stack_conf(PORT), device="cpu").init()
    mln_path = tmp_path / "mln.zip"
    ModelSerializer.write_model(mln, mln_path)
    assert isinstance(ModelSerializer.restore_model(mln_path, device="cpu"),
                      MultiLayerNetwork)
    with pytest.raises(ValueError, match="MultiLayerNetwork"):
        ModelSerializer.restore_computation_graph(mln_path, device="cpu")


def test_restore_without_a_card_raises_unless_cpu(tmp_path, monkeypatch):
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(
        MultiLayerNetwork(_stack_conf(PORT), device="cpu").init(), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for restore in (ModelSerializer.restore_model,
                    ModelSerializer.restore_multi_layer_network):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore(path)
    assert ModelSerializer.restore_model(
        path, device="cpu").device.type == "cpu"


def _gpt_net():
    return ComputationGraph(gpt.gpt_tiny(vocab_size=12, seq_len=8),
                            device="cpu").init()


def _lm_batch(seed, V=12, T=8):
    tok = np.random.default_rng(seed).integers(0, V, (3, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]])


def _char_net():
    return MultiLayerNetwork(char_rnn.char_rnn_lstm(
        12, hidden=8, layers=2, tbptt_length=4), device="cpu").init()


def _bn_stack_net():
    return MultiLayerNetwork(_stack_conf(PORT, "nesterovs"),
                             device="cpu").init()


@pytest.mark.parametrize("model", ["gpt_tiny", "char_rnn_tbptt",
                                   "bn_stack"])
def test_next_step_after_restore_is_bitwise(tmp_path, model):
    net, batch = {
        "gpt_tiny": (_gpt_net, _lm_batch),
        "char_rnn_tbptt": (_char_net, lambda s: _lm_batch(s, T=10)),
        "bn_stack": (_bn_stack_net, lambda s: DataSet(*_batch(s))),
    }[model]
    src = net()
    for s in range(2):
        src.fit_batch(batch(s))
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(src, path)
    ModelSerializer.verify(path)
    back = ModelSerializer.restore_model(path, device="cpu")
    assert torch.equal(back.output(batch(5).features),
                       src.output(batch(5).features))
    for s in (2, 3):
        assert torch.equal(src.fit_batch(batch(s)), back.fit_batch(batch(s)))
    np.testing.assert_array_equal(back.params_flat(), src.params_flat())
    _assert_leaves_equal(convert.opt_state_to_jax(back),
                         convert.opt_state_to_jax(src))
    assert _state_arrays(back.states).keys() == \
        _state_arrays(src.states).keys()
    for k, v in _state_arrays(src.states).items():
        np.testing.assert_array_equal(_state_arrays(back.states)[k], v)


def test_restore_weights_writes_in_place(tmp_path):
    """A restore into a built net keeps every param, state and moment
    tensor at its address (a served net's CUDA graphs stay valid)."""
    src = _bn_stack_net()
    for s in range(2):
        src.fit_batch(DataSet(*_batch(s)))
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(src, path)
    dst = _bn_stack_net()

    def ptrs(net):
        tensors = ([t for p in net.params for t in p.values()]
                   + [t for s in net.states for t in s.values()]
                   + net._tx.optax_leaves(net.opt_state)[:-1])
        return [t.data_ptr() for t in tensors]

    before = ptrs(dst)
    ModelSerializer.restore_weights(path, dst)
    assert ptrs(dst) == before
    np.testing.assert_array_equal(dst.params_flat(), src.params_flat())
    assert dst.opt_state["count"] == 2


def test_restore_without_updater_keeps_a_fresh_state(tmp_path):
    src = _bn_stack_net()
    src.fit_batch(DataSet(*_batch(0)))
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(src, path, save_updater=False)
    assert ModelSerializer.UPDATER_NAME not in _members(path)
    back = ModelSerializer.restore_model(path, device="cpu")
    assert back.opt_state["count"] == 0
    np.testing.assert_array_equal(back.params_flat(), src.params_flat())


def test_atomic_write_crash_leaves_previous_checkpoint(tmp_path):
    """A SIGKILL between write and rename: the final path keeps the OLD
    complete archive."""
    net = _bn_stack_net()
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(net, path)
    before = path.read_bytes()
    net.fit_batch(DataSet(*_batch(0)))
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", at_call=1, mode="crash")]))
    with pytest.raises(KilledByFault):
        ModelSerializer.write_model(net, path)
    assert path.read_bytes() == before   # the old archive is untouched
    ModelSerializer.verify(path)          # and still valid


def test_torn_zip_write_detected_by_checksum(tmp_path):
    """torn mode lets a truncated archive land at the final path: verify
    and a restore reject it."""
    path = tmp_path / "m.zip"
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", at_call=1, mode="torn")]))
    ModelSerializer.write_model(_bn_stack_net(), path)
    with pytest.raises(CheckpointError):
        ModelSerializer.verify(path)
    with pytest.raises(CheckpointError):
        ModelSerializer.restore_model(path, device="cpu")


def test_truncated_coefficients_member_named_in_error(tmp_path):
    """An archive whose coefficients.bin was truncated, rebuilt with the
    ORIGINAL checksums manifest (a self-consistent zip that only our CRCs
    catch), raises CheckpointError naming the member."""
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(_bn_stack_net(), path)
    members = _members(path)
    name = ModelSerializer.COEFFICIENTS_NAME
    members[name] = members[name][:-16]
    _rewrite(path, members)
    with pytest.raises(CheckpointError, match="coefficients.bin"):
        ModelSerializer.verify(path)
    with pytest.raises(CheckpointError, match="coefficients.bin"):
        ModelSerializer.restore_weights(path, _bn_stack_net())


def test_bit_flipped_updater_state_named_in_error(tmp_path):
    net = _bn_stack_net()
    net.fit_batch(DataSet(*_batch(0)))
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(net, path)
    members = _members(path)
    name = ModelSerializer.UPDATER_NAME
    flipped = bytearray(members[name])
    flipped[len(flipped) // 2] ^= 0x10
    members[name] = bytes(flipped)
    _rewrite(path, members)
    with pytest.raises(CheckpointError, match="updaterState.bin"):
        ModelSerializer.verify(path)


def test_updater_state_native_dtypes_round_trip(tmp_path):
    """int32 step counts past 2^24 survive exactly (the legacy all-f4
    encoding rounded them); the moments keep their dtype."""
    net = _bn_stack_net()
    net.fit_batch(DataSet(*_batch(0)))
    big = 2 ** 24 + 5
    net.opt_state["count"] = big
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(net, path)
    manifest = json.loads(_members(path)[ModelSerializer.UPDATER_MANIFEST])
    assert manifest["version"] == 2
    assert [leaf["dtype"] for leaf in manifest["leaves"]][-1] == "int32"
    net2 = _bn_stack_net()
    ModelSerializer.restore_weights(path, net2)
    assert net2.opt_state["count"] == big   # not representable in f4
    _assert_leaves_equal(convert.opt_state_to_jax(net2),
                         convert.opt_state_to_jax(net))


def test_legacy_f4_updater_archive_restores(tmp_path):
    """Archives written before the native-dtype manifest (a bare-list
    manifest, every leaf <f4) still restore."""
    net = _bn_stack_net()
    for s in range(3):
        net.fit_batch(DataSet(*_batch(s)))
    leaves = convert.opt_state_to_jax(net)
    manifest = [{"shape": list(a.shape), "dtype": str(a.dtype)}
                for a in leaves]
    blob = np.concatenate([a.astype("<f4").ravel() for a in leaves])
    path = tmp_path / "legacy.zip"
    _rewrite(path, {
        ModelSerializer.CONFIG_NAME: net.conf.to_json(),
        ModelSerializer.COEFFICIENTS_NAME:
            net.params_flat().astype("<f4").tobytes(),
        ModelSerializer.UPDATER_NAME: blob.tobytes(),
        ModelSerializer.UPDATER_MANIFEST: json.dumps(manifest)})
    net2 = _bn_stack_net()
    ModelSerializer.restore_weights(path, net2)
    np.testing.assert_array_equal(net2.params_flat(), net.params_flat())
    assert net2.opt_state["count"] == 3
    _assert_leaves_equal(convert.opt_state_to_jax(net2), leaves)


def test_checkpoint_fault_counts_commits_from_arming(tmp_path):
    """``at_call`` addresses the Nth commit since the schedule was
    armed; the fault fires once."""
    net = _bn_stack_net()
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", at_call=2, mode="crash")]))
    ModelSerializer.write_model(net, tmp_path / "a.zip")
    with pytest.raises(KilledByFault):
        ModelSerializer.write_model(net, tmp_path / "b.zip")
    assert not (tmp_path / "b.zip").exists()
    ModelSerializer.write_model(net, tmp_path / "c.zip")
    ModelSerializer.verify(tmp_path / "c.zip")
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("truncate_checkpoints")


# ---------------------------------------------------------------------------
# across frameworks, on copied weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("updater", list(UPDATERS))
@pytest.mark.parametrize("kind", ["graph", "stack"])
def test_jax_zip_restores_into_the_port(tmp_path, kind, updater):
    jnet, _ = _twins(kind, updater)
    for s in range(2):
        jnet.fit_batch(JDataSet(*_batch(10 + s)))
    path = tmp_path / "jax.zip"
    JSerializer.write_model(jnet, path)
    tnet = ModelSerializer.restore_model(path, device="cpu")
    members = _members(path)
    assert (tnet.params_flat().astype("<f4").tobytes()
            == members[ModelSerializer.COEFFICIENTS_NAME])
    written = _state_arrays(jnet.states)
    got = _state_arrays(tnet.states)
    assert got.keys() == written.keys()
    for k, v in written.items():
        np.testing.assert_array_equal(got[k], v)
    _assert_leaves_equal(convert.opt_state_to_jax(tnet), _jax_leaves(jnet))
    x, _ = _batch(20)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=OUT_TOL)
    _steps_agree(jnet, tnet)


@pytest.mark.parametrize("updater", list(UPDATERS))
@pytest.mark.parametrize("kind", ["graph", "stack"])
def test_port_zip_restores_into_jax(tmp_path, kind, updater):
    _, tnet = _twins(kind, updater)
    for s in range(2):
        tnet.fit_batch(DataSet(*_batch(10 + s)))
    path = tmp_path / "port.zip"
    ModelSerializer.write_model(tnet, path)
    jnet = JSerializer.restore_model(path)
    assert (np.asarray(jnet.params_flat()).astype("<f4").tobytes()
            == _members(path)[ModelSerializer.COEFFICIENTS_NAME])
    written = _state_arrays(tnet.states)
    got = _state_arrays(jnet.states)
    for k, v in written.items():
        np.testing.assert_array_equal(got[k], v)
    _assert_leaves_equal(_jax_leaves(jnet), convert.opt_state_to_jax(tnet))
    x, _ = _batch(20)
    np.testing.assert_allclose(np.asarray(jnet.output(x)),
                               tnet.output(x).numpy(), atol=OUT_TOL)
    _steps_agree(jnet, tnet)


@pytest.mark.parametrize("updater", list(UPDATERS))
def test_opt_state_from_jax_continues_in_step(updater):
    """``convert.opt_state_from_jax`` carries a trained JAX net's optax
    state into the port net that holds its weights (no archive): the next
    steps agree, and ``opt_state_to_jax`` gives the same leaves back."""
    jnet, _ = _twins("graph", updater)
    for s in range(2):
        jnet.fit_batch(JDataSet(*_batch(10 + s)))
    conf = _graph_conf(PORT, updater)
    tnet = ComputationGraph(conf, device="cpu").init(
        convert.params_from_jax(conf, jax.tree.map(np.asarray,
                                                   jnet.params)),
        convert.states_from_jax(conf, jax.tree.map(np.asarray,
                                                   jnet.states)))
    convert.opt_state_from_jax(tnet, _jax_leaves(jnet))
    _assert_leaves_equal(convert.opt_state_to_jax(tnet), _jax_leaves(jnet))
    _steps_agree(jnet, tnet)


@pytest.mark.parametrize("kind", ["graph", "stack"])
def test_coefficients_are_byte_identical(tmp_path, kind):
    jnet, tnet = _twins(kind)
    JSerializer.write_model(jnet, tmp_path / "j.zip")
    ModelSerializer.write_model(tnet, tmp_path / "t.zip")
    j, t = _members(tmp_path / "j.zip"), _members(tmp_path / "t.zip")
    name = ModelSerializer.COEFFICIENTS_NAME
    assert t[name] == j[name]
    assert json.loads(t[ModelSerializer.CONFIG_NAME]) == \
        json.loads(j[ModelSerializer.CONFIG_NAME])
    assert json.loads(t[ModelSerializer.UPDATER_MANIFEST]) == \
        json.loads(j[ModelSerializer.UPDATER_MANIFEST])
    assert t[ModelSerializer.UPDATER_NAME] == j[ModelSerializer.UPDATER_NAME]
    assert sorted(t) == sorted(j)


def _lm_twins(model):
    if model == "gpt":
        jconf = jgpt.gpt_tiny(vocab_size=12, seq_len=8)
        tconf = gpt.gpt_tiny(vocab_size=12, seq_len=8)
        jnet, cls, T = JGraph(jconf).init(), ComputationGraph, 8
    else:
        jconf = jchar.char_rnn_lstm(12, hidden=8, layers=2, tbptt_length=4)
        tconf = char_rnn.char_rnn_lstm(12, hidden=8, layers=2,
                                       tbptt_length=4)
        jnet, cls, T = JNet(jconf).init(), MultiLayerNetwork, 10
    tnet = cls(tconf, device="cpu").init(
        convert.params_from_jax(tconf, jax.tree.map(np.asarray,
                                                    jnet.params)))
    return jnet, tnet, T


@pytest.mark.parametrize("model", ["gpt", "char_rnn"])
def test_language_models_cross_both_ways(tmp_path, model):
    """The GPT decoder and the char-RNN (tBPTT windows of 4) under Adam:
    a JAX zip restores into the port and a port zip into the JAX
    package, each continuing in step with the net it was written from."""
    jnet, tnet, T = _lm_twins(model)

    def batch(s):
        tok = np.random.default_rng(s).integers(0, 12, (3, T + 1))
        eye = np.eye(12, dtype=np.float32)
        return eye[tok[:, :-1]], eye[tok[:, 1:]]

    for s in range(2):
        jnet.fit_batch(JDataSet(*batch(s)))
        tnet.fit_batch(DataSet(*batch(s)))
    JSerializer.write_model(jnet, tmp_path / "j.zip")
    ModelSerializer.write_model(tnet, tmp_path / "t.zip")
    t_from_j = ModelSerializer.restore_model(tmp_path / "j.zip",
                                             device="cpu")
    j_from_t = JSerializer.restore_model(tmp_path / "t.zip")
    assert (t_from_j.params_flat().astype("<f4").tobytes() == _members(
        tmp_path / "j.zip")[ModelSerializer.COEFFICIENTS_NAME])
    _assert_leaves_equal(convert.opt_state_to_jax(t_from_j),
                         _jax_leaves(jnet))
    _assert_leaves_equal(_jax_leaves(j_from_t),
                         convert.opt_state_to_jax(tnet))
    for s in range(2, 2 + STEPS):
        x, y = batch(s)
        want_j = float(jnet.fit_batch(JDataSet(x, y)))
        want_t = float(tnet.fit_batch(DataSet(x, y)))
        assert float(t_from_j.fit_batch(DataSet(x, y))) == pytest.approx(
            want_j, rel=LOSS_RTOL)
        assert float(j_from_t.fit_batch(JDataSet(x, y))) == pytest.approx(
            want_t, rel=LOSS_RTOL)
    np.testing.assert_allclose(t_from_j.params_flat(),
                               np.asarray(jnet.params_flat()),
                               rtol=P_TOL, atol=P_TOL)
    np.testing.assert_allclose(np.asarray(j_from_t.params_flat()),
                               tnet.params_flat(), rtol=P_TOL, atol=P_TOL)


# ---------------------------------------------------------------------------
# C10: the container methods, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gpt", "char_rnn", "graph", "stack"])
def test_params_flat_equals_the_jax_vector(model):
    if model in ("gpt", "char_rnn"):
        jnet, tnet, _ = _lm_twins(model)
    else:
        jnet, tnet = _twins(model)
    want = np.asarray(jnet.params_flat())
    got = tnet.params_flat()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tnet.num_params() == want.size


@pytest.mark.parametrize("kind", ["graph", "stack"])
def test_set_params_flat_in_place_and_refuses_a_wrong_length(kind):
    jnet, tnet = _twins(kind)
    ptrs = [t.data_ptr() for t in tnet._flat_order()]
    flat = np.random.default_rng(3).normal(
        size=tnet.num_params()).astype(np.float32)
    tnet.set_params_flat(flat)
    np.testing.assert_array_equal(tnet.params_flat(), flat)
    assert [t.data_ptr() for t in tnet._flat_order()] == ptrs
    # the same vector into the JAX net gives the same function
    jnet.set_params_flat(flat)
    x, _ = _batch(4)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=OUT_TOL)
    for bad in (flat[:-1], np.concatenate([flat, flat[:1]])):
        with pytest.raises(ValueError):
            tnet.set_params_flat(bad * 2.0)
        np.testing.assert_array_equal(tnet.params_flat(), flat)


def test_graph_predict_is_the_argmax_of_output():
    jnet, tnet = _twins("graph")
    x = np.random.default_rng(8).normal(size=(16, F_IN)).astype(np.float32)
    got = tnet.predict(x)
    np.testing.assert_array_equal(
        got, tnet.output(x).argmax(dim=-1).numpy())
    np.testing.assert_array_equal(got, np.asarray(jnet.predict(x)))


def test_clone_shares_no_storage_and_answers_the_same():
    src = _bn_stack_net()
    for s in range(2):
        src.fit_batch(DataSet(*_batch(s)))
    twin = src.clone()
    assert twin.device == src.device
    mine = [t.untyped_storage().data_ptr()
            for d in src.params + src.states for t in d.values()]
    theirs = [t.untyped_storage().data_ptr()
              for d in twin.params + twin.states for t in d.values()]
    assert not set(mine) & set(theirs)
    x, y = _batch(7)
    assert torch.equal(twin.output(x), src.output(x))
    np.testing.assert_array_equal(twin.params_flat(), src.params_flat())
    # training the clone leaves its source as it was
    before = src.params_flat()
    twin.fit_batch(DataSet(x, y))
    np.testing.assert_array_equal(src.params_flat(), before)
    assert not np.array_equal(twin.params_flat(), before)
