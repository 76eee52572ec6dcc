"""The LSTM training slice of the port against the JAX package: the
char-RNN (``char_rnn_lstm(vocab 12, hidden 16, layers 2, tbptt 5)``) and
small LSTM nets built by both packages, the JAX net's weights carried into
the port with ``convert.params_from_jax``, the JAX side's LSTMs through
its Pallas kernels K1/K2/K3 in interpret mode, then

- ``score`` and the step-1 gradients of every parameter against
  ``jax.grad`` of the JAX container's ``_loss_fn`` (1e-5), unmasked (the
  kernel path) and masked (the ``_lstm_cell`` loop);
- ``fit_batch`` on ``[3, 12]`` (tBPTT windows 5 + 5 + 2) under Adam and
  SGD: each window's loss, the returned mean, the iteration count and the
  params after the call (relative 1e-5), in truncated BPTT, with masks,
  with ``tbptt_bwd_length`` < ``tbptt_fwd_length`` and in standard BPTT;
- the port's versions of ``tests/test_tbptt_bwd.py`` and of the graph
  tBPTT tests of ``tests/test_graph_rnn.py``, held against the JAX nets;

plus the port's own contracts: the rank-2-labels refusal, input dropout
on the carry path in training only, ``fit`` over its three inputs, the
flat parameter view, the graph builder's tBPTT settings and check, and a
bidirectional stack (whose ``*_bwd`` params ``convert`` carries across).
Dropout stays off in cross-framework parity.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.datasets.dataset import (
    DataSet as JDataSet, MultiDataSet as JMultiDataSet,
)
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.nn.conf import graph as jgraphconf
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator, MultiDataSet,
)
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.nn.conf import graph as tgraphconf
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

ROOT = Path(__file__).resolve().parent.parent
V, HID, TBPTT = 12, 16, 5
B, T = 3, 12
GRAD_TOL = 1e-5
RTOL = 1e-5
#: params after a step: relative 1e-5, with an absolute floor for entries
#: near zero
P_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas LSTM kernels in interpret mode."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")


def _char_nets(**kw):
    jnet = JNet(jchar_rnn(V, hidden=HID, layers=2, tbptt_length=TBPTT,
                          **kw)).init()
    conf = char_rnn_lstm(V, hidden=HID, layers=2, tbptt_length=TBPTT, **kw)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _char_arrays(seed, masked=False, b=B, t=T):
    tok = np.random.default_rng(seed).integers(0, V, (b, t + 1))
    eye = np.eye(V, dtype=np.float32)
    arrays = [eye[tok[:, :-1]], eye[tok[:, 1:]]]
    if masked:
        mask = np.ones((b, t), np.float32)
        mask[1, 7:] = 0.0
        mask[2, 3:] = 0.0
        arrays += [mask, mask]
    return arrays


def _assert_params_match(tnet, jnet):
    ref = jax.tree.map(np.asarray, jnet.params)
    got = params_to_numpy(tnet.params)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=RTOL, atol=P_ATOL,
                                       err_msg=f"layer {i} {k}")


# ------------------------------------------------------ the char-RNN vs JAX

@pytest.mark.parametrize("masked", [False, True], ids=["kernel", "masked"])
def test_score_and_step1_grads_match_jax(masked):
    """The loss and every gradient over the whole [3, 12] sequence (no
    windows): unmasked through the fused path on both sides, masked
    through the step loops."""
    jnet, tnet = _char_nets()
    a = _char_arrays(1, masked)
    assert tnet.score(DataSet(*a)) == pytest.approx(
        jnet.score(JDataSet(*a)), rel=1e-6)
    fm, lm = (jnp.asarray(a[2]), jnp.asarray(a[3])) if masked else (None,
                                                                   None)
    ref = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.states, jnp.asarray(a[0]), jnp.asarray(a[1]), fm, lm,
        None)[0])(jnet.params)
    grads, loss, _ = tnet.compute_gradient_and_score(DataSet(*a))
    assert float(loss) == pytest.approx(jnet.score(JDataSet(*a)), rel=1e-6)
    got = params_to_numpy(grads)
    for i, (g, r) in enumerate(zip(got, jax.tree.map(np.asarray, ref))):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], atol=GRAD_TOL,
                                       rtol=GRAD_TOL,
                                       err_msg=f"layer {i} {k}")


class _Scores:
    """A JAX listener that keeps each iteration's loss."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))


def _window_losses(tnet):
    """Record the loss of each of the port net's optimizer steps."""
    losses = []
    step = tnet._step

    def spy(grads, new_states, loss):
        losses.append(float(loss))
        step(grads, new_states, loss)
    tnet._step = spy
    return losses


#: learning rate per updater: the model's own for Adam, a step large
#: enough to move the params for SGD
UPDATERS = {"adam": 1e-3, "sgd": 0.1}


@pytest.mark.parametrize("variant", ["tbptt", "masked", "bwd_lt_fwd",
                                     "standard"])
@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_fit_batch_window_losses_and_params_match_jax(updater, variant):
    """Two ``fit_batch`` calls on [3, 12]: tBPTT takes windows of 5, 5 and
    2 (the short last one), one optimizer step each, with the carries
    detached between them; ``bwd_lt_fwd`` (bwd 2) runs each window's head
    without a graph; ``standard`` takes one step over the whole sequence.
    Each step's loss, the returned mean, the counts and the params equal
    the JAX net's."""
    kw = dict(updater=updater, learning_rate=UPDATERS[updater])
    jnet, tnet = _char_nets(**kw)
    for net in (jnet, tnet):
        if variant == "bwd_lt_fwd":
            net.conf.training.tbptt_bwd_length = 2
        elif variant == "standard":
            net.conf.training.backprop_type = "standard"
    a = _char_arrays(2, variant == "masked")
    listener = _Scores()
    jnet.set_listeners(listener)
    got_steps = _window_losses(tnet)
    for _ in range(2):
        ref = float(jnet.fit_batch(JDataSet(*a)))
        got = float(tnet.fit_batch(DataSet(*a)))
        assert got == pytest.approx(ref, rel=RTOL)
    steps = 2 if variant == "standard" else 6
    assert len(got_steps) == len(listener.scores) == steps
    np.testing.assert_allclose(got_steps, listener.scores, rtol=RTOL)
    assert tnet.iteration_count == jnet.iteration_count == steps
    assert tnet.last_batch_size == B
    assert tnet.score_value == pytest.approx(got_steps[-1])
    if variant != "standard":
        assert got == pytest.approx(np.mean(got_steps[3:]), rel=1e-6)
    _assert_params_match(tnet, jnet)


def test_tbptt_needs_time_distributed_labels():
    """Rank-3 features with rank-2 labels raise the JAX ValueError before
    any step."""
    jnet, tnet = _char_nets()
    x, y = _char_arrays(3)
    for net, ds in ((jnet, JDataSet(x, y[:, -1])), (tnet, DataSet(x, y[:,
                                                                     -1]))):
        with pytest.raises(ValueError, match="rank-3"):
            net.fit_batch(ds)
    assert tnet.iteration_count == 0


def test_fit_over_its_inputs_counts_windows_and_loss_falls():
    """The port of tests/test_models.py::test_char_rnn_tbptt_trains: fit
    over a DataSet takes 12 / 5 -> 3 windows, one iteration each, like the
    JAX net; then over an iterator and over (features, labels) arrays, for
    epochs; the loss falls."""
    jnet, tnet = _char_nets()
    x, y = _char_arrays(4)
    jnet.fit(JDataSet(x, y), use_async=False)
    tnet.fit(DataSet(x, y))
    assert tnet.iteration_count == jnet.iteration_count == 3
    assert np.isfinite(tnet.score_value)
    first = tnet.score(DataSet(x, y))
    tnet.fit(ListDataSetIterator([DataSet(*_char_arrays(s))
                                  for s in (4, 5)]), epochs=2)
    assert (tnet.iteration_count, tnet.epoch_count) == (15, 3)
    tnet.fit(x, y, epochs=3)
    assert (tnet.iteration_count, tnet.epoch_count) == (24, 6)
    assert tnet.score(DataSet(x, y)) < first
    with pytest.raises(TypeError):
        tnet.fit([DataSet(x, y)])


def test_params_flat_round_trips_and_matches_jax():
    jnet, tnet = _char_nets()
    flat = tnet.params_flat()
    np.testing.assert_array_equal(flat, jnet.params_flat())
    before = params_to_numpy(tnet.params)
    tnet.set_params_flat(flat * 2.0)
    after = params_to_numpy(tnet.params)
    assert all(np.array_equal(after[i][k], 2.0 * before[i][k])
               for i in range(len(before)) for k in before[i])
    with pytest.raises(ValueError):
        tnet.set_params_flat(flat[:-1])


# -------------------------------- the port of tests/test_tbptt_bwd.py

def _lstm_nets(backprop_type="standard", fwd=20, bwd=20, seed=11):
    """LSTM(6) -> RnnOutputLayer(3), SGD at 0.05, from both packages."""
    def build(nnc, rec, itype):
        b = (nnc.builder().seed(seed).updater("sgd").learning_rate(0.05)
             .list()
             .layer(rec.LSTM(n_out=6, activation="tanh"))
             .layer(rec.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent")))
        b.backprop_type(backprop_type, fwd, bwd)
        return b.set_input_type(itype.recurrent(4, 6)).build()
    jnet = JNet(build(JNNC, jrec, JInputType)).init()
    conf = build(NeuralNetConfiguration, trec, InputType)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _seq_arrays(seed, b=3, t=6, f=4, c=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, f)).astype(np.float32),
            np.eye(c, dtype=np.float32)[rng.integers(0, c, (b, t))])


def test_tbptt_covering_window_equals_standard_bptt():
    """fwd = bwd >= T: one window and a full backward, the same update as
    standard backprop; both equal the JAX nets'."""
    a = _seq_arrays(5, t=6)
    jfull, full = _lstm_nets("standard")
    jtb, tb = _lstm_nets("truncated_bptt", fwd=10, bwd=10)
    np.testing.assert_array_equal(full.params_flat(), tb.params_flat())
    for j, t in ((jfull, full), (jtb, tb)):
        j.fit_batch(JDataSet(*a))
        t.fit_batch(DataSet(*a))
        _assert_params_match(t, j)
    np.testing.assert_allclose(full.params_flat(), tb.params_flat(),
                               rtol=2e-6, atol=1e-7)


def test_tbptt_bwd_shorter_than_fwd_truncates():
    """bwd < fwd really truncates: the params move away from the
    full-window run's, and each run equals its JAX twin."""
    a = _seq_arrays(6, t=8)
    jfull, full = _lstm_nets("truncated_bptt", fwd=8, bwd=8)
    jtrunc, trunc = _lstm_nets("truncated_bptt", fwd=8, bwd=3)
    for j, t in ((jfull, full), (jtrunc, trunc)):
        j.fit_batch(JDataSet(*a))
        t.fit_batch(DataSet(*a))
        _assert_params_match(t, j)
    assert not np.allclose(full.params_flat(), trunc.params_flat())


def test_tbptt_bwd_gradient_equivalence():
    """The bwd < fwd step equals the manual construction: the window's
    head forward without a graph (stopped carry and activations), the
    loss summed over head and tail, SGD applied; the JAX net agrees."""
    Tn, bwd, lr = 8, 3, 0.05
    split = Tn - bwd
    x, y = _seq_arrays(7, t=Tn)
    jnet, net = _lstm_nets("truncated_bptt", fwd=8, bwd=bwd)
    p0 = [{k: v.clone().requires_grad_() for k, v in p.items()}
          for p in net.params]
    lstm, out = net.layers
    feats, labels = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        h1, c1 = lstm.scan(p0[0], feats[:, :split],
                           lstm.initial_carry(feats.shape[0]), None)
    h2, _ = lstm.scan(p0[0], feats[:, split:], c1, None)
    (out.compute_loss(p0[1], h1, labels[:, :split])
     + out.compute_loss(p0[1], h2, labels[:, split:])).backward()
    net.fit_batch(DataSet(x, y))
    jnet.fit_batch(JDataSet(x, y))
    for li in range(2):
        for k, p in p0[li].items():
            want = (p - lr * p.grad).detach()
            np.testing.assert_allclose(net.params[li][k].numpy(),
                                       want.numpy(), rtol=2e-5, atol=1e-6,
                                       err_msg=f"layer {li} {k}")
    _assert_params_match(net, jnet)


# ------------------------------------------------ dropout on the carry path

def _carry_forward(net, x, train, seed):
    carries = [l.initial_carry(x.shape[0]) if getattr(
        l, "supports_carry", False) else None for l in net.layers]
    return net._forward(net.params, net.states, x, train=train,
                        rng=torch.Generator().manual_seed(seed),
                        carries=carries)[0]


def test_input_dropout_fires_on_the_carry_path_in_training_only():
    """tBPTT runs the LSTMs through ``scan`` from their carries, bypassing
    ``apply``: their input dropout fires there all the same, drawing
    what ``apply`` draws from the same seed, and only in training; so a
    training window differs from the clean forward, and streaming
    (``rnn_time_step``, inference) equals ``output()``."""
    conf = char_rnn_lstm(V, hidden=HID, layers=2, tbptt_length=TBPTT)
    for layer in conf.layers:
        layer.dropout = 0.6
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = torch.from_numpy(_char_arrays(8)[0])
    train = _carry_forward(net, x, True, 3)
    applied = net._forward(net.params, net.states, x, train=True,
                           rng=torch.Generator().manual_seed(3))[0]
    assert torch.equal(train, applied)
    clean = _carry_forward(net, x, False, 3)
    assert torch.equal(clean, net._forward(net.params, net.states, x)[0])
    assert not torch.allclose(train, clean)
    stream = torch.stack([net.rnn_time_step(x[:, t]) for t in range(T)], 1)
    torch.testing.assert_close(stream, net.output(x), atol=1e-5, rtol=0)
    # and in the graph's carry walk
    gnet = ComputationGraph(_graph_confs(dropout=0.6)[1], device="cpu").init()
    xs = {"in": torch.from_numpy(_seq_arrays(9)[0])}
    walk = [gnet._forward(gnet.params, gnet.states, xs, None, {},
                          train=t, rng=torch.Generator().manual_seed(4))[0]
            ["lstm"] for t in (True, False)]
    applied = gnet._forward(gnet.params, gnet.states, xs, None, train=True,
                            rng=torch.Generator().manual_seed(4))[0]["lstm"]
    assert torch.equal(walk[0], applied)
    assert not torch.allclose(walk[0], walk[1])


# --------------------------------------------- a bidirectional LSTM stack

def test_bidirectional_stack_trains_like_jax():
    """GravesBidirectionalLSTM (its ``*_bwd`` params carried across by
    ``convert``) -> RnnOutputLayer in standard BPTT: the step-1 gradients
    of both directions and 3 Adam steps' losses equal the JAX net's."""
    def build(nnc, rec, itype):
        return (nnc.builder().seed(5).updater("adam", learning_rate=1e-2)
                .list()
                .layer(rec.GravesBidirectionalLSTM(n_out=7,
                                                   activation="tanh"))
                .layer(rec.RnnOutputLayer(n_out=3, activation="softmax"))
                .set_input_type(itype.recurrent(4)).build())
    jnet = JNet(build(JNNC, jrec, JInputType)).init()
    conf = build(NeuralNetConfiguration, trec, InputType)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    assert set(tnet.params[0]) == {"W", "RW", "b", "pW", "W_bwd", "RW_bwd",
                                   "b_bwd", "pW_bwd"}
    x, y = _seq_arrays(10, t=5)
    ref = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.states, jnp.asarray(x), jnp.asarray(y), None, None,
        None)[0])(jnet.params)
    grads, _, _ = tnet.compute_gradient_and_score(DataSet(x, y))
    for k, r in ref[0].items():
        np.testing.assert_allclose(grads[0][k].numpy(), np.asarray(r),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)
    got = [float(tnet.fit_batch(DataSet(x, y))) for _ in range(3)]
    want = [float(jnet.fit_batch(JDataSet(x, y))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ------------------------------------- ComputationGraph tBPTT vs JAX

def _graph_confs(backprop_type="standard", fwd=20, bwd=20, seed=11,
                 dropout=None):
    """in -> LSTM(6) -> RnnOutputLayer(3), SGD at 0.05, from both
    packages (tests/test_graph_rnn.py's net)."""
    def build(nnc, rec, itype):
        b = nnc.builder().seed(seed).updater("sgd").learning_rate(0.05)
        if dropout is not None:
            b = b.dropout(dropout)
        b = (b.graph_builder().add_inputs("in")
             .add_layer("lstm", rec.LSTM(n_out=6, activation="tanh"), "in")
             .add_layer("out", rec.RnnOutputLayer(
                 n_out=3, activation="softmax", loss="mcxent"), "lstm")
             .set_outputs("out"))
        b.backprop_type(backprop_type, fwd, bwd)
        return b.set_input_types(itype.recurrent(4, 6)).build()
    return (build(JNNC, jrec, JInputType),
            build(NeuralNetConfiguration, trec, InputType))


def _graph_nets(*args, **kw):
    jconf, conf = _graph_confs(*args, **kw)
    jnet = JGraph(jconf).init()
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _assert_graph_params_match(tnet, jnet, rtol=RTOL, atol=P_ATOL):
    ref = jax.tree.map(np.asarray, jnet.params)
    got = params_to_numpy(tnet.params)
    assert set(got) == set(ref)
    for n, p in ref.items():
        for k, r in p.items():
            np.testing.assert_allclose(got[n][k], r, rtol=rtol, atol=atol,
                                       err_msg=f"{n}.{k}")


def _graph_flat(net):
    return np.concatenate([v.ravel() for p in params_to_numpy(
        net.params).values() for v in p.values()])


def test_graph_tbptt_covering_window_equals_standard_bptt():
    a = _seq_arrays(11, t=6)
    jfull, full = _graph_nets("standard")
    jtb, tb = _graph_nets("truncated_bptt", fwd=10, bwd=10)
    for j, t in ((jfull, full), (jtb, tb)):
        j.fit_batch(JDataSet(*a))
        t.fit_batch(DataSet(*a))
        _assert_graph_params_match(t, j)
    np.testing.assert_allclose(_graph_flat(full), _graph_flat(tb),
                               rtol=2e-6, atol=1e-7)


def test_graph_tbptt_slices_carry_state():
    """fwd < T: windows of 4 with the carried state differ from standard
    BPTT, keep training, and equal the JAX net step for step."""
    a = _seq_arrays(12, t=8)
    jtb, tb = _graph_nets("truncated_bptt", fwd=4, bwd=4)
    _, full = _graph_nets("standard")
    first = float(tb.fit_batch(DataSet(*a)))
    assert first == pytest.approx(float(jtb.fit_batch(JDataSet(*a))),
                                  rel=RTOL)
    full.fit_batch(DataSet(*a))
    assert not np.allclose(_graph_flat(tb), _graph_flat(full))
    for _ in range(10):
        last = float(tb.fit_batch(DataSet(*a)))
        ref = float(jtb.fit_batch(JDataSet(*a)))
        assert last == pytest.approx(ref, rel=RTOL)
    assert last < first and tb.iteration_count == jtb.iteration_count == 22
    _assert_graph_params_match(tb, jtb)


def test_graph_tbptt_bwd_gradient_equivalence():
    Tn, bwd, lr = 8, 3, 0.05
    split = Tn - bwd
    x, y = _seq_arrays(13, t=Tn)
    jnet, net = _graph_nets("truncated_bptt", fwd=8, bwd=bwd)
    p0 = {n: {k: v.clone().requires_grad_() for k, v in p.items()}
          for n, p in net.params.items()}
    lstm = net.conf.nodes["lstm"].layer
    out = net.conf.nodes["out"].layer
    feats, labels = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        h1, c1 = lstm.scan(p0["lstm"], feats[:, :split],
                           lstm.initial_carry(feats.shape[0]), None)
    h2, _ = lstm.scan(p0["lstm"], feats[:, split:], c1, None)
    (out.compute_loss(p0["out"], h1, labels[:, :split])
     + out.compute_loss(p0["out"], h2, labels[:, split:])).backward()
    net.fit_batch(DataSet(x, y))
    jnet.fit_batch(JDataSet(x, y))
    for n, p in p0.items():
        for k, v in p.items():
            np.testing.assert_allclose(
                net.params[n][k].numpy(), (v - lr * v.grad).detach().numpy(),
                rtol=2e-5, atol=1e-6, err_msg=f"{n}.{k}")
    _assert_graph_params_match(net, jnet)


def test_graph_tbptt_mixed_static_input_not_sliced():
    """An rnn input and a static feed-forward side input under tBPTT (the
    static one duplicated over each window's steps and merged): the
    static input passes through unsliced, and 9 steps equal the JAX
    net's."""
    def build(nnc, rec, gc, itype):
        b = (nnc.builder().seed(3).updater("sgd").learning_rate(0.05)
             .graph_builder().add_inputs("seq", "static")
             .add_layer("lstm", rec.LSTM(n_out=6, activation="tanh"), "seq")
             .add_vertex("dup", gc.DuplicateToTimeSeriesVertex("seq"),
                         "static")
             .add_vertex("cat", gc.MergeVertex(), "lstm", "dup")
             .add_layer("out", rec.RnnOutputLayer(
                 n_out=3, activation="softmax", loss="mcxent"), "cat")
             .set_outputs("out"))
        b.backprop_type("truncated_bptt", 4, 4)
        return b.set_input_types(itype.recurrent(4, 8),
                                 itype.feed_forward(5)).build()
    jnet = JGraph(build(JNNC, jrec, jgraphconf, JInputType)).init()
    conf = build(NeuralNetConfiguration, trec, tgraphconf, InputType)
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    rng = np.random.default_rng(14)
    seq = rng.normal(size=(3, 8, 4)).astype(np.float32)
    static = rng.normal(size=(3, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 8))]
    got = [float(tnet.fit_batch(MultiDataSet([seq, static], [y])))
           for _ in range(9)]
    want = [float(jnet.fit_batch(JMultiDataSet([seq, static], [y])))
            for _ in range(9)]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(got[0]) and got[-1] < got[0]
    _assert_graph_params_match(tnet, jnet)


def test_graph_builder_tbptt_settings_and_check():
    """``backprop_type`` reaches the training config, and under tBPTT a
    non-time-distributed output fails at build time, as in JAX."""
    conf = _graph_confs("truncated_bptt", 7, 3)[1]
    t = conf.training
    assert (t.backprop_type, t.tbptt_fwd_length, t.tbptt_bwd_length) == \
        ("truncated_bptt", 7, 3)
    with pytest.raises(ValueError, match="truncated_bptt"):
        (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .add_layer("lstm", trec.LSTM(n_out=3), "in")
         .add_layer("last", trec.LastTimeStepLayer(), "lstm")
         .set_outputs("last").backprop_type("truncated_bptt")
         .set_input_types(InputType.recurrent(4)).build())
    jnet, tnet = _graph_nets("truncated_bptt", 4, 4)
    x, y = _seq_arrays(15)
    for net, ds in ((jnet, JDataSet(x, y[:, -1])), (tnet, DataSet(x, y[:,
                                                                     -1]))):
        with pytest.raises(ValueError, match="rank-3"):
            net.fit_batch(ds)


def test_import_check_walks_the_lstm_training_modules():
    """tests/test_torch_gpt.py bans JAX imports in every .py under the port
    package; this slice's new module is among the files it walks, and its
    kernels' sources sit in csrc/."""
    pkg = ROOT / "deeplearning4j_tpu_torch"
    assert pkg / "nn" / "netcommon.py" in set(pkg.rglob("*.py"))
    for src in ("lstm_fwd_train.cu", "lstm_bwd.cu", "lstm_common.cuh"):
        assert (pkg / "csrc" / src).exists()
