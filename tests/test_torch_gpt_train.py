"""The GPT training slice of the port against the JAX package: ``gpt_tiny``
built by both packages, the JAX net's weights carried into the port with
``convert.params_from_jax``, the JAX net's attention through its Pallas
kernels (K4 forward, K5/K6 backward) in interpret mode, then

- ``score`` equals the JAX net's (relative 1e-6);
- the step-1 gradients of every parameter equal ``jax.grad`` of the JAX
  container's ``_loss_fn`` (1e-5), masked and unmasked; the tied head's
  gradient lands in ``embed.W``;
- 5 ``fit_batch`` losses under every updater, masked and unmasked, equal
  the JAX net's (relative 1e-5; the adaptive rules at the model's default
  learning rate, where m / sqrt(v) does not amplify f32 rounding of
  near-zero gradients into the trajectory);

plus the port's own training contracts: dropout (DL4J's retain
probability, inverted scaling, a no-op outside training, repeatable under
one seed; off in cross-framework parity), ``fit`` over a DataSet and an
iterator, the settings ROADMAP A2 brought (in both containers; layerwise
pretraining runs, ROADMAP A7.5), an LSTM graph that trains through the now differentiable
LSTM entry points, and the char data path.
"""

import os

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator, MultiDataSet,
)
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.ops.fused_lstm import (
    fused_lstm, lstm_recurrence,
)

V, T, B = 16, 16, 4
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas attention kernels in interpret mode."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")


def _nets(**kw):
    jnet = JGraph(jgpt.gpt_tiny(vocab_size=V, seq_len=T, **kw)).init()
    conf = tgpt.gpt_tiny(vocab_size=V, seq_len=T, **kw)
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _arrays(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    arrays = [eye[tok[:, :-1]], eye[tok[:, 1:]]]
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[1, 10:] = 0.0
        mask[3, 3:] = 0.0
        arrays += [mask, mask]
    return arrays


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_score_matches_jax(masked):
    jnet, tnet = _nets()
    a = _arrays(1, masked)
    ref = jnet.score(JDataSet(*a))
    assert tnet.score(DataSet(*a)) == pytest.approx(ref, rel=1e-6)


def _step1_grads(masked, **kw):
    jnet, tnet = _nets(**kw)
    a = _arrays(2, masked)
    inputs, labels, masks, lmasks = jnet._split(JDataSet(*a))
    ref = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.states, inputs, labels, masks, lmasks, None)[0])(jnet.params)
    grads, loss, _ = tnet.compute_gradient_and_score(DataSet(*a))
    return jax.tree.map(np.asarray, ref), params_to_numpy(grads), tnet


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_step1_grads_match_jax_grad(masked):
    ref, got, tnet = _step1_grads(masked)
    assert set(got) == set(ref) == set(tnet.params)
    for node, p in ref.items():
        assert set(got[node]) == set(p), node
        for name, r in p.items():
            np.testing.assert_allclose(got[node][name], r, atol=GRAD_TOL,
                                       rtol=GRAD_TOL,
                                       err_msg=f"{node}.{name}")


def test_tied_head_gradient_lands_in_embed_w():
    """The head owns no params; the embedding's W takes the head's
    gradient on top of its own: equal by value to JAX's, and to the sum
    of the two paths' gradients in an untied twin whose head W is the
    embedding's transpose (and whose zero head bias changes nothing)."""
    ref, got, tnet = _step1_grads(False)
    assert got["head"] == {} and tnet.params["head"] == {}
    np.testing.assert_allclose(got["embed"]["W"], ref["embed"]["W"],
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    conf = tgpt.gpt_tiny(vocab_size=V, seq_len=T, tie_weights=False)
    twin = ComputationGraph(conf, device="cpu").init(
        {**{n: {k: t.clone() for k, t in p.items()}
            for n, p in tnet.params.items()},
         "head": {"W": tnet.params["embed"]["W"].T.clone(),
                  "b": torch.zeros(V)}})
    tg, _, _ = twin.compute_gradient_and_score(DataSet(*_arrays(2)))
    split = (tg["embed"]["W"] + tg["head"]["W"].T).numpy()
    np.testing.assert_allclose(got["embed"]["W"], split, atol=1e-6,
                               rtol=1e-6)
    assert np.abs(tg["head"]["W"].numpy()).max() > 1e-3


#: learning rate per updater: the model default for the adaptive rules,
#: larger where the step is proportional to the gradient
LRS = {"adam": 3e-4, "adamax": 3e-4, "rmsprop": 3e-4, "adadelta": 1.0,
       "sgd": 1e-2, "none": 1e-2, "nesterovs": 1e-2, "adagrad": 1e-2}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("updater", sorted(LRS))
def test_fit_batch_losses_match_jax(updater, masked):
    jnet, tnet = _nets(updater=updater, learning_rate=LRS[updater])
    a = _arrays(3, masked)
    ref = [float(jnet.fit_batch(JDataSet(*a))) for _ in range(5)]
    got = [float(tnet.fit_batch(DataSet(*a))) for _ in range(5)]
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert tnet.iteration_count == 5 and tnet.last_batch_size == B
    assert tnet.score_value == pytest.approx(got[-1])
    if updater != "none":
        assert got[-1] != got[0]


def test_params_after_steps_match_jax_by_name():
    jnet, tnet = _nets(updater="sgd", learning_rate=1e-2)
    a = _arrays(4)
    for _ in range(3):
        jnet.fit_batch(JDataSet(*a))
        tnet.fit_batch(DataSet(*a))
    ref = jax.tree.map(np.asarray, jnet.params)
    got = params_to_numpy(tnet.params)
    for node, p in ref.items():
        for name, r in p.items():
            np.testing.assert_allclose(got[node][name], r, atol=1e-5,
                                       rtol=1e-5, err_msg=f"{node}.{name}")


def test_fit_over_dataset_and_iterator_and_loss_falls():
    _, tnet = _nets(learning_rate=1e-2)
    batches = [DataSet(*_arrays(s)) for s in range(3)]
    first = tnet.score(batches[0])
    tnet.fit(ListDataSetIterator(batches), epochs=2)
    assert (tnet.iteration_count, tnet.epoch_count) == (6, 2)
    tnet.fit(batches[0], epochs=2)
    assert (tnet.iteration_count, tnet.epoch_count) == (8, 4)
    assert tnet.score(batches[0]) < first
    with pytest.raises(TypeError):
        tnet.fit([batches[0]])


def test_multidataset_trains_like_its_dataset():
    _, a = _nets(updater="sgd", learning_rate=1e-2)
    _, b = _nets(updater="sgd", learning_rate=1e-2)
    arr = _arrays(5, masked=True)
    la = float(a.fit_batch(DataSet(*arr)))
    lb = float(b.fit_batch(MultiDataSet([arr[0]], [arr[1]], [arr[2]],
                                        [arr[3]])))
    assert la == lb
    b.fit(MultiDataSet([arr[0]], [arr[1]]), epochs=2)
    assert b.iteration_count == 3 and b.epoch_count == 0


# ---------------------------------------------------------------- dropout

def test_dropout_keep_fraction_scale_and_seed():
    layer = DenseLayer(n_out=4, dropout=0.8)
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(7)
    y = layer._dropout_input(x, True, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.all(y[kept] == 1.0 / 0.8)
    again = layer._dropout_input(x, True, torch.Generator().manual_seed(7))
    assert torch.equal(again, y)
    assert layer._dropout_input(x, False, gen) is x
    assert layer._dropout_input(x, True, None) is x
    assert DenseLayer(n_out=4, dropout=1.0)._dropout_input(x, True, gen) is x


def test_dropout_in_the_net_repeats_under_its_seed_and_is_off_in_score():
    def run():
        conf = tgpt.gpt_tiny(vocab_size=V, seq_len=T, dropout=0.7,
                             learning_rate=1e-2)
        net = ComputationGraph(conf, device="cpu").init()
        ds = DataSet(*_arrays(6))
        scores = (net.score(ds), net.score(ds))
        return [float(net.fit_batch(ds)) for _ in range(3)], scores, net
    l1, s1, net = run()
    l2, s2, _ = run()
    assert l1 == l2 and s1 == s2 and s1[0] == s1[1]
    # training draws masks: the training loss differs from the clean one
    grads, loss, _ = net.compute_gradient_and_score(DataSet(*_arrays(6)))
    assert float(loss) != net.score(DataSet(*_arrays(6)))


# ------------------------- the training settings ROADMAP A2 brought

def _refused(net, setting, ds):
    """``net`` takes the training ``setting`` it refused until the
    single-card training features (ROADMAP A2) were ported, and trains
    with it: a finite loss, and the step counted."""
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        DivergenceSentinel,
    )
    t = net.conf.training
    if setting == "scan_window":
        net.fit(ListDataSetIterator([ds] * 4), scan_window=4,
                use_async=False)
        assert net.iteration_count >= 4
        assert np.isfinite(net.score_value)
        return
    if setting == "listeners":
        col = CollectScoresIterationListener()
        net.set_listeners(col)
    elif setting == "sentinel":
        net.set_divergence_sentinel(DivergenceSentinel("raise", lag=0))
    elif setting == "solver":
        t.optimization_algo = "lbfgs"
        t.iterations = 2
    elif setting == "remat":
        t.remat = True
    elif setting == "bf16":
        t.precision = "bf16"
    loss = float(net.fit_batch(ds))
    assert np.isfinite(loss)
    assert net.iteration_count >= 1
    if setting == "listeners":
        assert [it for it, _ in col.scores] == list(
            range(1, net.iteration_count + 1))


UNPORTED = ["solver", "remat", "bf16", "scan_window", "listeners",
            "sentinel"]


@pytest.mark.parametrize("setting", UNPORTED)
def test_unported_training_paths_raise(setting):
    """The graph refused these settings until ROADMAP A2; each now
    trains."""
    _, net = _nets()
    _refused(net, setting, DataSet(*_arrays(0)))


@pytest.mark.parametrize("setting", UNPORTED + ["pretrain"])
def test_multilayer_unported_training_paths_raise(setting):
    """The sequential container takes what the graph takes (the
    line-search solvers with ``optimization_algo="lbfgs"`` among them).
    Layerwise pretraining (ROADMAP A7.5) runs: the char-RNN has no layer
    that can pretrain, so ``pretrain`` walks past every layer and leaves
    the params bit for bit as they were."""
    net = MultiLayerNetwork(char_rnn_lstm(5, hidden=4, layers=1),
                            device="cpu").init()
    eye = np.eye(5, dtype=np.float32)
    ds = DataSet(eye[np.arange(12).reshape(2, 6) % 5],
                 eye[np.arange(1, 13).reshape(2, 6) % 5])
    if setting == "pretrain":
        before = net.params_flat()
        net.pretrain(ListDataSetIterator([ds]))
        np.testing.assert_array_equal(net.params_flat(), before)
        return
    _refused(net, setting, ds)


def test_builder_setters_reach_the_training_config():
    conf = (NeuralNetConfiguration.builder().updater("adam")
            .lr_policy("step", decay_rate=0.5, steps=3.0).minimize(False)
            .optimization_algo("SGD").precision("fp32", loss_scale=2.0)
            .gradient_checkpointing(False).l2(1e-3)
            .graph_builder().add_inputs("in")
            .add_layer("out", RnnOutputLayer(n_out=3, activation="softmax"),
                       "in")
            .set_outputs("out").set_input_types(InputType.recurrent(3, 4))
            .build())
    t = conf.training
    assert (t.updater.lr_policy, t.updater.lr_policy_decay_rate,
            t.updater.lr_policy_steps) == ("step", 0.5, 3.0)
    assert (t.minimize, t.optimization_algo, t.precision, t.loss_scale,
            t.remat) == (False, "sgd", "fp32", 2.0, False)
    assert conf.nodes["out"].layer.regularization() == {
        "W": (0.0, 1e-3), "b": (0.0, 0.0)}


def _lstm_graph():
    return (NeuralNetConfiguration.builder().updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("lstm", LSTM(n_out=8, activation="tanh"), "in")
            .add_layer("out", RnnOutputLayer(n_out=5, activation="softmax"),
                       "lstm")
            .set_outputs("out").set_input_types(InputType.recurrent(5, 6))
            .build())


def test_fit_batch_on_an_lstm_graph_trains():
    """A training step through the LSTM (an unmasked tanh/sigmoid LSTM
    takes the kernel path, K2/K3's plain versions here) moves every one
    of its params and lowers the loss; serving still runs."""
    net = ComputationGraph(_lstm_graph(), device="cpu").init()
    rng = np.random.default_rng(0)
    eye = np.eye(5, dtype=np.float32)
    ds = DataSet(eye[rng.integers(0, 5, (2, 6))], eye[rng.integers(0, 5,
                                                                   (2, 6))])
    before = {k: t.clone() for k, t in net.params["lstm"].items()}
    first = float(net.fit_batch(ds))
    assert np.isfinite(first) and net.iteration_count == 1
    assert not any(torch.equal(before[k], t)
                   for k, t in net.params["lstm"].items())
    for _ in range(5):
        net.fit_batch(ds)
    assert net.score(ds) < first
    assert net.output(ds.features).shape == (2, 6, 5)


def test_lstm_kernel_entry_points_are_differentiable():
    """Grad-requiring inputs give outputs with a grad_fn whose backward
    reaches every input (xz, rw, pw, h0, c0; W of the batch-major entry
    point); without grad mode the same call records nothing."""
    T_, B_, H = 3, 2, 4
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(*s, generator=g).requires_grad_() for s in (
        (T_, B_, 4 * H), (H, 4 * H), (3, H), (B_, H), (B_, H))]
    hs, hT, cT = lstm_recurrence(*args)
    assert hs.grad_fn is not None and cT.grad_fn is not None
    (hs.sum() + hT.sum() + cT.sum()).backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               and a.grad.abs().sum() > 0 for a in args)
    with torch.no_grad():
        hs, _, _ = lstm_recurrence(*args)
    assert hs.shape == (T_, B_, H) and hs.grad_fn is None
    x = torch.randn(B_, T_, 5, generator=g)
    w = torch.randn(5, 4 * H, generator=g, requires_grad=True)
    ys, _, _ = fused_lstm(x, w, args[1].detach(), torch.zeros(4 * H), None,
                          args[3].detach(), args[4].detach())
    assert ys.grad_fn is not None
    ys.sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0


def test_flash_attention_output_has_a_grad_fn_on_cpu():
    q, k, v = (torch.randn(1, 2, 8, 4, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# ------------------------------------------------------------ data path

def test_char_data_path_matches_jax():
    text = tgpt.synthetic_char_text(3000, seed=3)
    assert text == jgpt.synthetic_char_text(3000, seed=3)
    assert tgpt.char_vocab(text) == jgpt.char_vocab(text)
    charset = "".join(chr(i) for i in range(32, 127)) + "\n"
    got = tgpt.char_lm_batches(text, 32, 8, charset=charset, max_batches=3)
    ref = jgpt.char_lm_batches(text, 32, 8, charset=charset, max_batches=3)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.features.shape == (8, 32, 96)
        np.testing.assert_array_equal(g.features, r.features)
        np.testing.assert_array_equal(g.labels, r.labels)


def test_params_to_numpy_round_trips():
    _, tnet = _nets()
    arrays = params_to_numpy(tnet.params)
    back = params_from_jax(tnet.conf, arrays)
    assert all(torch.equal(back[n][k], t)
               for n, p in tnet.params.items() for k, t in p.items())
    assert params_to_numpy([{"W": torch.ones(2, dtype=torch.bfloat16)}])[0][
        "W"].dtype == np.float32


def test_jax_side_runs_the_pallas_kernels():
    assert os.environ["DL4J_TPU_PALLAS"] == "interpret"
