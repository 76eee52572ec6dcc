"""The core layers and loss heads of the CNN slice against the JAX
package: ``OutputLayer``, ``LossLayer``, ``CenterLossOutputLayer`` (with
its centers' moving average after ``fit_batch``), ``EmbeddingLayer``,
``ActivationLayer`` and ``DropoutLayer``; an MLP classifier trained for 5
steps; ``Evaluation`` and ``evaluate()``; and the MNIST stand-in. Weights
are drawn by the JAX side and carried across with ``convert``; inputs
are numpy, from a fixed seed; dropout stays off across frameworks.

Tolerances: forward 1e-5 x max(1, max |y|); gradients 1e-4 of each
tensor's largest |g|; losses 1e-5 relative at step 1 and 1e-4 after;
params after the steps 1e-4 relative (Adam's m / sqrt(v) amplifies the
last bits of a gradient), 1e-6 absolute.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.datasets.mnist import (
    MnistDataSetIterator as JMnistIterator,
)
from deeplearning4j_tpu.eval.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_tpu_torch.convert import (
    layer_params_from_jax, params_from_jax, params_to_numpy,
)
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator, MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL_1 = 1e-5
LOSS_RTOL = 1e-4
P_RTOL, P_ATOL = 1e-4, 1e-6
B, F, C = 6, 8, 5


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _onehot(seed, n=B, c=C, absent=()):
    rng = np.random.default_rng(seed)
    classes = [k for k in range(c) if k not in absent]
    return np.eye(c, dtype=np.float32)[rng.choice(classes, n)]


def _pair(jl, tl, n_in=F, seed=0):
    jl.set_n_in(JInputType.feed_forward(n_in))
    tl.set_n_in(InputType.feed_forward(n_in))
    jp = jl.init_params(jax.random.PRNGKey(seed))
    return jp, layer_params_from_jax(
        tl, {k: np.asarray(v) for k, v in jp.items()})


def _close(got, want, tol=FWD_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0)


# ------------------------------------------------------------ loss heads

@pytest.mark.parametrize("name,act,loss", [
    ("OutputLayer", "softmax", "mcxent"),
    ("OutputLayer", "sigmoid", "xent"),
    ("OutputLayer", "identity", "mse"),
    ("LossLayer", "softmax", "mcxent"),
    ("LossLayer", "identity", "l2"),
    ("CenterLossOutputLayer", "softmax", "mcxent"),
])
def test_loss_head(name, act, loss):
    """``apply`` and ``compute_loss`` (mean, per example, with an example
    mask) from the head's input, and the loss's gradients with respect to
    the input and every param."""
    kw = dict(activation=act, loss=loss)
    if name != "LossLayer":
        kw["n_out"] = C
    if name == "CenterLossOutputLayer":
        kw.update(alpha=0.3, lambda_=0.5)
    jl, tl = getattr(jcore, name)(**kw), getattr(tcore, name)(**kw)
    n_in = C if name == "LossLayer" else F
    jp, tp = _pair(jl, tl, n_in)
    if name == "CenterLossOutputLayer":
        jp["cL"] = jnp.asarray(_x(3, C, F))
        tp["cL"] = torch.from_numpy(np.array(jp["cL"]))
    x, y = _x(1, B, n_in), _onehot(2)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)

    out, _ = tl.apply(tp, torch.from_numpy(x), state={})
    jout, _ = jl.apply(jp, jnp.asarray(x), state={}, train=False, rng=None)
    _close(out.numpy(), jout)
    for average, m in ((True, None), (False, None), (True, mask)):
        want = jl.compute_loss(jp, jnp.asarray(x), jnp.asarray(y),
                               mask=None if m is None else jnp.asarray(m),
                               average=average)
        got = tl.compute_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                              mask=None if m is None
                              else torch.from_numpy(m), average=average)
        _close(got.numpy(), want)

    jg_p, jg_x = jax.grad(lambda p, xx: jl.compute_loss(
        p, xx, jnp.asarray(y)), argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tl.compute_loss(leaves, tx, torch.from_numpy(y)).backward()
    grads = {"x": (tx.grad, jg_x)}
    grads.update({k: (leaves[k].grad, jg_p[k]) for k in leaves})
    for k, (got, want) in grads.items():
        want = np.asarray(want)
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30),
            err_msg=k)


def test_output_layer_refuses_a_shape_mismatch():
    tl = tcore.OutputLayer(n_out=C, activation="softmax")
    tl.set_n_in(InputType.feed_forward(F))
    tp = tl.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="RnnOutputLayer"):
        tl.compute_loss(tp, torch.zeros(B, F), torch.zeros(B, C + 1))


def test_center_loss_regularizes_no_centers():
    tl = tcore.CenterLossOutputLayer(n_out=C, l1=0.1, l2=0.2)
    assert tl.regularization()["cL"] == (0.0, 0.0)
    assert tl.regularization()["W"] == (0.1, 0.2)


# --------------------------------------------------- parameterless layers

def test_embedding_layer():
    kw = dict(n_out=6, activation="tanh", bias_init=0.2)
    jl, tl = jcore.EmbeddingLayer(**kw), tcore.EmbeddingLayer(**kw)
    jl.n_in = tl.n_in = 11
    jp = jl.init_params(jax.random.PRNGKey(4))
    tp = layer_params_from_jax(tl, {k: np.asarray(v) for k, v in jp.items()})
    idx = np.random.default_rng(5).integers(0, 11, (B, 1)).astype(np.float32)
    for x in (idx, idx[:, 0]):
        want, _ = jl.apply(jp, jnp.asarray(x), state={}, train=False,
                           rng=None)
        got, _ = tl.apply(tp, torch.from_numpy(x), state={})
        _close(got.numpy(), want)


def test_activation_and_dropout_layers():
    x = _x(6, B, F)
    jl, tl = (jcore.ActivationLayer(activation="relu"),
              tcore.ActivationLayer(activation="relu"))
    want, _ = jl.apply({}, jnp.asarray(x), state={}, train=False, rng=None)
    _close(tl.apply({}, torch.from_numpy(x), state={})[0].numpy(), want)
    # dropout: identity outside training; in training each element is
    # kept with the retain probability and scaled by its inverse
    tl = tcore.DropoutLayer(dropout=0.5)
    tx = torch.from_numpy(np.abs(x) + 1.0)
    assert torch.equal(tl.apply({}, tx, state={})[0], tx)
    out, _ = tl.apply({}, tx, state={}, train=True,
                      rng=torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0 < int(kept.sum()) < tx.numel()
    assert torch.allclose(out[kept], tx[kept] / 0.5)
    assert tl.param_order() == [] and \
        tl.infer_output_type(InputType.feed_forward(F)).flat_size() == F


# ------------------------------------------------------------- containers

def _mlp(pkg, updater="adam", head="OutputLayer", **head_kw):
    nnc = JNNC if pkg == "jax" else NeuralNetConfiguration
    layers = jcore if pkg == "jax" else tcore
    it = JInputType if pkg == "jax" else InputType
    return (nnc.builder().seed(7).updater(updater, learning_rate=0.05)
            .weight_init("xavier").list()
            .layer(layers.DenseLayer(n_out=12, activation="relu"))
            .layer(layers.DenseLayer(n_out=10, activation="tanh"))
            .layer(getattr(layers, head)(n_out=C, activation="softmax",
                                         loss="mcxent", **head_kw))
            .set_input_type(it.feed_forward(F)).build())


def _nets(**kw):
    jnet = JNet(_mlp("jax", **kw)).init()
    conf = _mlp("torch", **kw)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _assert_params_match(tnet, jnet):
    ref = jax.tree.map(np.asarray, jnet.params)
    for i, (g, r) in enumerate(zip(params_to_numpy(tnet.params), ref)):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=P_RTOL, atol=P_ATOL,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
def test_mlp_classifier_matches_jax_over_5_steps(updater):
    """Dense -> Dense -> softmax/mcxent OutputLayer: each step's loss and
    the params after 5 steps."""
    jnet, tnet = _nets(updater=updater)
    batches = [(_x(10 + i, B, F), _onehot(20 + i)) for i in range(5)]
    for i, (x, y) in enumerate(batches):
        want = float(jnet.fit_batch(JDataSet(x, y)))
        got = float(tnet.fit_batch(DataSet(x, y)))
        assert got == pytest.approx(want, rel=LOSS_RTOL_1 if i == 0
                                    else LOSS_RTOL), i
    _assert_params_match(tnet, jnet)
    x = batches[0][0]
    _close(tnet.output(x).numpy(), jnet.output(x))


def test_center_loss_head_trains_its_centers_like_jax():
    """The center loss in the score, and the centers' moving average
    after each ``fit_batch`` (from the pre-update centers, outside the
    gradient), a class absent from a batch keeping its center."""
    jnet, tnet = _nets(head="CenterLossOutputLayer", alpha=0.3,
                       lambda_=0.5)
    for i in range(3):
        x, y = _x(30 + i, B, F), _onehot(40 + i, absent=(i,))
        want = float(jnet.fit_batch(JDataSet(x, y)))
        got = float(tnet.fit_batch(DataSet(x, y)))
        assert got == pytest.approx(want, rel=LOSS_RTOL_1 if i == 0
                                    else LOSS_RTOL), i
    centers = tnet.params[-1]["cL"].numpy()
    assert np.abs(centers).max() > 0.01
    _assert_params_match(tnet, jnet)


# -------------------------------------------------------------- evaluation

@pytest.mark.parametrize("case", ["ff", "top3", "time_series_masked"])
def test_evaluation_matches_jax(case):
    rng = np.random.default_rng(50)
    top_n = 3 if case == "top3" else 1
    je, te = JEvaluation(top_n=top_n), Evaluation(top_n=top_n)
    for i in range(3):
        if case == "time_series_masked":
            labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, (4, 6))]
            preds = rng.random((4, 6, C)).astype(np.float32)
            mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
        else:
            labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, 20)]
            preds = rng.random((20, C)).astype(np.float32)
            mask = None
        je.eval(labels, preds, mask=mask)
        te.eval(labels, preds, mask=mask)
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    assert te.examples == je.examples
    for metric in ("accuracy", "top_n_accuracy", "precision", "recall",
                   "f1", "g_measure", "matthews_correlation"):
        assert getattr(te, metric)() == getattr(je, metric)(), metric
    for k in range(C):
        assert te.f1(k) == je.f1(k)
        assert te.false_positive_rate(k) == je.false_positive_rate(k)
    assert te.stats() == je.stats()


def test_evaluate_drives_output_over_an_iterator_like_jax():
    jnet, tnet = _nets()
    batches = [(_x(60 + i, B, F), _onehot(70 + i)) for i in range(3)]
    je = jnet.evaluate(JListIterator([JDataSet(*b) for b in batches]))
    te = tnet.evaluate(ListDataSetIterator([DataSet(*b) for b in batches]))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    assert te.accuracy() == je.accuracy()


@pytest.mark.parametrize("train,flatten", [(True, True), (False, False)])
def test_mnist_iterator_matches_jax(train, flatten):
    """The synthetic stand-in (no IDX files here): the same images,
    labels, shuffle and batches; the test split's templates differ from
    the training split's (``seed + 1``)."""
    kw = dict(num_examples=100, train=train, flatten=flatten)
    jit, tit = JMnistIterator(32, **kw), MnistDataSetIterator(32, **kw)
    assert tit.is_synthetic == jit.is_synthetic
    jb, tb = list(jit), list(tit)
    assert [b.num_examples() for b in tb] == [32, 32, 32, 4]
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t.features, j.features)
        np.testing.assert_array_equal(t.labels, j.labels)
    assert tb[0].features.shape[1:] == ((784,) if flatten else (28, 28, 1))
