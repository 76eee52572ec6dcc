"""The CNN classifiers of the slice against the JAX package, through the
containers' entry points on the CPU: LeNet-5 (``lenet_mnist``) on the
synthetic MNIST stand-in, VGG-16-CIFAR (``vgg16_cifar10``), a graph of
two ResNet bottlenecks built by each package's own ``_conv_bn`` and
``_bottleneck``, the full-depth ``resnet_tiny`` (ResNet-50 at 32x32, 10
classes) and the size of the full-width ``resnet50()``. The JAX net draws
the weights; ``convert.params_from_jax`` / ``states_from_jax`` carry
them and batch norm's running state into the port.

Tolerances: probabilities 1e-5 x max(1, max |y|); gradients 1e-4 of each
tensor's largest |g|; the first loss 1e-5 relative and later ones 1e-4;
params after the steps 1e-4 relative, 1e-6 absolute; BN states 1e-5 x
max(1, max |s|) (a running variance sits near 1.3).
After Adam steps the params' absolute tolerance is a tenth of the
learning rate: Adam moves an element by about ``lr * g / (|g| + eps)``
with eps 1e-8, so an element whose gradient cancels to ~1e-9 (a few of
LeNet's dense ``W``, whose gradients both sides hold within the 1e-4
gate) takes steps of a visibly different fraction of lr on each side.
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
from deeplearning4j_tpu.models import resnet as jresnet
from deeplearning4j_tpu.models.lenet import lenet_mnist as jlenet
from deeplearning4j_tpu.models.vgg import vgg16_cifar10 as jvgg
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_tpu_torch.convert import (
    params_from_jax, params_to_numpy, states_from_jax, states_to_numpy,
)
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator, MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.models import resnet as tresnet
from deeplearning4j_tpu_torch.models import (
    lenet_mnist, resnet50, resnet_tiny, vgg16_cifar10,
)
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import pooling as tpool
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import tree_map

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL_1 = 1e-5
LOSS_RTOL = 1e-4
P_RTOL, P_ATOL = 1e-4, 1e-6
#: params after Adam steps at ``lenet_mnist``'s lr 1e-3: a tenth of it
ADAM_P_ATOL = 1e-4
STATE_TOL = 1e-5
#: resnet_tiny's training-mode loss and the BN states its step leaves:
#: 53 BN layers at random init carry f32 noise above the 1e-5 gates of
#: the smaller nets on either side, so both packages' f32 values are held
#: to the port's f64 forward at this tolerance, and to each other
TINY_RTOL = 1e-4
#: the full-width ResNet-50: the JAX ``resnet50()`` counts the same (its
#: convolutions have no bias); its BN layers hold 2 x 26,560 state values
RESNET50_PARAMS = 25_557_032
RESNET50_STATE_VALUES = 53_120


def _x(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _onehot(seed, n, c):
    return np.eye(c, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, c, n)]


def _close(got, want, tol=FWD_TOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _tree_close(got, want, *, rtol=0.0, atol=0.0, grad=False, state=False,
                state_tol=STATE_TOL, what=""):
    """Two structures of arrays (a list of per-layer dicts or a dict of
    them) by name: gradients against each tensor's largest |g|, states
    against ``state_tol`` x max(1, max |s|), else ``rtol`` / ``atol``."""
    keys = range(len(want)) if isinstance(want, list) else list(want)
    for key in keys:
        assert set(got[key]) == set(want[key]), key
        for name, w in want[key].items():
            w = np.asarray(w, np.float32)
            g = np.asarray(got[key][name], np.float32)
            if grad or state:
                tol = (GRAD_TOL * max(float(np.abs(w).max()), 1e-30) if grad
                       else state_tol * max(1.0, float(np.abs(w).max())))
                np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                           err_msg=f"{what} {key}.{name}")
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=f"{what} {key}.{name}")


def _jnp_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_of(jnet, conf, cls):
    return cls(conf, device="cpu").init(
        params_from_jax(conf, _jnp_tree(jnet.params)),
        states_from_jax(conf, _jnp_tree(jnet.states)))


# ------------------------------------------------------------------ LeNet

def test_lenet_on_synthetic_mnist_matches_jax():
    """LeNet-5 on [16, 28, 28, 1] batches of the MNIST stand-in: the
    NHWC flatten in front of the dense layer, ``output()``, the step-1
    gradients, 5 Adam steps' losses and the params after them, and
    ``evaluate()``."""
    jnet = JNet(jlenet()).init()
    conf = lenet_mnist()
    assert {i: type(p) for i, p in conf.preprocessors.items()} == \
        {4: CnnToFeedForwardPreProcessor}
    tnet = _port_of(jnet, conf, MultiLayerNetwork)
    kw = dict(num_examples=80, flatten=False)
    tbatches = list(MnistDataSetIterator(16, **kw))
    jbatches = list(JMnistIterator(16, **kw))
    assert tbatches[0].features.shape == (16, 28, 28, 1)
    x = tbatches[0].features
    _close(tnet.output(x).numpy(), jnet.output(x), what="output")
    ref = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.states, jnp.asarray(x), jnp.asarray(jbatches[0].labels),
        None, None, None)[0])(jnet.params)
    grads, _, _ = tnet.compute_gradient_and_score(tbatches[0])
    _tree_close(params_to_numpy(grads), _jnp_tree(ref), grad=True,
                what="grads")
    for i, (tb, jb) in enumerate(zip(tbatches, jbatches)):
        want = float(jnet.fit_batch(jb))
        got = float(tnet.fit_batch(tb))
        assert got == pytest.approx(
            want, rel=LOSS_RTOL_1 if i == 0 else LOSS_RTOL), i
    _tree_close(params_to_numpy(tnet.params), _jnp_tree(jnet.params),
                rtol=P_RTOL, atol=ADAM_P_ATOL, what="params")
    it = MnistDataSetIterator(40, num_examples=80, flatten=False, seed=5)
    jit = JMnistIterator(40, num_examples=80, flatten=False, seed=5)
    te, je = tnet.evaluate(it), jnet.evaluate(jit)
    assert te.examples == je.examples == 80
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)


# ------------------------------------------------------------------- VGG

def test_vgg16_cifar_matches_jax():
    """VGG-16-CIFAR (13 ``same`` 3x3 convolutions, 5 max pools, dense 512
    x 2): ``output()`` at [2, 32, 32, 3], one Nesterov step's loss and
    the params after it, and ``evaluate()``."""
    jnet = JNet(jvgg()).init()
    tnet = _port_of(jnet, vgg16_cifar10(), MultiLayerNetwork)
    x, y = _x(1, 2, 32, 32, 3), _onehot(2, 2, 10)
    _close(tnet.output(x).numpy(), jnet.output(x), what="output")
    want = float(jnet.fit_batch(JDataSet(x, y)))
    assert float(tnet.fit_batch(DataSet(x, y))) == pytest.approx(
        want, rel=LOSS_RTOL_1)
    _tree_close(params_to_numpy(tnet.params), _jnp_tree(jnet.params),
                rtol=P_RTOL, atol=P_ATOL, what="params")
    te = tnet.evaluate(ListDataSetIterator([DataSet(x, y)]))
    je = jnet.evaluate(JListIterator([JDataSet(x, y)]))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)


# ------------------------------------------------------ two bottlenecks

def _bottlenecks(pkg):
    """in [8, 8, 8] -> a projecting bottleneck (stride 2) -> an identity
    one -> global average pool -> softmax over 5; Nesterov at lr 0.1, as
    ``resnet50()`` trains."""
    jax_side = pkg == "jax"
    nnc, resnet = (JNNC, jresnet) if jax_side else (NeuralNetConfiguration,
                                                    tresnet)
    core, pool = (jcore, jpool) if jax_side else (tcore, tpool)
    it = JInputType if jax_side else InputType
    g = (nnc.builder().seed(3).updater("nesterovs", learning_rate=0.1,
                                       momentum=0.9)
         .weight_init("relu").graph_builder().add_inputs("in"))
    cur = resnet._bottleneck(g, "b0", "in", 4, 2, project=True)
    cur = resnet._bottleneck(g, "b1", cur, 4, 1, project=False)
    g.add_layer("avgpool", pool.GlobalPoolingLayer(pooling_type="avg"), cur)
    g.add_layer("out", core.OutputLayer(n_out=5, activation="softmax",
                                        loss="mcxent"), "avgpool")
    return g.set_outputs("out").set_input_types(
        it.convolutional(8, 8, 8)).build()


def test_two_bottlenecks_match_jax():
    """Each package's own ``_conv_bn`` / ``_bottleneck`` (the same node
    names), then ``output()`` with the initial running state, one
    gradient, one Nesterov step's BN states and params, and ``output()``
    with the running state the step left."""
    jnet = JGraph(_bottlenecks("jax")).init()
    conf = _bottlenecks("torch")
    assert conf.topological_order == jnet.conf.topological_order
    tnet = _port_of(jnet, conf, ComputationGraph)
    x, y = _x(4, 6, 8, 8, 8) * 2 - 0.5, _onehot(5, 6, 5)
    _close(tnet.output(x).numpy(), jnet.output(x), what="output")

    ref = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.states, {"in": jnp.asarray(x)}, {"out": jnp.asarray(y)},
        None, None, None)[0])(jnet.params)
    grads, loss, _ = tnet.compute_gradient_and_score(DataSet(x, y))
    _tree_close(params_to_numpy(grads), _jnp_tree(ref), grad=True,
                what="grads")
    want = float(jnet.fit_batch(JDataSet(x, y)))
    assert float(loss) == pytest.approx(want, rel=LOSS_RTOL_1)
    assert float(tnet.fit_batch(DataSet(x, y))) == pytest.approx(
        want, rel=LOSS_RTOL_1)
    _tree_close(states_to_numpy(tnet.states), _jnp_tree(jnet.states),
                state=True, what="states")
    _tree_close(params_to_numpy(tnet.params), _jnp_tree(jnet.params),
                rtol=P_RTOL, atol=P_ATOL, what="params")
    _close(tnet.output(x).numpy(), jnet.output(x), what="output after")


# ---------------------------------------------------------- resnet_tiny

@pytest.fixture(scope="module")
def tiny():
    """The full-depth ResNet-50 body (``resnet_tiny`` at 64x64) on both
    sides, built and compiled once: ``output()``, one ``fit_batch``, then
    ``output()`` with the running state that step left, on [4, 64, 64, 3].

    Not 32x32 at batch 2: there the last stage is 1x1, so each of its BN
    layers normalizes 2 values per channel in training, some of which
    differ by less than f32 noise; neither package's f32 forward then
    follows an f64 forward of the same net. At 64x64 and batch 4 (16
    values) both do, to f32's reach. The port's loss and states in f64
    (params, states and input cast) are the reference both f32 runs are
    held to."""
    jnet = JGraph(jresnet.resnet_tiny(height=64, width=64)).init()
    tnet = _port_of(jnet, resnet_tiny(height=64, width=64), ComputationGraph)
    x, y = _x(6, 4, 64, 64, 3), _onehot(7, 4, 10)
    with torch.no_grad():
        loss64, states64 = tnet._loss_fn(
            tree_map(torch.Tensor.double, tnet.params),
            tree_map(torch.Tensor.double, tnet.states),
            {"in": torch.from_numpy(x).double()},
            {"out": torch.from_numpy(y).double()}, None, None, None)
    return dict(
        loss_f64=float(loss64), states_f64=states_to_numpy(states64),
        out0=(tnet.output(x).numpy(), np.asarray(jnet.output(x))),
        loss=(float(tnet.fit_batch(DataSet(x, y))),
              float(jnet.fit_batch(JDataSet(x, y)))),
        states=(states_to_numpy(tnet.states), _jnp_tree(jnet.states)),
        out1=(tnet.output(x).numpy(), np.asarray(jnet.output(x))))


def test_resnet_tiny_output_matches_jax(tiny):
    _close(*tiny["out0"], what="output")


def test_resnet_tiny_fit_batch_matches_jax(tiny):
    """The step's loss and the BN states it leaves: the port's and the
    JAX net's, each within ``TINY_RTOL`` of the port's f64 forward, and
    of each other."""
    got, want = tiny["loss"]
    ref = tiny["loss_f64"]
    assert abs(got - ref) <= TINY_RTOL * ref
    assert abs(want - ref) <= TINY_RTOL * ref
    assert got == pytest.approx(want, rel=TINY_RTOL)
    got, want = tiny["states"]
    for a, b, what in ((got, tiny["states_f64"], "port vs f64"),
                       (want, tiny["states_f64"], "JAX vs f64"),
                       (got, want, "port vs JAX")):
        _tree_close(a, b, state=True, state_tol=TINY_RTOL, what=what)


def test_resnet_tiny_output_after_a_step_matches_jax(tiny):
    """Inference with the running state one training step left (53 BN
    layers, the stem's asymmetric SAME conv and pool)."""
    _close(*tiny["out1"], what="output after a step")


def test_resnet_tiny_trains_in_bf16():
    """``resnet50()``'s dtype: bf16 params and activations, f32 BN state,
    a finite loss and a gradient step that moves the params."""
    net = ComputationGraph(resnet_tiny(dtype="bfloat16"),
                           device="cpu").init()
    before = net.params["out"]["W"].clone()
    x, y = _x(8, 2, 32, 32, 3), _onehot(9, 2, 10)
    assert net.output(x).dtype == torch.bfloat16
    loss = float(net.fit_batch(DataSet(x, y)))
    assert np.isfinite(loss)
    assert net.params["stem_conv"]["W"].dtype == torch.bfloat16
    assert net.states["stem_bn"]["mean"].dtype == torch.float32
    assert not torch.equal(net.params["out"]["W"], before)


def test_resnet50_size_matches_jax():
    """The full-width ResNet-50 (224x224x3, 1000 classes): the JAX
    builder's param count, from each layer's param shapes, and the port's
    params and BN state values."""
    jconf = jresnet.resnet50()
    key = jax.random.PRNGKey(0)
    jcount = 0
    for name in jconf.topological_order:
        layer = jconf.nodes[name].layer
        if layer is not None and layer.has_params():
            shapes = jax.eval_shape(
                lambda k, _l=layer: _l.init_params(k, jnp.bfloat16), key)
            jcount += sum(int(np.prod(s.shape)) for s in shapes.values())
    net = ComputationGraph(resnet50(), device="cpu").init()
    assert net.num_params() == jcount == RESNET50_PARAMS
    assert sum(t.numel() for s in net.states.values()
               for t in s.values()) == RESNET50_STATE_VALUES
    assert net.params["stem_conv"]["W"].shape == (7, 7, 3, 64)   # HWIO
    assert net.conf.training.updater.name == "nesterovs"
