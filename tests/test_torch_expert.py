"""The port's expert parallelism (``parallel/expert.py``, ROADMAP A6.2b)
against the JAX package's, on the CPU.

``moe_dispatch`` / ``moe_ffn`` and ``MoELayer`` in both containers are
held to the JAX package's on the same tokens and weights (weights copied
by ``convert.params_from_jax``): outputs, the balancing loss and the
gradients within 1e-5, one SGD step of an MoE net within 1e-5, its
config's JSON both ways. The expert axis runs in one group of two gloo
processes for the module (``torch_parallel_worker.run_group``): each
rank holds its half of the stacked expert weights and the same tokens,
and the output and every gradient equal the unsharded ``moe_ffn``'s
within 1e-5. There too: ``ParallelTrainer`` steps an MoE net at two
data ranks as the single-device step of the global batch does
(``tests/test_torch_moe_data.py`` holds every mode against the JAX
package), ``ParallelWrapper`` and ``DelayedSyncTrainer`` keep their
per-worker semantics, and a mesh refuses an expert axis beside another
and a pipeline axis beside the model axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType, NeuralNetConfiguration
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import expert as jexpert

from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.parallel import expert as pexpert

TOL = 1e-5
N, F, E, H = 64, 8, 8, 16


def moe_params(seed=0, n_in=F, experts=E, hidden=H):
    """MoE params of the JAX layer's shapes (numpy, drawn from a seed)."""
    r = np.random.default_rng(seed)

    def w(*shape):
        return (r.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return {"Wg": w(n_in, experts), "W1": w(experts, n_in, hidden),
            "b1": (0.1 * r.normal(size=(experts, hidden))).astype(
                np.float32),
            "W2": w(experts, hidden, n_in),
            "b2": (0.1 * r.normal(size=(experts, n_in))).astype(
                np.float32)}


PARAMS = moe_params()
TOKENS = np.random.default_rng(11).normal(size=(N, F)).astype(np.float32)


def jax_moe(params, x):
    """The JAX moe_ffn's output, aux and the gradients of sum(out**2) +
    aux with respect to the params and the tokens."""
    def f(p, x):
        out, aux = jexpert.moe_ffn(p, x)
        return jnp.sum(out ** 2) + aux, (out, aux)
    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return (np.asarray(out), float(aux), jax.tree.map(np.asarray, gp),
            np.asarray(gx))


def port_moe(params, x):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = pexpert.moe_ffn(p, xt)
    ((out ** 2).sum() + aux).backward()
    return (out.detach().numpy(), float(aux.detach()),
            {k: v.grad.numpy() for k, v in p.items()}, xt.grad.numpy())


def moe_conf(seed=3):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater("sgd", learning_rate=0.05).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(jexpert.MoELayer(n_experts=2, hidden=8))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def moe_graph_conf(seed=5, aux_weight=1.0):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater("sgd", learning_rate=0.05).weight_init("xavier")
         .graph_builder().add_inputs("in"))
    b.add_layer("d", DenseLayer(n_out=8, activation="relu"), "in")
    b.add_layer("moe", jexpert.MoELayer(n_experts=4, hidden=8,
                                        aux_loss_weight=aux_weight), "d")
    b.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "moe")
    return b.set_outputs("out").set_input_types(
        InputType.feed_forward(6)).build()


def ff_batch(b=8, f=6, k=3, seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(size=(b, f)).astype(np.float32),
            np.eye(k, dtype=np.float32)[r.integers(0, k, b)]]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert")
    return W.run_group([
        dict(name="sharded", fn="moe_sharded",
             args=dict(params=PARAMS, x=TOKENS, n_ep=2)),
        dict(name="refusals", fn="moe_refusals",
             args=dict(conf=moe_conf().to_json(), batches=[ff_batch()])),
    ], tmp, world=2)


# ---------------------------------------------------------------------------
# moe_dispatch / moe_ffn
# ---------------------------------------------------------------------------

def test_moe_ffn_routes_and_shapes():
    out, aux = pexpert.moe_ffn({k: torch.tensor(v) for k, v in
                                moe_params(0, 8, 4, 16).items()},
                               torch.tensor(TOKENS[:32]))
    assert out.shape == (32, 8) and np.isfinite(float(aux))


def test_moe_dispatch_is_the_jax_packages():
    gates = jax.nn.softmax(jnp.asarray(TOKENS @ PARAMS["Wg"]), axis=-1)
    want = jexpert.moe_dispatch(gates, 5)
    got = pexpert.moe_dispatch(torch.tensor(np.asarray(gates)), 5)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    # capacity 5 of 64 tokens over 8 experts drops tokens: every kept
    # token sits in one slot of one expert
    assert float(got[0].sum()) < N and got[0].sum(dim=(1, 2)).max() == 1


def test_moe_ffn_and_its_gradients_are_the_jax_packages():
    want, got = jax_moe(PARAMS, TOKENS), port_moe(PARAMS, TOKENS)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    assert abs(got[1] - want[1]) < TOL
    for k in PARAMS:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(got[3], want[3], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_experts_sharded_over_ep_equal_the_unsharded_ffn(group, rank):
    """Each rank holds experts [4r, 4r + 4): the output, the aux loss, the
    gate's and the tokens' gradients equal the unsharded moe_ffn's, and
    its expert rows' gradients equal those rows of the unsharded
    gradient."""
    got = W.result(group, "sharded", rank)
    out, aux, grads, dx = port_moe(PARAMS, TOKENS)
    jout = jax_moe(PARAMS, TOKENS)[0]
    lo, hi = got["span"]
    assert (lo, hi) == (4 * rank, 4 * rank + 4)
    np.testing.assert_allclose(got["out"], out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["out"], jout, rtol=TOL, atol=TOL)
    assert abs(got["aux"] - aux) < TOL
    np.testing.assert_allclose(got["dx"], dx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["grads"]["Wg"], grads["Wg"], rtol=TOL,
                               atol=TOL)
    for k in pexpert.EXPERT_PARAMS:
        assert got["grads"][k].shape[0] == 4
        np.testing.assert_allclose(got["grads"][k], grads[k][lo:hi],
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_expert_rows_refuse_an_uneven_split():
    from deeplearning4j_tpu_torch.parallel import MeshContext
    mesh = MeshContext(world=3, rank=1, n_expert=3)
    with pytest.raises(ValueError, match="not divisible by the "
                                         "expert-parallel axis"):
        pexpert.expert_rows({k: torch.tensor(v) for k, v in PARAMS.items()},
                            mesh)


# ---------------------------------------------------------------------------
# MoELayer in the containers
# ---------------------------------------------------------------------------

def _port_net(conf, graph=False):
    return W.conf_net(conf.to_json(), graph)


def test_moe_config_crosses_both_ways():
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu.nn.conf.builder import (
        MultiLayerConfiguration as JMLC,
    )
    jconf = moe_conf()
    port = MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(port.layers[1], pexpert.MoELayer)
    assert port.layers[1].n_in == 8 and port.layers[1].hidden == 8
    assert port.to_dict() == jconf.to_dict()
    back = JMLC.from_json(port.to_json())
    assert back.to_dict() == jconf.to_dict()


def test_params_from_jax_copies_the_moe_weights():
    conf = moe_conf()
    jnet = JNet(conf).init()
    src = jax.tree.map(np.asarray, jnet.params)
    net = _port_net(conf)
    port = params_from_jax(net.conf, src)
    assert list(port[1]) == ["Wg", "W1", "b1", "W2", "b2"]
    assert tuple(port[1]["W1"].shape) == (2, 8, 8)
    for k, v in port[1].items():
        np.testing.assert_array_equal(v.numpy(), src[1][k])
    port[1]["W1"].add_(1.0)
    assert not np.array_equal(port[1]["W1"].numpy(), src[1]["W1"])


@pytest.mark.parametrize("graph", [False, True])
def test_moe_aux_loss_reaches_the_gradients_in_both_containers(graph):
    """``tests/test_review_regressions.py::
    test_moe_aux_loss_reaches_gradients`` in both containers: the loss
    moves with the aux weight alone, and one SGD step (the balancing
    loss inside the gradient) equals the JAX container's."""
    conf = moe_graph_conf() if graph else moe_conf()
    net = _port_net(conf, graph)
    params = params_to_numpy(net.params)
    jnet = (JGraph if graph else JNet)(conf).init(
        jax.tree.map(jnp.asarray, params))
    batch = ff_batch(16, seed=3)
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    moe = net.conf.nodes["moe"].layer if graph else net.layers[1]

    def loss_with(w):
        moe.aux_loss_weight = w
        return net.score(DataSet(*batch), train=True)
    assert loss_with(1.0) != pytest.approx(loss_with(0.0))
    moe.aux_loss_weight = 1.0 if graph else 1e-2
    loss = float(net.fit_batch(DataSet(*batch)))
    jloss = float(jnet.fit_batch(JDataSet(*batch)))
    assert abs(loss - jloss) < TOL
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jnet.params_flat()),
                               rtol=0, atol=TOL)


def test_moe_layer_in_network_trains():
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    conf = (NeuralNetConfiguration.builder()
            .seed(5).updater("adam", learning_rate=0.01)
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(jexpert.MoELayer(n_experts=4, hidden=32,
                                    activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(6))
            .build())
    net = _port_net(conf)
    ds = DataSet(*ff_batch(24, seed=4))
    s0 = net.score(ds)
    for _ in range(20):
        net.fit(ds, use_async=False)
    assert net.score(ds) < s0


# ---------------------------------------------------------------------------
# the data-parallel trainers and the mesh at world 2
# ---------------------------------------------------------------------------

def test_parallel_trainer_refuses_moe_over_two_data_ranks(group):
    """ParallelTrainer no longer refuses an MoE net at two data ranks: its
    world-2 step, on each rank, equals the single-device step of the
    port and of the JAX package on the global batch (the capacity and
    the balancing loss taken over every row). The wrapper and the
    delayed trainer train it with their per-worker semantics."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    conf, batch = moe_conf(), ff_batch()
    net = _port_net(conf)
    jnet = JNet(conf).init(jax.tree.map(jnp.asarray,
                                        params_to_numpy(net.params)))
    loss = float(net.fit_batch(DataSet(*batch)))
    jloss = float(jnet.fit_batch(JDataSet(*batch)))
    for rank in (0, 1):
        got = W.result(group, "refusals", rank)
        step = got["parallel"]
        assert abs(step["loss"] - loss) < TOL
        assert abs(step["loss"] - jloss) < TOL
        np.testing.assert_allclose(step["params"], net.params_flat(),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(step["params"],
                                   np.asarray(jnet.params_flat()),
                                   rtol=2e-4, atol=2e-5)
        assert got["wrapper"] is None and got["delayed"] is None


@pytest.mark.parametrize("key,words", [
    ("ep_data", "'ep' stands alone"),
    ("pp_model", "composes with the data axis only"),
    ("pp_in_parallel", "n_pipe=2"),
])
def test_mesh_axes_refuse_what_the_jax_meshes_lack(group, key, words):
    for rank in (0, 1):
        err = W.result(group, "refusals", rank)[key]
        assert err is not None and err[0] == "ValueError" \
            and words in err[1], err
