"""Layerwise pretraining in the port against the JAX package, on the CPU.

The same weights go into both packages (``convert.params_from_jax``) and
the JAX package's random draws are carried into the port: every draw of
the port's pretraining layers goes through one function of
``nn/layers/draws.py`` a kind (a VAE's normals, an AutoEncoder's
keep-mask, an RBM's CD uniforms), and ``_Replay`` replaces those with the
JAX draws of the same step, in the same order (a VAE's ``num_samples``
normals, then the next step's; an RBM's ``k`` uniforms), checking each
draw's kind and shape as it goes. The JAX draws are rebuilt from the JAX
net's key as its ``pretrain`` splits it.

Held here:
- each reconstruction distribution's ``log_prob`` and ``mean``; the VAE's
  ``encode`` / ``decode`` / ``pretrain_loss`` and its gradients,
  ``reconstruction_probability`` and ``generate``;
- the AutoEncoder's loss at ``corruption_level`` 0 and with the mask
  carried; the RBM's ``cd_gradients`` for binary and gaussian hidden
  units;
- ``MultiLayerNetwork.pretrain`` and ``ComputationGraph.pretrain`` /
  ``pretrain_layer`` over a few steps (the layers that cannot pretrain
  untouched bit for bit), the multi-input ``ValueError``, a
  ``DuplicateToTimeSeriesVertex``'s T source in a target's ancestors;
- ROADMAP C33: ``fit`` with ``pretrain=True`` / ``backprop=False`` gives
  the JAX net's losses;
- the port's own draws: two runs from one generator state bit for bit;
- serde: the three layers' configs cross the JAX JSON both ways, and a
  ``ModelSerializer`` zip of a pretrained VAE net crosses both ways.

Tolerances: forward 1e-5; gradients and params 1e-4 of the largest |x|.
The JAX gates mirrored: ``tests/test_vae_distributions.py`` (4) and
``tests/test_graph_rnn.py::test_graph_pretrain_autoencoder_layer``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator as JList
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import variational as jvar
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSerializer

from deeplearning4j_tpu_torch.convert import params_from_jax, states_from_jax
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as PL
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import draws
from deeplearning4j_tpu_torch.nn.layers import variational as pvar
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.netcommon import value_and_grad
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

FWD = 1e-5
GRAD = 1e-4


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# carrying the JAX draws into the port
# ---------------------------------------------------------------------------

def jax_step_draws(layer, key, batch: int):
    """The draws one JAX pretraining step of ``layer`` takes from ``key``,
    in order, as (kind, array)."""
    out = []
    if isinstance(layer, JL.VariationalAutoencoder):
        rng = key
        for _ in range(layer.num_samples):
            rng, k = jax.random.split(rng)
            out.append(("normal", np.asarray(jax.random.normal(
                k, (batch, layer.n_out), jnp.float32))))
    elif isinstance(layer, JL.AutoEncoder):
        if layer.corruption_level > 0:
            out.append(("mask", np.asarray(jax.random.bernoulli(
                key, 1.0 - layer.corruption_level, (batch, layer.n_in)))))
    elif isinstance(layer, JL.RBM) and layer.hidden_unit == "binary":
        rng = key
        for _ in range(layer.k):
            rng, k = jax.random.split(rng)
            out.append(("uniform", np.asarray(jax.random.uniform(
                k, (batch, layer.n_out)))))
    return out


class _Replay:
    """Stands in for ``nn/layers/draws``: hands out queued draws in order,
    checking each one's kind and shape; ``done()`` holds the count."""

    def __init__(self, monkeypatch):
        self.queue = []
        self.taken = 0
        monkeypatch.setattr(draws, "normal", self._normal)
        monkeypatch.setattr(draws, "keep_mask", self._mask)
        monkeypatch.setattr(draws, "uniform", self._uniform)

    def _pop(self, kind, shape):
        assert self.queue, f"the port drew an extra {kind}"
        k, a = self.queue.pop(0)
        assert (k, a.shape) == (kind, tuple(shape))
        self.taken += 1
        return a

    def _normal(self, gen, shape, dtype, device):
        return torch.as_tensor(np.array(self._pop("normal", shape)),
                               dtype=dtype,
                               device=device)

    def _mask(self, gen, p_keep, shape, device):
        return torch.as_tensor(np.array(self._pop("mask", shape)),
                               device=device)

    def _uniform(self, gen, shape, dtype, device):
        return torch.as_tensor(np.array(self._pop("uniform", shape)),
                               dtype=dtype,
                               device=device)

    def done(self):
        assert not self.queue, f"{len(self.queue)} draws left untaken"


@pytest.fixture
def replay(monkeypatch):
    return _Replay(monkeypatch)


# ---------------------------------------------------------------------------
# distributions and the VAE layer
# ---------------------------------------------------------------------------

def _dists(pkg):
    return {
        "gaussian": pkg.GaussianReconstructionDistribution(),
        "bernoulli": pkg.BernoulliReconstructionDistribution(),
        "exponential": pkg.ExponentialReconstructionDistribution(),
        "composite": pkg.CompositeReconstructionDistribution(
            [(3, "bernoulli"), (2, "gaussian"), (1, "exponential")]),
    }


@pytest.mark.parametrize("name", ["gaussian", "bernoulli", "exponential",
                                  "composite"])
def test_distribution_log_prob_and_mean_match_jax(name):
    jd, pd = _dists(jvar)[name], _dists(pvar)[name]
    rng = np.random.default_rng(7)
    n = jd.param_size(6)
    assert pd.param_size(6) == n
    params = rng.normal(size=(5, n)).astype(np.float32)
    x = rng.uniform(size=(5, 6)).astype(np.float32)
    _close(_np(pd.log_prob(_t(params), _t(x))),
           np.asarray(jd.log_prob(jnp.asarray(params), jnp.asarray(x))), FWD)
    _close(_np(pd.mean(_t(params))), np.asarray(jd.mean(jnp.asarray(params))),
           FWD)
    assert pd.to_dict() == jd.to_dict()


def test_exponential_log_prob_matches_formula():
    d = pvar.ExponentialReconstructionDistribution()
    gamma = np.asarray([[0.3, -0.2]], np.float32)
    x = np.asarray([[1.0, 2.0]], np.float32)
    want = np.sum(gamma - x * np.exp(gamma))
    np.testing.assert_allclose(_np(d.log_prob(_t(gamma), _t(x)))[0], want,
                               rtol=1e-6)
    np.testing.assert_allclose(_np(d.mean(_t(gamma))), np.exp(-gamma),
                               rtol=1e-6)


def test_composite_slices_params_and_data():
    comp = pvar.CompositeReconstructionDistribution([(3, "bernoulli"),
                                                     (2, "gaussian")])
    assert comp.param_size(5) == 7
    rng = np.random.default_rng(0)
    params = _t(rng.normal(size=(4, 7)).astype(np.float32))
    x = _t(rng.uniform(size=(4, 5)).astype(np.float32))
    want = (pvar.BernoulliReconstructionDistribution().log_prob(
        params[:, :3], x[:, :3])
        + pvar.GaussianReconstructionDistribution().log_prob(
            params[:, 3:], x[:, 3:]))
    np.testing.assert_allclose(_np(comp.log_prob(params, x)), _np(want),
                               rtol=1e-6)
    assert tuple(comp.mean(params).shape) == (4, 5)
    with pytest.raises(ValueError, match="covers"):
        comp.param_size(9)


def test_composite_serde_round_trip():
    comp = pvar.CompositeReconstructionDistribution([(3, "bernoulli"),
                                                     (2, "exponential")])
    vae = PL.VariationalAutoencoder(n_out=4, n_in=5, encoder_layer_sizes=(8,),
                                    decoder_layer_sizes=(8,),
                                    activation="tanh", weight_init="xavier",
                                    reconstruction_distribution=comp)
    back = PL.VariationalAutoencoder.from_dict(vae.to_dict())
    rd = back.reconstruction_distribution
    assert isinstance(rd, pvar.CompositeReconstructionDistribution)
    assert [(s, type(x).tag) for s, x in rd.components] == \
        [(3, "bernoulli"), (2, "exponential")]


def test_vae_pretrain_with_composite_decreases_loss():
    comp = pvar.CompositeReconstructionDistribution([(4, "bernoulli"),
                                                     (2, "gaussian")])
    vae = PL.VariationalAutoencoder(n_out=3, n_in=6, encoder_layer_sizes=(12,),
                                    decoder_layer_sizes=(12,),
                                    activation="tanh", weight_init="xavier",
                                    reconstruction_distribution=comp)
    params = vae.init_params(torch.Generator().manual_seed(0))
    assert tuple(params["outW"].shape) == (12, 4 + 2 * 2)
    rng = np.random.default_rng(1)
    x = _t(np.concatenate([
        (rng.uniform(size=(16, 4)) > 0.5).astype(np.float32),
        rng.normal(size=(16, 2)).astype(np.float32)], axis=1))

    def loss(p, seed):
        return vae.pretrain_loss(p, x, rng=torch.Generator().manual_seed(seed))

    first = float(loss(params, 42))
    for i in range(60):
        _, _, g = value_and_grad(lambda p: (loss(p, 100 + i), None), params)
        params = {k: v - 0.01 * g[k] for k, v in params.items()}
    assert float(loss(params, 42)) < first


def _vae_pair(dist, num_samples):
    kw = dict(n_out=3, n_in=6, encoder_layer_sizes=(10, 8),
              decoder_layer_sizes=(8,), activation="leakyrelu",
              weight_init="xavier", num_samples=num_samples)
    jd = _dists(jvar)[dist]
    j = JL.VariationalAutoencoder(reconstruction_distribution=jd, **kw)
    p = PL.VariationalAutoencoder.from_dict(j.to_dict())
    jparams = j.init_params(jax.random.PRNGKey(3))
    pparams = {k: _t(v) for k, v in jparams.items()}
    return j, p, jparams, pparams


@pytest.mark.parametrize("dist, num_samples", [
    ("bernoulli", 1), ("gaussian", 2), ("composite", 3)])
def test_vae_matches_jax_with_draws_carried(dist, num_samples, replay):
    j, p, jparams, pparams = _vae_pair(dist, num_samples)
    assert p.param_order() == j.param_order()
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(7, 6)).astype(np.float32)
    if dist == "bernoulli":
        x = (x > 0.5).astype(np.float32)
    jx, px = jnp.asarray(x), _t(x)
    key = jax.random.PRNGKey(5)

    jm, jlv = j.encode(jparams, jx)
    pm, plv = p.encode(pparams, px)
    _close(_np(pm), np.asarray(jm), FWD)
    _close(_np(plv), np.asarray(jlv), FWD)
    z = rng.normal(size=(7, 3)).astype(np.float32)
    _close(_np(p.decode(pparams, _t(z))),
           np.asarray(j.decode(jparams, jnp.asarray(z))), FWD)
    _close(_np(p.generate(pparams, _t(z))),
           np.asarray(j.generate(jparams, jnp.asarray(z))), FWD)
    _close(_np(p.apply(pparams, px, state={})[0]),
           np.asarray(j.apply(jparams, jx, state={}, train=False,
                              rng=None)[0]), FWD)

    jloss, jgrads = jax.value_and_grad(
        lambda q: j.pretrain_loss(q, jx, rng=key))(jparams)
    replay.queue = jax_step_draws(j, key, 7)
    ploss, _, pgrads = value_and_grad(
        lambda q: (p.pretrain_loss(q, px, rng=None), None), pparams)
    replay.done()
    assert replay.taken == num_samples
    _close(float(ploss), float(jloss), FWD)
    for k in j.param_order():
        _close(_np(pgrads[k]), np.asarray(jgrads[k]), GRAD)

    # reconstruction_probability: 4 draws, split as the JAX layer splits
    rp_key = jax.random.PRNGKey(9)
    want = np.asarray(j.reconstruction_probability(jparams, jx, rng=rp_key,
                                                   num_samples=4))
    k_rng, queue = rp_key, []
    for _ in range(4):
        k_rng, k = jax.random.split(k_rng)
        queue.append(("normal", np.asarray(jax.random.normal(
            k, (7, 3), jnp.float32))))
    replay.queue = queue
    got = _np(p.reconstruction_probability(pparams, px, rng=None,
                                           num_samples=4))
    replay.done()
    _close(got, want, FWD)


# ---------------------------------------------------------------------------
# AutoEncoder and RBM
# ---------------------------------------------------------------------------

def _layer_pair(jlayer, n_in):
    jlayer.n_in = n_in
    jlayer.weight_init = "xavier"
    jlayer.activation = jlayer.activation or "sigmoid"
    p = getattr(PL, type(jlayer).__name__).from_dict(jlayer.to_dict())
    jparams = jlayer.init_params(jax.random.PRNGKey(4))
    # a visible bias off zero, so a swapped bias would show
    jparams = dict(jparams, vb=jnp.linspace(-0.2, 0.3, n_in))
    return p, jparams, {k: _t(v) for k, v in jparams.items()}


@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_loss_and_grads_match_jax(corruption, replay):
    j = JL.AutoEncoder(n_out=5, corruption_level=corruption,
                       activation="sigmoid")
    p, jparams, pparams = _layer_pair(j, 8)
    x = np.random.default_rng(2).uniform(size=(9, 8)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jloss, jgrads = jax.value_and_grad(
        lambda q: j.pretrain_loss(q, jnp.asarray(x), rng=key))(jparams)
    replay.queue = jax_step_draws(j, key, 9)
    ploss, _, pgrads = value_and_grad(
        lambda q: (p.pretrain_loss(q, _t(x), rng=torch.Generator()), None),
        pparams)
    replay.done()
    assert replay.taken == (1 if corruption else 0)
    _close(float(ploss), float(jloss), FWD)
    for k in ("W", "b", "vb"):
        _close(_np(pgrads[k]), np.asarray(jgrads[k]), GRAD)
    _close(_np(p.apply(pparams, _t(x), state={})[0]),
           np.asarray(j.apply(jparams, jnp.asarray(x), state={},
                              train=False, rng=None)[0]), FWD)


@pytest.mark.parametrize("hidden, k", [("binary", 1), ("binary", 2),
                                       ("gaussian", 1)])
def test_rbm_cd_gradients_match_jax(hidden, k, replay):
    j = JL.RBM(n_out=6, hidden_unit=hidden, k=k, activation="sigmoid")
    p, jparams, pparams = _layer_pair(j, 10)
    v0 = (np.random.default_rng(3).uniform(size=(12, 10)) > 0.5).astype(
        np.float32)
    key = jax.random.PRNGKey(8)
    jgrads, jerr = j.cd_gradients(jparams, jnp.asarray(v0), rng=key)
    replay.queue = jax_step_draws(j, key, 12)
    pgrads, perr = p.cd_gradients(pparams, _t(v0), rng=None)
    replay.done()
    assert replay.taken == (k if hidden == "binary" else 0)
    _close(float(perr), float(jerr), FWD)
    for name in ("W", "b", "vb"):
        _close(_np(pgrads[name]), np.asarray(jgrads[name]), GRAD)
    _close(_np(p.apply(pparams, _t(v0), state={})[0]),
           np.asarray(j.apply(jparams, jnp.asarray(v0), state={},
                              train=False, rng=None)[0]), FWD)


# ---------------------------------------------------------------------------
# the containers
# ---------------------------------------------------------------------------

def _port(jnet):
    """The port's twin of a JAX net on the CPU: its config through the
    JAX JSON, its params and states copied."""
    graph = isinstance(jnet, JGraph)
    conf = (ComputationGraphConfiguration if graph
            else MultiLayerConfiguration).from_json(jnet.conf.to_json())
    cls = ComputationGraph if graph else MultiLayerNetwork
    return cls(conf, device="cpu").init(
        params=params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)),
        states=states_from_jax(conf, jax.tree.map(np.asarray, jnet.states)))


def _batches(n, rows, width, seed=0):
    rng = np.random.default_rng(seed)
    return [((rng.uniform(size=(rows, width)) > 0.5).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _queue(jnet, layers, batches, epochs):
    """The JAX draws of ``jnet.pretrain`` over ``layers`` (in walk order,
    the pretrainable ones), ``epochs`` over ``batches``: one key a step,
    split from the net's key as its ``pretrain`` splits it."""
    key, queue = jnet._rng, []
    for layer in layers:
        for _ in range(epochs):
            for x, _ in batches:
                key, k = jax.random.split(key)
                queue += jax_step_draws(layer, k, x.shape[0])
    return queue


def _mln_stack(ns, L):
    return (ns.builder().seed(21).updater("adam", learning_rate=0.01)
            .list()
            .layer(L.RBM(n_out=12, activation="sigmoid", k=2))
            .layer(L.DenseLayer(n_out=10, activation="tanh"))
            .layer(L.AutoEncoder(n_out=8, activation="sigmoid",
                                 corruption_level=0.25))
            .layer(L.VariationalAutoencoder(
                n_out=4, encoder_layer_sizes=(9,), decoder_layer_sizes=(9,),
                activation="tanh", reconstruction_distribution="gaussian",
                num_samples=2))
            .layer(L.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type((JInputType if ns is JNNC else InputType)
                            .feed_forward(14))
            .build())


def test_multilayer_pretrain_matches_jax(replay):
    jnet = JNet(_mln_stack(JNNC, JL)).init()
    pnet = _port(jnet)
    batches = _batches(3, 10, 14)
    pretrainable = [jnet.layers[i] for i in (0, 2, 3)]
    replay.queue = _queue(jnet, pretrainable, batches, epochs=2)
    n_draws = len(replay.queue)
    before = [{k: v.clone() for k, v in p.items()} for p in pnet.params]
    tensors = [t for p in pnet.params for t in p.values()]
    jnet.pretrain(JList([JDataSet(x, y) for x, y in batches]), epochs=2)
    pnet.pretrain(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
                  epochs=2)
    replay.done()
    assert replay.taken == n_draws == 3 * 2 * (2 + 1 + 2)
    _close(pnet.score_value, float(jnet.score_value), FWD)
    for i in range(5):
        for k, v in jnet.params[i].items():
            _close(_np(pnet.params[i][k]), np.asarray(v), GRAD)
    for i in (1, 4):   # the layers that cannot pretrain: untouched
        for k, v in before[i].items():
            assert torch.equal(pnet.params[i][k], v)
    # in place: the net's tensors are the ones it had
    assert all(a is b for a, b in zip(
        tensors, [t for p in pnet.params for t in p.values()]))
    assert pnet.iteration_count == 0


def test_pretrain_draws_repeat_from_one_generator_state():
    conf = MultiLayerConfiguration.from_json(
        _mln_stack(JNNC, JL).to_json())
    batches = _batches(2, 8, 14, seed=4)

    def run():
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.pretrain(ListDataSetIterator([DataSet(x, y)
                                          for x, y in batches]))
        return net.params_flat(), net.score_value

    a, la = run()
    b, lb = run()
    np.testing.assert_array_equal(a, b)
    assert la == lb
    # the VAE's ELBO falls over its own steps
    net = MultiLayerNetwork(conf, device="cpu").init()
    it = ListDataSetIterator([DataSet(x, y) for x, y in batches])
    seen = []
    vae = net.layers[3]
    orig = vae.pretrain_loss

    def spy(params, x, *, rng):
        loss = orig(params, x, rng=rng)
        seen.append(float(loss.detach()))
        return loss
    vae.pretrain_loss = spy
    try:
        net.pretrain(it, epochs=15)
    finally:
        del vae.pretrain_loss
    assert len(seen) == 30 and np.mean(seen[-4:]) < np.mean(seen[:4])


def _graph_conf(ns, L, G):
    return (ns.builder().seed(3).updater("adam", learning_rate=0.01)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", L.DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("rbm", L.RBM(n_out=7, activation="sigmoid"), "d1")
            .add_layer("ae", L.AutoEncoder(n_out=5, activation="sigmoid"),
                       "rbm")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax"),
                       "ae")
            .set_outputs("out")
            .set_input_types((JInputType if ns is JNNC else InputType)
                             .feed_forward(6))
            .build())


def test_graph_pretrain_matches_jax(replay):
    jnet = JGraph(_graph_conf(JNNC, JL, None)).init()
    pnet = _port(jnet)
    batches = _batches(2, 12, 6, seed=5)
    layers = [jnet.conf.nodes[n].layer for n in ("rbm", "ae")]
    replay.queue = _queue(jnet, layers, batches, epochs=3)
    d1 = {k: v.clone() for k, v in pnet.params["d1"].items()}
    out = {k: v.clone() for k, v in pnet.params["out"].items()}
    jnet.pretrain(JList([JDataSet(x, y) for x, y in batches]), epochs=3)
    pnet.pretrain(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
                  epochs=3)
    replay.done()
    _close(pnet.score_value, float(jnet.score_value), FWD)
    for name in ("rbm", "ae"):
        for k, v in jnet.params[name].items():
            _close(_np(pnet.params[name][k]), np.asarray(v), GRAD)
    for k, v in d1.items():
        assert torch.equal(pnet.params["d1"][k], v)
    for k, v in out.items():
        assert torch.equal(pnet.params["out"][k], v)
    # one layer alone, and a layer that cannot pretrain is skipped
    replay.queue = _queue(jnet, layers[1:], batches, epochs=1)
    jnet.pretrain_layer("ae", JList([JDataSet(x, y) for x, y in batches]))
    pnet.pretrain_layer("ae", ListDataSetIterator(
        [DataSet(x, y) for x, y in batches]))
    replay.done()
    for k, v in jnet.params["ae"].items():
        _close(_np(pnet.params["ae"][k]), np.asarray(v), GRAD)
    pnet.pretrain_layer("d1", ListDataSetIterator(
        [DataSet(x, y) for x, y in batches]))
    for k, v in d1.items():
        assert torch.equal(pnet.params["d1"][k], v)
    assert pnet._ancestors("ae") == {"in", "d1", "rbm"}


def test_graph_pretrain_autoencoder_layer():
    """pretrain() walks the topological order and trains AE nodes on the
    activations of the subgraph below (ref: CG.pretrainLayer:547-579)."""
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("adam", learning_rate=0.01)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", PL.DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("ae", PL.AutoEncoder(n_out=5, activation="sigmoid"),
                       "d1")
            .add_layer("out", PL.OutputLayer(n_out=3, activation="softmax"),
                       "ae")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(6))
            .build())
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    it = ListDataSetIterator([DataSet(x, y)])
    before_ae = {k: v.clone() for k, v in net.params["ae"].items()}
    before_d1 = {k: v.clone() for k, v in net.params["d1"].items()}
    net.pretrain(it, epochs=5)
    assert any(not torch.allclose(before_ae[k], net.params["ae"][k])
               for k in before_ae)
    for k in before_d1:
        assert torch.equal(before_d1[k], net.params["d1"][k])
    assert np.isfinite(float(net.fit_batch(DataSet(x, y))))


def _two_input_graph(ns, L, G, IT):
    return (ns.builder().seed(3).updater("sgd", learning_rate=0.05)
            .graph_builder()
            .add_inputs("seq", "static")
            .add_layer("lstm", L.LSTM(n_out=4, activation="tanh"), "seq")
            .add_vertex("dup", G.DuplicateToTimeSeriesVertex("seq"),
                        "static")
            .add_vertex("cat", G.MergeVertex(), "lstm", "dup")
            .add_layer("ae", L.AutoEncoder(n_out=3, activation="sigmoid"),
                       "cat", "static")
            .add_layer("out", L.RnnOutputLayer(n_out=2, activation="softmax"),
                       "cat")
            .set_outputs("out")
            .set_input_types(IT.recurrent(3), IT.feed_forward(2))
            .build())


def test_graph_multi_input_node_raises_and_ancestors_follow_the_t_source():
    from deeplearning4j_tpu.nn.conf import graph as jg
    from deeplearning4j_tpu_torch.nn.conf import graph as pg
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    jnet = JGraph(_two_input_graph(JNNC, JL, jg, JInputType)).init()
    pnet = ComputationGraph(_two_input_graph(NeuralNetConfiguration, PL, pg,
                                             InputType), device="cpu").init()
    rng = np.random.default_rng(1)
    seq = rng.normal(size=(2, 4, 3)).astype(np.float32)
    static = rng.normal(size=(2, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 4))]
    with pytest.raises(ValueError, match="single-input node") as je:
        jnet.pretrain(JList([JMDS([seq, static], [y])]))
    with pytest.raises(ValueError, match="single-input node") as pe:
        pnet.pretrain(ListDataSetIterator([MultiDataSet([seq, static], [y])]))
    assert str(pe.value) == str(je.value)
    assert pnet._ancestors("out") == jnet._ancestors("out") == {
        "cat", "lstm", "dup", "seq", "static"}


@pytest.mark.parametrize("field, value", [("pretrain", True),
                                          ("backprop", False)])
def test_c33_fit_ignores_pretrain_and_backprop_as_jax_does(field, value):
    """ROADMAP C33: the JAX package reads neither setting outside its
    builder, so ``fit`` trains by backprop whatever they say; the port
    does the same, loss for loss."""
    jconf = _mln_stack(JNNC, JL)
    setattr(jconf.training, field, value)
    jnet = JNet(jconf).init()
    pnet = _port(jnet)
    assert getattr(pnet.conf.training, field) == value
    batches = _batches(3, 10, 14, seed=9)
    jl = [float(jnet.fit_batch(JDataSet(x, y))) for x, y in batches]
    pl = [float(pnet.fit_batch(DataSet(x, y))) for x, y in batches]
    _close(pl[0], jl[0], FWD)
    _close(pl, jl, GRAD)


def test_list_builder_pretrain_flag_crosses():
    conf = (NeuralNetConfiguration.builder().list()
            .layer(PL.AutoEncoder(n_out=3, activation="sigmoid"))
            .layer(PL.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).pretrain(True)
            .build())
    assert conf.training.pretrain
    jconf = JNNC.builder().list().layer(JL.AutoEncoder(
        n_out=3, activation="sigmoid")).layer(JL.OutputLayer(
            n_out=2, activation="softmax")).set_input_type(
        JInputType.feed_forward(4)).pretrain(True).build()
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------

def _serde_conf(ns, L, IT, V):
    comp = V.CompositeReconstructionDistribution(
        [(10, "bernoulli"), (4, "gaussian")])
    return (ns.builder().seed(5).updater("rmsprop", learning_rate=0.01)
            .list()
            .layer(L.VariationalAutoencoder(
                n_out=3, encoder_layer_sizes=(8, 6), decoder_layer_sizes=(6,),
                activation="leakyrelu", reconstruction_distribution=comp,
                pzx_activation="identity", num_samples=2))
            .layer(L.AutoEncoder(n_out=5, corruption_level=0.1,
                                 activation="sigmoid"))
            .layer(L.RBM(n_out=4, hidden_unit="gaussian", k=3,
                         activation="sigmoid"))
            .layer(L.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(IT.feed_forward(14))
            .build())


def test_pretrain_layer_configs_cross_the_jax_json_both_ways():
    jconf = _serde_conf(JNNC, JL, JInputType, jvar)
    pconf = _serde_conf(NeuralNetConfiguration, PL, InputType, pvar)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    from deeplearning4j_tpu.nn.conf.builder import MultiLayerConfiguration \
        as JMLC
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    rd = back.layers[0].reconstruction_distribution
    assert isinstance(rd, pvar.CompositeReconstructionDistribution)
    jback = JMLC.from_json(pconf.to_json())
    assert json.loads(jback.to_json()) == json.loads(pconf.to_json())
    assert isinstance(jback.layers[0].reconstruction_distribution,
                      jvar.CompositeReconstructionDistribution)
    assert (back.layers[2].hidden_unit, back.layers[2].k) == ("gaussian", 3)
    assert back.layers[1].corruption_level == 0.1


def test_pretrained_vae_zip_crosses_both_ways(tmp_path):
    pnet = MultiLayerNetwork(_serde_conf(NeuralNetConfiguration, PL,
                                         InputType, pvar), device="cpu").init()
    batches = _batches(2, 6, 14, seed=3)
    pnet.pretrain(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    pnet.fit_batch(DataSet(*batches[0]))
    path = tmp_path / "port.zip"
    ModelSerializer.write_model(pnet, path)
    jnet = JSerializer.restore_model(path)
    x = batches[1][0]
    _close(np.asarray(jnet.output(x)), _np(pnet.output(x)), FWD)
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()),
                                  pnet.params_flat())
    jpath = tmp_path / "jax.zip"
    JSerializer.write_model(jnet, jpath)
    back = ModelSerializer.restore_model(jpath, device="cpu")
    np.testing.assert_array_equal(back.params_flat(), pnet.params_flat())
    assert isinstance(back.layers[0].reconstruction_distribution,
                      pvar.CompositeReconstructionDistribution)
