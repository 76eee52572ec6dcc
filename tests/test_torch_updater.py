"""The port's updater pipeline (deeplearning4j_tpu_torch.nn.updater) against
the JAX package's (nn/updater.py, built on optax 0.2.6): every update
rule, every learning-rate policy, every gradient normalization, frozen
layers, per-layer learning rates, ``minimize=False``, the L1/L2 penalty
and both container layouts (a graph's dict, a stack's list). The same
numpy params and gradients go to both for 5 steps; the params after every
step agree to 1e-6 (relative and absolute: f32 rounding order only)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf import builder as jb
from deeplearning4j_tpu.nn import updater as ju
from deeplearning4j_tpu.nn.layers.core import DenseLayer as JDense
from deeplearning4j_tpu_torch.nn.conf import builder as tb
from deeplearning4j_tpu_torch.nn import updater as tu
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer as TDense

TOL = 1e-6
STEPS = 5
SHAPES = {"a": {"W": (4, 3), "b": (3,)}, "c": {"W": (3, 2), "b": (2,)}}


def _trainings(updater="sgd", lr=0.1, training=None, **ukw):
    """The same TrainingConfig in both packages."""
    out = []
    for mod in (jb, tb):
        u = mod.UpdaterConfig(name=updater, learning_rate=lr, **ukw)
        out.append(mod.TrainingConfig(updater=u, **(training or {})))
    return out


def _layers(layer_kw=None):
    """One dense layer conf per param group, in both packages."""
    out = []
    for cls in (JDense, TDense):
        ls = []
        for name, shp in SHAPES.items():
            layer = cls(n_out=shp["W"][1], name=name,
                        **(layer_kw or {}).get(name, {}))
            layer.n_in = shp["W"][0]
            ls.append(layer)
        out.append(ls)
    return out


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: {k: (rng.normal(size=s) * scale).astype(np.float32)
                for k, s in p.items()} for n, p in SHAPES.items()}


def _as_list(tree):
    return [tree[n] for n in SHAPES]


def _run(trainings, layer_kw=None, as_list=False, grad_scale=1.0):
    """5 steps of compute_updates on both sides; yields the params of both
    after every step, as numpy."""
    (jt, tt), (jlayers, tlayers) = trainings, _layers(layer_kw)
    p0 = _arrays(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tu.tree_map(torch.from_numpy, p0)
    if as_list:
        jp, tp = _as_list(jp), _as_list(tp)
    jtx, ttx = ju.build_optimizer(jt), tu.build_optimizer(tt)
    jopt, topt = jtx.init(jp), ttx.init(tp)
    for step in range(STEPS):
        g = _arrays(100 + step, grad_scale)
        jg = jax.tree.map(jnp.asarray, g)
        tg = tu.tree_map(torch.from_numpy, g)
        if as_list:
            jg, tg = _as_list(jg), _as_list(tg)
        jp, jopt = ju.compute_updates(jtx, jg, jopt, jp, jlayers, jt)
        tp, topt = tu.compute_updates(ttx, tg, topt, tp, tlayers, tt)
        yield ([np.asarray(x) for x in jax.tree_util.tree_leaves(jp)],
               [x.numpy() for x in tu.tree_leaves(tp)])


def _assert_same(trainings, **kw):
    for step, (ref, got) in enumerate(_run(trainings, **kw)):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}")


UPDATERS = ["sgd", "nesterovs", "adam", "adamax", "adagrad", "adadelta",
            "rmsprop", "none"]


@pytest.mark.parametrize("minimize", [True, False],
                         ids=["minimize", "maximize"])
@pytest.mark.parametrize("updater", UPDATERS)
def test_update_rule_matches_optax(updater, minimize):
    _assert_same(_trainings(updater, lr=0.05,
                            training=dict(minimize=minimize)))


@pytest.mark.parametrize("policy,kw", [
    ("exponential", dict(decay_rate=0.7)),
    ("inverse", dict(decay_rate=0.5, power=0.75)),
    ("poly", dict(power=2.0, steps=4.0)),
    ("sigmoid", dict(decay_rate=1.5, steps=2.0)),
    ("step", dict(decay_rate=0.5, steps=2.0)),
    ("schedule", dict(schedule={1: 0.05, 3: 0.01})),
])
@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_lr_policy_matches_jax(updater, policy, kw):
    ukw = dict(lr_policy=policy,
               lr_policy_decay_rate=kw.get("decay_rate", 0.0),
               lr_policy_power=kw.get("power", 1.0),
               lr_policy_steps=kw.get("steps", 1.0),
               lr_schedule=kw.get("schedule"))
    _assert_same(_trainings(updater, lr=0.1, **ukw))
    ju_sched = ju.make_lr_schedule(_trainings(**ukw)[0].updater)
    tu_sched = tu.make_lr_schedule(_trainings(**ukw)[1].updater)
    for step in range(8):
        assert tu_sched(step) == pytest.approx(float(ju_sched(step)),
                                               rel=TOL)


@pytest.mark.parametrize("as_list", [False, True], ids=["graph", "stack"])
@pytest.mark.parametrize("kind", [
    "renormalizel2perlayer", "renormalizel2perparamtype",
    "clipelementwiseabsolutevalue", "clipl2perlayer", "clipl2perparamtype"])
def test_gradient_normalization_matches_jax(kind, as_list):
    """A threshold of 0.5 with gradients of scale 2: every clip fires."""
    _assert_same(_trainings("adam", lr=0.05, training=dict(
        gradient_normalization=kind,
        gradient_normalization_threshold=0.5)), as_list=as_list,
        grad_scale=2.0)


@pytest.mark.parametrize("as_list", [False, True], ids=["graph", "stack"])
def test_frozen_layer_takes_no_update(as_list):
    _assert_same(_trainings("adam", lr=0.05, training=dict(
        gradient_normalization="clipl2perlayer",
        gradient_normalization_threshold=0.5)),
        layer_kw={"a": dict(frozen=True)}, as_list=as_list)
    p0 = _arrays(0)
    *_, (_, got) = _run(_trainings("adam", lr=0.05),
                        layer_kw={"a": dict(frozen=True)})
    np.testing.assert_array_equal(got[0], p0["a"]["W"])


@pytest.mark.parametrize("as_list", [False, True], ids=["graph", "stack"])
def test_per_layer_learning_rate_matches_jax(as_list):
    _assert_same(_trainings("rmsprop", lr=0.1),
                 layer_kw={"c": dict(learning_rate=0.02)}, as_list=as_list)


def test_l1_l2_penalty_matches_jax():
    kw = {"a": dict(l1=0.01, l2=0.2, l1_bias=0.03, l2_bias=0.5),
          "c": dict(l2=0.1)}
    jlayers, tlayers = _layers(kw)
    p = _arrays(3)
    ref = float(ju.l1_l2_penalty(
        [jax.tree.map(jnp.asarray, p[n]) for n in SHAPES], jlayers))
    got = float(tu.l1_l2_penalty(
        [tu.tree_map(torch.from_numpy, p[n]) for n in SHAPES], tlayers))
    assert got == pytest.approx(ref, rel=TOL)
    assert tu.l1_l2_penalty([p["a"]], [TDense(n_out=3)]) == 0.0


def test_optimizer_state_mirrors_the_params():
    _, tt = _trainings("adam")
    params = tu.tree_map(torch.from_numpy, _arrays(0))
    state = tu.build_optimizer(tt).init(params)
    assert state["count"] == 0 and set(state) == {"count", "mu", "nu"}
    assert tu.tree_map(lambda t: tuple(t.shape), state["mu"]) == \
        tu.tree_map(lambda t: tuple(t.shape), params)
    _, tt = _trainings("adagrad")
    acc = tu.build_optimizer(tt).init(params)["sum_of_squares"]
    assert all(bool((t == 0.1).all()) for t in tu.tree_leaves(acc))


def test_unknown_updater_and_policy_raise():
    _, tt = _trainings()
    with pytest.raises(ValueError, match="Unknown updater"):
        tu.build_optimizer(dataclasses.replace(
            tt, updater=tb.UpdaterConfig(name="lamb")))
    with pytest.raises(ValueError, match="Unknown lr policy"):
        tu.make_lr_schedule(tb.UpdaterConfig(lr_policy="cosine"))


@pytest.mark.parametrize("value,mixed", [
    (None, False), ("fp32", False), ("float32", False), ("bf16", True),
    ("fp16", True)])
def test_precision_policy_parse_matches_jax(value, mixed):
    got = tu.PrecisionPolicy.parse(value)
    ref = ju.PrecisionPolicy.parse(value)
    assert (got.compute_dtype, got.params_dtype, got.mixed) == \
        (ref.compute_dtype, ref.params_dtype, mixed)
    with pytest.raises(ValueError):
        tu.PrecisionPolicy.parse("int8")
