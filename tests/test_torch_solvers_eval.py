"""The port's line-search solvers (``optimize/solvers.py``) and ROC /
regression evaluation (``eval/roc.py``, ``eval/regression.py``) against
the JAX package:

- every case of ``tests/test_optimizers.py`` on the port: the convex toy
  problems per algorithm, the Armijo search, an Iris MLP and a graph
  trained by L-BFGS and conjugate gradient, ``fit_batch`` routed through
  the solver;
- the same Iris MLP on copied weights through both packages' ``Solver``
  for 10 iterations: the final scores within 1e-5 (relative) and the
  params within 1e-4 of their largest |w|;
- ``ROC``, ``ROCMultiClass`` and ``RegressionEvaluation`` equal the JAX
  classes on the same arrays, and the containers' ``evaluate_roc`` /
  ``evaluate_roc_multi_class`` / ``evaluate_regression`` (the case of
  ``tests/test_evaluation.py``) on both containers.
"""

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import (
    InputType as JInputType, MultiLayerNetwork as JNet,
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.eval.regression import (
    RegressionEvaluation as JRegression,
)
from deeplearning4j_tpu.eval.roc import ROC as JROC, ROCMultiClass as JROCM
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as JDense, OutputLayer as JOutput,
)
from deeplearning4j_tpu.optimize.solvers import Solver as JSolver

from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.datasets import (
    DataSet, IrisDataSetIterator, ListDataSetIterator,
)
from deeplearning4j_tpu_torch.eval import (
    ROC, RegressionEvaluation, ROCMultiClass,
)
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.solvers import (
    Solver, backtrack_line_search, minimize,
)

ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]


def sphere(x):
    return float(x @ x), 2.0 * x


def rosenbrock(x):
    a, b = 1.0, 100.0
    f = float((a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2)
    g = np.array([
        -2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
        2 * b * (x[1] - x[0] ** 2),
    ])
    return f, g


@pytest.mark.parametrize("algo", ALGOS)
def test_sphere_minimized(algo):
    x, fx, _ = minimize(sphere, np.array([3.0, -4.0, 5.0]), method=algo,
                        max_iters=200)
    assert fx < 1e-6, (algo, fx)
    np.testing.assert_allclose(x, 0.0, atol=1e-3)


@pytest.mark.parametrize("algo,tol_f,tol_x", [
    ("lbfgs", 1e-5, 1e-2),
    # CG with Armijo-only backtracking stalls near the optimum on the
    # Rosenbrock valley (it needs Wolfe curvature to keep conjugacy)
    ("conjugate_gradient", 1e-3, 5e-2),
])
def test_rosenbrock_minimized(algo, tol_f, tol_x):
    x, fx, it = minimize(rosenbrock, np.array([-1.2, 1.0]), method=algo,
                         max_iters=2000)
    assert fx < tol_f, (algo, fx, it)
    np.testing.assert_allclose(x, [1.0, 1.0], atol=tol_x)


def test_line_search_respects_armijo():
    f = lambda x: float(x @ x)  # noqa: E731
    x, g = np.array([2.0]), np.array([4.0])
    step = backtrack_line_search(f, x, f(x), g, -g)
    assert step > 0
    assert f(x - step * g) < f(x)


def test_line_search_rejects_ascent_direction():
    f = lambda x: float(x @ x)  # noqa: E731
    x, g = np.array([2.0]), np.array([4.0])
    assert backtrack_line_search(f, x, f(x), g, +g) == 0.0


def test_unknown_algo_raises():
    with pytest.raises(ValueError, match="optimization algorithm"):
        minimize(sphere, np.ones(2), method="newton")


def _iris_mlp(algo, seed=1, hidden=12):
    return (NeuralNetConfiguration.builder().seed(seed)
            .optimization_algo(algo)
            .list()
            .layer(DenseLayer(n_out=hidden, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(4))
            .build())


def _iris_pair(algo):
    """The Iris MLP in both packages, the JAX net's weights copied into
    the port's."""
    jconf = (JNNC.builder().seed(1).optimization_algo(algo).list()
             .layer(JDense(n_out=12, activation="tanh"))
             .layer(JOutput(n_out=3, activation="softmax"))
             .set_input_type(JInputType.feed_forward(4)).build())
    jnet = JNet(jconf).init()
    conf = _iris_mlp(algo)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient"])
def test_network_trains_with_solver(algo):
    """60 solver iterations on copied weights halve the score. The
    accuracy gate is the JAX test's 0.9 for L-BFGS; for conjugate
    gradient it is the JAX net's own accuracy after the same run, less
    0.05: both packages agree to 2e-6 through 10 iterations
    (``test_solver_matches_jax_solver_on_copied_weights``), after which
    f32 rounding of the objective steers Armijo-only CG apart (the port
    0.900, JAX 0.913 on the CPU)."""
    jnet, net = _iris_pair(algo)
    ds = next(iter(IrisDataSetIterator(150)))
    s0 = net.score(ds)
    s1 = Solver(net, max_iterations=60).optimize(ds)
    assert s1 < s0 * 0.5, (s0, s1)
    assert net.score(ds) == pytest.approx(s1, rel=1e-5)
    acc = net.evaluate(IrisDataSetIterator(150)).accuracy()
    if algo == "lbfgs":
        assert acc > 0.9, acc
        return
    from deeplearning4j_tpu.datasets.iris import (
        IrisDataSetIterator as JIris,
    )
    jds = next(iter(JIris(150)))
    JSolver(jnet, max_iterations=60).optimize(jds)
    ref = jnet.evaluate(JIris(150)).accuracy()
    assert acc >= ref - 0.05, (acc, ref)


def test_fit_batch_routes_through_solver():
    net = MultiLayerNetwork(_iris_mlp("lbfgs", seed=2, hidden=8),
                            device="cpu").init()
    ds = next(iter(IrisDataSetIterator(150)))
    before = net.score(ds)
    for _ in range(3):
        after = net.fit_batch(ds)
    assert after < before
    assert net.iteration_count == 3


@pytest.mark.parametrize("algo", ["conjugate_gradient", "lbfgs"])
def test_graph_trains_with_solver(algo):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    conf = (NeuralNetConfiguration.builder().seed(1)
            .optimization_algo(algo)
            .updater("sgd").learning_rate(0.5).weight_init("xavier")
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax"),
                       "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    net = ComputationGraph(conf, device="cpu").init()
    ds = DataSet(x, y)
    s0 = net.score(ds)
    for _ in range(30):
        net.fit_batch(ds)
    assert net.score(ds) < s0 * 0.8, (s0, net.score(ds))


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient"])
def test_solver_matches_jax_solver_on_copied_weights(algo):
    """10 iterations of both packages' solvers from the same weights:
    the final score within 1e-5 (relative), the params within 1e-4 of
    their largest |w| (measured 2e-6 and less: f32 objectives, the search
    in f64 on the host). Past ~10 iterations the two packages' f32
    rounding steers the line searches apart."""
    jnet, tnet = _iris_pair(algo)
    ds = next(iter(IrisDataSetIterator(150)))
    ref = JSolver(jnet, max_iterations=10).optimize(
        JDataSet(ds.features, ds.labels))
    got = Solver(tnet, max_iterations=10).optimize(ds)
    assert got == pytest.approx(ref, rel=1e-5)
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    for i, p in enumerate(jp):
        for k, r in p.items():
            err = np.abs(tp[i][k] - r).max() / max(np.abs(r).max(), 1e-30)
            assert err < 1e-4, (i, k, err)


# ------------------------------------------------------------ evaluation

def test_roc_and_regression_equal_the_jax_classes():
    rng = np.random.default_rng(4)
    B, T, C = 6, 5, 3
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, T))]
    probs = rng.dirichlet(np.ones(C), (B, T)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    pairs = [(ROCMultiClass(20), JROCM(20))]
    for got, ref in pairs:
        for e in (got, ref):
            e.eval(labels, probs, mask=mask)
        for c in range(C):
            assert got.calculate_auc(c) == ref.calculate_auc(c)
        assert got.calculate_average_auc() == ref.calculate_average_auc()
    y2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 40)]
    p2 = rng.dirichlet(np.ones(2), 40).astype(np.float32)
    roc, jroc = ROC(50), JROC(50)
    roc.eval(y2, p2)
    jroc.eval(y2, p2)
    assert roc.get_roc_curve() == jroc.get_roc_curve()
    assert roc.calculate_auc() == jroc.calculate_auc()
    reg, jreg = RegressionEvaluation(), JRegression()
    yr = rng.normal(size=(B, T, 2))
    pr = yr + 0.1 * rng.normal(size=(B, T, 2))
    for e in (reg, jreg):
        e.eval(yr, pr, mask=mask)
    for c in range(2):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "correlation_r2"):
            assert getattr(reg, m)(c) == getattr(jreg, m)(c)
    assert reg.stats() == jreg.stats()


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_container_evaluate_roc_and_regression(container):
    """evaluate_roc / evaluate_roc_multi_class / evaluate_regression on
    the containers (ref: MultiLayerNetwork.evaluateROC:2436,
    evaluateROCMultiClass:2449, evaluateRegression)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    labels2 = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    yreg = (x @ rng.normal(size=(4, 2))).astype(np.float32)

    def build(n_out, act, loss, lr, hidden, h_act):
        b = (NeuralNetConfiguration.builder().seed(1)
             .updater("adam", learning_rate=lr).weight_init("xavier"))
        if container == "multilayer":
            conf = (b.list()
                    .layer(DenseLayer(n_out=hidden, activation=h_act))
                    .layer(OutputLayer(n_out=n_out, activation=act,
                                       loss=loss))
                    .set_input_type(InputType.feed_forward(4)).build())
            return MultiLayerNetwork(conf, device="cpu").init()
        conf = (b.graph_builder().add_inputs("in")
                .add_layer("d", DenseLayer(n_out=hidden, activation=h_act),
                           "in")
                .add_layer("out", OutputLayer(n_out=n_out, activation=act,
                                              loss=loss), "d")
                .set_outputs("out")
                .set_input_types(InputType.feed_forward(4)).build())
        return ComputationGraph(conf, device="cpu").init()

    net = build(2, "softmax", "mcxent", 0.05, 8, "relu")
    it = ListDataSetIterator([DataSet(x, labels2)])
    net.fit(it, epochs=30, use_async=False)
    assert net.evaluate_roc(it).calculate_auc() > 0.9
    assert net.evaluate_roc_multi_class(it).calculate_auc(1) > 0.9
    net_r = build(2, "identity", "mse", 0.02, 16, "tanh")
    it_r = ListDataSetIterator([DataSet(x, yreg)])
    net_r.fit(it_r, epochs=60, use_async=False)
    reg = net_r.evaluate_regression(it_r)
    assert reg.correlation_r2(0) > 0.9 and reg.correlation_r2(1) > 0.9
    assert reg.average_mean_squared_error() < 0.5
