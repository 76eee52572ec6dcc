"""The single-card training features of the port (ROADMAP A2) against the
JAX package, on copied weights (``convert.params_from_jax``), with the JAX
side's Pallas kernels in interpret mode unless a case says otherwise:

- bf16 mixed precision with f32 masters: the GPT's first loss and every
  gradient against the JAX bf16 policy (K4-K6 interpreted), the char-RNN
  under standard backprop against K2/K3 interpreted, and under tBPTT
  against the JAX package's kernel-off route (``DL4J_TPU_PALLAS=off``,
  f32 carries; ROADMAP C14), with the reference's own ``ValueError`` on
  its kernel route pinned. bf16 tolerances: the loss within 1.6e-2
  (relative), each gradient within 3.2e-2 of its largest |g| (measured on
  the CPU: the GPT's loss 6e-7, its gradients 1.5e-2; the char-RNN's
  standard step 1.8e-2, tBPTT 8.7e-3 over one window and 1.3e-2 over
  two, with SGD at lr 1 so that the update is the gradient);
- the fp32 preset bitwise the plain step (no cast added);
- the divergence sentinel's container cases of
  ``tests/test_resilience.py``, and a bad step leaving the params, the
  moments, the count, the layer states and the tBPTT carries bitwise as
  they were; guarded clean steps match unguarded ones;
- every case of ``tests/test_scan_fit.py`` (and a window bitwise its
  ``fit_batch`` calls), the listeners and ``TrainingStats`` unit cases of
  ``tests/test_training_stats.py``;
- remat with dropout on bitwise equal to remat off, within the port.
"""

import logging
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import (
    PrecisionPolicy as JPolicy, cast_floats as jcast_floats,
    precision_value_and_grad as jprecision_value_and_grad,
)

from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator, MultiDataSet,
)
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.models.resnet import resnet_tiny
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, DenseLayer, OutputLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.netcommon import value_and_grad
from deeplearning4j_tpu_torch.nn.updater import (
    PrecisionPolicy, compute_updates, make_lr_schedule,
    precision_value_and_grad, tree_leaves,
)
from deeplearning4j_tpu_torch.nn.conf.builder import UpdaterConfig
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener, ComposableIterationListener,
    ParamAndGradientIterationListener, PerformanceListener,
    ScoreIterationListener, TrainingListener,
)
from deeplearning4j_tpu_torch.optimize.training_stats import TrainingStats
from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, set_registry,
)
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.faultinject import (
    Fault, FaultSchedule,
)
from deeplearning4j_tpu_torch.resilience.sentinel import (
    DivergenceError, DivergenceSentinel, RollbackRequested, guard_update,
    nonfinite_flag,
)

#: bf16 against the JAX bf16 policy: the loss (relative) and each
#: gradient against its largest |g| (two and four bf16 ulps of 1.0)
BF16_LOSS_RTOL = 1.6e-2
BF16_GRAD_TOL = 3.2e-2
RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True)
def _interpret_and_registry(monkeypatch):
    """The JAX side runs its Pallas kernels in interpret mode; each test
    counts into a fresh metrics registry."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    prev = set_registry(MetricsRegistry())
    yield
    faultinject.clear()
    set_registry(prev)


def _worst_rel(got, ref):
    """The worst tensor's max |got - ref| over its own largest |ref|, over
    two containers of numpy arrays (dicts or lists of dicts)."""
    keys = ref.keys() if isinstance(ref, dict) else range(len(ref))
    worst = 0.0
    for k in keys:
        for name, r in ref[k].items():
            g = got[k][name]
            worst = max(worst, float(np.abs(g - r).max())
                        / max(float(np.abs(r).max()), 1e-30))
    return worst


# ---------------------------------------------------------------- bf16

def _gpt_arrays(V=16, T=16, B=4, seed=2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return [eye[tok[:, :-1]], eye[tok[:, 1:]]]


def test_bf16_gpt_first_loss_and_grads_match_jax_policy():
    """The bf16 GPT (K4-K6 interpreted on the JAX side): the first loss
    and every f32 gradient against ``precision_value_and_grad`` of the
    JAX container's loss on bf16 inputs; the gradients are f32 masters'
    and the params stay f32 after a step."""
    V, T = 16, 16
    jconf = jgpt.gpt_tiny(vocab_size=V, seq_len=T)
    jconf.training.precision = "bf16"
    jnet = JGraph(jconf).init()
    conf = tgpt.gpt_tiny(vocab_size=V, seq_len=T, precision="bf16")
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    a = _gpt_arrays(V, T)
    inputs, labels, masks, lmasks = jnet._split(JDataSet(*a))
    inputs = jcast_floats(inputs, jnp.bfloat16)
    (ref_loss, _), ref = jprecision_value_and_grad(
        lambda p: jnet._loss_fn(p, jnet.states, inputs, labels, masks,
                                lmasks, None),
        JPolicy.parse("bf16"))(jnet.params)
    grads, loss, _ = tnet.compute_gradient_and_score(DataSet(*a))
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert float(loss) == pytest.approx(float(ref_loss), rel=BF16_LOSS_RTOL)
    worst = _worst_rel(params_to_numpy(grads), jax.tree.map(np.asarray, ref))
    assert worst <= BF16_GRAD_TOL, worst
    tnet.fit_batch(DataSet(*a))
    assert all(p.dtype == torch.float32 for p in tree_leaves(tnet.params))


def _char_pair(bp, updater="sgd", learning_rate=1.0, V=12, H=16):
    kw = dict(hidden=H, layers=2, tbptt_length=4, updater=updater,
              learning_rate=learning_rate)
    jconf = jchar_rnn(V, **kw)
    jconf.training.precision = "bf16"
    jconf.training.backprop_type = bp
    jnet = JNet(jconf).init()
    conf = char_rnn_lstm(V, **kw)
    conf.training.precision = "bf16"
    conf.training.backprop_type = bp
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _char_arrays(T, V=12, B=2, seed=3):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return [eye[tok[:, :T]], eye[tok[:, 1:T + 1]]]


def _step_deltas_match(jnet, tnet, a):
    """One ``fit_batch`` on both nets under SGD at lr 1: the losses, and
    each param's update (= minus its gradient) against the JAX net's."""
    p0 = jax.tree.map(np.asarray, jnet.params)
    ref = float(jnet.fit_batch(JDataSet(*a)))
    got = float(tnet.fit_batch(DataSet(*a)))
    assert got == pytest.approx(ref, rel=BF16_LOSS_RTOL)
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    d_ref = [{k: jp[i][k] - p0[i][k] for k in p0[i]} for i in range(len(p0))]
    d_got = [{k: tp[i][k] - p0[i][k] for k in p0[i]} for i in range(len(p0))]
    worst = _worst_rel(d_got, d_ref)
    assert worst <= BF16_GRAD_TOL, worst
    assert all(p.dtype == torch.float32 for p in tree_leaves(tnet.params))


def test_bf16_char_rnn_standard_backprop_matches_jax_kernels():
    """Standard backprop in bf16 over [2, 8]: the JAX net runs K2/K3 in
    interpret mode on bf16 inputs and carries; the port's plain versions
    of K2/K3 in bf16."""
    jnet, tnet = _char_pair("standard")
    _step_deltas_match(jnet, tnet, _char_arrays(8))


@pytest.mark.parametrize("T", [4, 8], ids=["one_window", "two_windows"])
def test_bf16_char_rnn_tbptt_matches_jax_kernel_off_route(monkeypatch, T):
    """tBPTT in bf16 (windows of 4): the port starts each window's
    carries in bf16 and runs K2/K3's contract in bf16 (ROADMAP C14); the
    JAX package, whose own kernel refuses this case, runs with its
    kernels off (``lax.scan``, f32 carries). They agree at bf16
    tolerances: the loss and every update."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "off")
    jnet, tnet = _char_pair("truncated_bptt")
    _step_deltas_match(jnet, tnet, _char_arrays(T))


def test_jax_bf16_tbptt_kernel_route_raises_c14():
    """ROADMAP C14, pinned: the JAX package's tBPTT starts its carries in
    the training dtype (f32), its Pallas K2 keeps them in scratch of the
    input dtype (bf16), and the first store raises. When this stops
    raising, C14 is retired and the port's bf16 carries are held to the
    kernel route instead."""
    jnet, _ = _char_pair("truncated_bptt")
    with pytest.raises(ValueError, match="Invalid dtype for `swap`"):
        jnet.fit_batch(JDataSet(*_char_arrays(8)))


def test_precision_value_and_grad_scales_and_casts():
    """The seams: params cast to bf16 (gradients in f32), the loss cast
    to f32, a loss scale multiplies the loss and divides the gradients
    (a power of two: bitwise the unscaled gradients)."""
    w = {"w": torch.tensor([1.5, -2.0, 0.25])}
    seen = []

    def loss_fn(p):
        seen.append(p["w"].dtype)
        return (p["w"] ** 2).sum(), None

    plain = precision_value_and_grad(loss_fn, w, PrecisionPolicy.parse(
        "bf16"), value_and_grad)
    scaled = precision_value_and_grad(loss_fn, w, PrecisionPolicy.parse(
        "bf16", loss_scale=1024.0), value_and_grad)
    assert seen == [torch.bfloat16, torch.bfloat16]
    for loss, _, g in (plain, scaled):
        assert loss.dtype == torch.float32 and g["w"].dtype == torch.float32
        assert float(loss) == pytest.approx(6.3125)
    assert torch.equal(plain[2]["w"], scaled[2]["w"])
    assert torch.equal(plain[2]["w"], torch.tensor([3.0, -4.0, 0.5]))


def _mlp_conf(seed=4, updater="adam", lr=0.01, **builder):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).weight_init("xavier"))
    for k, v in builder.items():
        getattr(b, k)(*v) if isinstance(v, tuple) else getattr(b, k)(v)
    return (b.list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def _batches(n=5, b=8, f=6):
    out = []
    for _ in range(n):
        x = RNG.normal(size=(b, f)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, b)]
        out.append(DataSet(x, y))
    return out


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_fp32_preset_is_bitwise_the_plain_step(container):
    """The fp32 preset adds no cast: ``fit_batch`` is bitwise the plain
    step (``value_and_grad`` of the loss, then ``compute_updates``)."""
    if container == "multilayer":
        conf = _mlp_conf(precision="fp32")
        nets = [MultiLayerNetwork(conf, device="cpu").init()
                for _ in range(2)]
        layers = nets[0].layers
    else:
        conf = tgpt.gpt_tiny(vocab_size=16, seq_len=16, precision="fp32")
        nets = [ComputationGraph(conf, device="cpu").init()
                for _ in range(2)]
        layers = [conf.nodes[n].layer for n in nets[0]._layer_nodes]
    batches = (_batches(3) if container == "multilayer"
               else [DataSet(*_gpt_arrays(seed=s)) for s in range(3)])
    fitted, plain = nets
    for ds in batches:
        fitted.fit_batch(ds)
        if container == "multilayer":
            batch = plain._batch(ds)
            loss, (states, _, _), grads = value_and_grad(
                lambda p: plain._loss_fn(p, plain.states, *batch,
                                         rng=plain._rng), plain.params)
        else:
            inputs, labels, masks, lmasks = plain._split(ds)
            loss, states, grads = value_and_grad(
                lambda p: plain._loss_fn(p, plain.states, inputs, labels,
                                         masks, lmasks, rng=plain._rng),
                plain.params)
        compute_updates(plain._tx, grads, plain.opt_state, plain.params,
                        layers, conf.training)
    for a, b in zip(tree_leaves(fitted.params), tree_leaves(plain.params)):
        assert torch.equal(a, b)
    assert fitted.opt_state["count"] == plain.opt_state["count"] == 3


# ------------------------------------------------------------ sentinel

def _net(seed=1):
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(seed)
        .updater("adam").learning_rate(0.05).list()
        .layer(DenseLayer(n_out=8, activation="relu"))
        .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(4)).build(),
        device="cpu").init()


def _sbatches(n, b=6):
    return _batches(n, b, f=4)


def _poisoned(ds):
    bad = DataSet(np.array(ds.features), ds.labels)
    bad.features[0, 0] = np.nan
    return bad


def test_sentinel_skip_batch_counts_and_keeps_params_finite():
    from deeplearning4j_tpu_torch.profiling.metrics import get_registry
    net = _net()
    sentinel = DivergenceSentinel(policy="skip_batch", lag=1)
    net.set_divergence_sentinel(sentinel)
    faultinject.set_schedule(FaultSchedule([Fault("nan", step=2)]))
    for i, b in enumerate(_sbatches(3)):
        net.fit_batch(faultinject.poison_batch(b, i + 1))
    sentinel.flush()
    assert sentinel.skipped_batches == 1
    assert np.isfinite(net.params_flat()).all()
    snap = get_registry().snapshot("resilience_")
    assert snap["resilience_nonfinite_steps_total"] == 1
    assert snap["resilience_faults_injected_total"] == 1


def test_sentinel_raise_names_step():
    net = _net()
    net.set_divergence_sentinel(DivergenceSentinel(policy="raise", lag=0))
    net.fit_batch(_sbatches(1)[0])
    with pytest.raises(DivergenceError, match="step 2"):
        net.fit_batch(_poisoned(_sbatches(1)[0]))
    assert np.isfinite(net.params_flat()).all()  # guard kept old params


def test_sentinel_rollback_outside_ft_trainer_raises():
    net = _net()
    net.set_divergence_sentinel(
        DivergenceSentinel(policy="rollback", lag=0))
    with pytest.raises(RollbackRequested):
        net.fit_batch(_poisoned(_sbatches(1)[0]))


def test_sentinel_no_extra_sync_on_clean_steps():
    """The guarded step with lag=1 is not grossly slower than the plain
    one on clean batches (a few reductions and a copy of the written
    tensors; each flag is read a step late)."""
    batches = _sbatches(12, b=16)

    def run(with_sentinel):
        net = _net()
        if with_sentinel:
            net.set_divergence_sentinel(
                DivergenceSentinel(policy="skip_batch", lag=1))
        net.fit_batch(batches[0])
        float(net.score_value)
        t0 = time.perf_counter()
        for b in batches[1:]:
            net.fit_batch(b)
        float(net.score_value)
        return time.perf_counter() - t0

    plain = min(run(False) for _ in range(2))
    guarded = min(run(True) for _ in range(2))
    assert guarded < plain * 5 + 0.05, (plain, guarded)


def test_scan_fit_falls_back_to_per_batch_with_sentinel():
    net = _net()
    net.set_divergence_sentinel(
        DivergenceSentinel(policy="skip_batch", lag=0))
    batches = _sbatches(3)
    losses = net.fit_batches_scan([batches[0], _poisoned(batches[1]),
                                   batches[2]])
    assert net.iteration_count == 3
    assert net._sentinel.skipped_batches == 1  # flag observed, not dropped
    assert np.isfinite(net.params_flat()).all()
    assert len(np.asarray(losses)) == 3


def _tbptt_net(**kw):
    b = (NeuralNetConfiguration.builder().seed(11)
         .updater("adam").learning_rate(0.05).list()
         .layer(LSTM(n_out=6, activation="tanh"))
         .layer(RnnOutputLayer(n_out=3, activation="softmax",
                               loss="mcxent")))
    b.backprop_type("truncated_bptt", 3, 3)
    conf = b.set_input_type(InputType.recurrent(4, 6)).build()
    for k, v in kw.items():
        setattr(conf.training, k, v)
    return MultiLayerNetwork(conf, device="cpu").init()


def test_sentinel_tbptt_skip_guards_carries():
    """A NaN in the second window: that window neither updates the
    params nor poisons the carries, and a clean batch still trains."""
    net = _tbptt_net()
    net.set_divergence_sentinel(
        DivergenceSentinel(policy="skip_batch", lag=0))
    x = RNG.normal(size=(3, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, (3, 6))]
    x_bad = x.copy()
    x_bad[0, 4, 0] = np.nan
    net.fit_batch(DataSet(x_bad, y))
    assert net._sentinel.skipped_batches == 1
    assert np.isfinite(net.params_flat()).all()
    net.fit_batch(DataSet(x, y))
    assert np.isfinite(net.params_flat()).all()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_bad_window_leaves_everything_bitwise(precision):
    """The guard against the in-place update: across a bad tBPTT window
    the params, the Adam moments, the device count and the layer states
    are bitwise what they were, and so are the carries the next window
    starts from (a NaN window then a clean one trains exactly as the
    clean window alone, from the same start)."""
    x = RNG.normal(size=(2, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, (2, 6))]
    x_bad = x.copy()
    x_bad[1, 1, 2] = np.nan          # window 1 of 2

    def guarded():
        net = _tbptt_net(precision=precision)
        net.set_divergence_sentinel(
            DivergenceSentinel(policy="skip_batch", lag=0))
        net.fit_batch(DataSet(x[:, :3], y[:, :3]))   # one clean window
        return net

    def written(net):
        return (tree_leaves(net.params)
                + [t for k, v in net.opt_state.items() if k != "count"
                   for t in tree_leaves(v)]
                + [net.opt_state["count"]] + tree_leaves(net.states))

    net = guarded()
    assert net.opt_state["count"].dtype == torch.int32
    before = [t.clone() for t in written(net)]
    net.fit_batch(DataSet(x_bad[:, :3], y[:, :3]))   # one bad window
    assert net._sentinel.skipped_batches == 1
    assert all(torch.equal(a, b) for a, b in zip(before, written(net)))
    # bad window 1, then clean window 2 from the carries window 1 kept
    # (zeros) == window 2 alone from zero carries
    col = CollectScoresIterationListener()
    net.add_listener(col)
    net.fit_batch(DataSet(x_bad, y))
    ref = guarded()
    ref_loss = float(ref.fit_batch(DataSet(x[:, 3:], y[:, 3:])))
    assert not np.isfinite(col.scores[0][1])
    assert col.scores[1][1] == ref_loss
    assert net._sentinel.skipped_batches == 2
    for a, b in zip(written(net), written(ref)):
        assert torch.equal(a, b)


def test_guarded_clean_steps_match_unguarded():
    """On clean batches a guarded net trains as an unguarded one, bit for
    bit on the CPU: its count, learning-rate schedule and Adam bias
    corrections are computed on the device as the unguarded step computes
    them on the host (the schedule in f64, the corrections' powers as
    ATen's f32 power rounds them)."""
    for lr_policy in ("none", "exponential", "step", "schedule"):
        nets = []
        for guarded in (False, True):
            conf = _mlp_conf(updater="adam", lr=0.05)
            u = conf.training.updater
            u.lr_policy = lr_policy
            u.lr_policy_decay_rate, u.lr_policy_steps = 0.5, 2.0
            u.lr_schedule = {2: 0.01, 4: 0.002}
            net = MultiLayerNetwork(conf, device="cpu").init()
            if guarded:
                net.set_divergence_sentinel(
                    DivergenceSentinel("raise", lag=1))
            nets.append(net)
        for ds in _batches(5):
            for net in nets:
                net.fit_batch(ds)
        for a, b in zip(tree_leaves(nets[0].params),
                        tree_leaves(nets[1].params)):
            assert torch.equal(a, b), lr_policy
        assert nets[1].opt_state["count"].dtype == torch.int32
        assert int(nets[1].opt_state["count"]) == 5
        nets[1].set_divergence_sentinel(None)
        assert nets[1].opt_state["count"] == 5


@pytest.mark.parametrize("policy", ["none", "exponential", "inverse", "poly",
                                    "sigmoid", "step", "schedule"])
def test_lr_schedule_on_a_device_count_matches_the_host(policy):
    u = UpdaterConfig(name="sgd", learning_rate=0.1, lr_policy=policy,
                      lr_policy_decay_rate=0.7, lr_policy_power=2.0,
                      lr_policy_steps=3.0, lr_schedule={2: 0.05, 5: 0.01})
    lr = make_lr_schedule(u)
    for step in range(8):
        host = lr(step)
        dev = lr(torch.tensor(step, dtype=torch.int32))
        assert float(dev) == pytest.approx(float(host), rel=1e-6), step


def test_guard_update_selects_old_tree():
    old = {"a": torch.ones(3)}
    new = {"a": torch.full((3,), 2.0)}
    grads = {"a": torch.tensor([1.0, float("inf"), 0.0])}
    sel, bad = guard_update(torch.tensor(1.0), grads, old, new)
    assert bool(bad) and torch.equal(sel["a"], old["a"])
    sel, bad = guard_update(torch.tensor(1.0), {"a": torch.ones(3)}, old,
                            new)
    assert not bool(bad) and torch.equal(sel["a"], new["a"])
    assert bool(nonfinite_flag(torch.tensor(float("nan")),
                               {"a": torch.ones(1)}))


# ---------------------------------------------------- scan windows

def test_scan_fit_matches_loop_mln():
    """Per-step losses and params bitwise the ``fit_batch`` loop: the
    window runs the same steps."""
    batches = _batches()
    loop_net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    loop_losses = [float(loop_net.fit_batch(d)) for d in batches]
    scan_net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    losses = scan_net.fit_batches_scan(batches)
    assert isinstance(losses, torch.Tensor)
    assert losses.tolist() == loop_losses
    for a, b in zip(tree_leaves(scan_net.params),
                    tree_leaves(loop_net.params)):
        assert torch.equal(a, b)
    assert scan_net.iteration_count == len(batches)


def _merge_graph():
    b = (NeuralNetConfiguration.builder().seed(2)
         .updater("sgd", learning_rate=0.05).weight_init("xavier")
         .graph_builder().add_inputs("in"))
    b.add_layer("a", DenseLayer(n_out=12, activation="relu"), "in")
    b.add_layer("b", DenseLayer(n_out=8, activation="tanh"), "in")
    b.add_vertex("m", MergeVertex(), "a", "b")
    b.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "m")
    return ComputationGraph(
        b.set_outputs("out")
        .set_input_types(InputType.feed_forward(6)).build(),
        device="cpu").init()


def test_scan_fit_matches_loop_graph():
    bs = _batches(4)
    loop = _merge_graph()
    loop_losses = [float(loop.fit_batch(d)) for d in bs]
    scan = _merge_graph()
    assert scan.fit_batches_scan(bs).tolist() == loop_losses
    for a, b in zip(tree_leaves(scan.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)


def test_scan_fit_resnet_graph_smoke():
    bs = []
    for _ in range(2):
        x = RNG.normal(size=(2, 32, 32, 3)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[RNG.integers(0, 10, 2)]
        bs.append(DataSet(x, y))
    net = ComputationGraph(resnet_tiny(updater="sgd", learning_rate=1e-3),
                           device="cpu").init()
    losses = np.asarray(net.fit_batches_scan(bs))
    assert losses.shape == (2,)
    assert np.isfinite(losses).all()


def test_scan_fit_masked_falls_back_to_loop():
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    b = _batches(1)[0]
    masked = DataSet(b.features, b.labels,
                     labels_mask=np.ones((8,), np.float32))
    losses = net.fit_batches_scan([masked, masked])
    assert isinstance(losses, np.ndarray) and losses.shape == (2,)
    assert np.isfinite(losses).all()
    assert net.iteration_count == 2


def test_scan_fit_listeners_and_score():
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    col = CollectScoresIterationListener(frequency=1)
    net.add_listener(col)
    losses = net.fit_batches_scan(_batches(4))
    assert [s for _, s in col.scores] == losses.tolist()
    assert [i for i, _ in col.scores] == [1, 2, 3, 4]
    assert float(net.score_value) == pytest.approx(float(losses[-1]))


def test_scan_fit_multidataset_graph():
    b = (NeuralNetConfiguration.builder().seed(2)
         .updater("sgd", learning_rate=0.05).weight_init("xavier")
         .graph_builder().add_inputs("x1", "x2"))
    b.add_layer("d1", DenseLayer(n_out=8, activation="relu"), "x1")
    b.add_layer("d2", DenseLayer(n_out=8, activation="relu"), "x2")
    b.add_vertex("m", MergeVertex(), "d1", "d2")
    b.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "m")
    net = ComputationGraph(
        b.set_outputs("out")
        .set_input_types(InputType.feed_forward(4),
                         InputType.feed_forward(5)).build(),
        device="cpu").init()
    mds = [MultiDataSet([RNG.normal(size=(6, 4)).astype(np.float32),
                         RNG.normal(size=(6, 5)).astype(np.float32)],
                        [np.eye(3, dtype=np.float32)[RNG.integers(0, 3, 6)]])
           for _ in range(3)]
    losses = np.asarray(net.fit_batches_scan(mds))
    assert losses.shape == (3,)
    assert np.isfinite(losses).all()


def test_fit_scan_window_high_level():
    """fit(it, scan_window=N): windows, a short tail, epoch hooks and
    counts; bitwise a per-batch fit."""
    batches = _batches(7)  # 7 = a window of 3, one of 3, a tail of 1

    class Epochs(TrainingListener):
        def __init__(self):
            self.events = []

        def on_epoch_start(self, model):
            self.events.append(("start", model.epoch_count))

        def on_epoch_end(self, model):
            self.events.append(("end", model.epoch_count))

    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    epochs = Epochs()
    net.set_listeners(epochs)
    net.fit(ListDataSetIterator(batches), epochs=2, scan_window=3)
    assert net.iteration_count == 14
    assert net.epoch_count == 2
    assert epochs.events == [("start", 0), ("end", 1), ("start", 1),
                             ("end", 2)]
    loop = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    loop.fit(ListDataSetIterator(batches), epochs=2, use_async=False)
    for a, b in zip(tree_leaves(net.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)
    before = float(net.score_value)
    net.fit(ListDataSetIterator(batches), epochs=4, scan_window=3)
    assert float(net.score_value) < before


def test_fit_scan_window_ragged_tail_batch():
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    batches = _batches(3) + [_batches(1, b=3)[0]]  # 8, 8, 8, 3 examples
    net.fit(ListDataSetIterator(batches), epochs=1, scan_window=2)
    assert net.iteration_count == 4


def test_performance_listener_amortizes_scan_window():
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    pl = PerformanceListener(frequency=1)
    net.set_listeners(pl)
    net.fit(ListDataSetIterator(_batches(8)), scan_window=4,
            use_async=False)
    assert len(pl.history) == 8
    sps = [h[1] for h in pl.history]
    assert all(np.isfinite(s) and s > 0 for s in sps), sps
    assert max(sps[:4]) / min(sps[:4]) < 1.001, sps
    assert net.last_scan_window is None


def test_performance_listener_frequency_not_inflated():
    class _Model:
        last_batch_size = 10
        last_scan_window = None

    pl = PerformanceListener(frequency=5)
    for it in range(1, 11):
        time.sleep(0.01)
        pl.iteration_done(_Model(), it, 0.0)
    assert len(pl.history) == 2
    for _, sps, bps in pl.history:
        assert 500 <= sps <= 1100, sps
        assert 50 <= bps <= 110, bps


# ---------------------------------------------------------- listeners

def test_listeners_on_both_containers(caplog):
    """Score logging, collected scores per step, a gradient-collecting
    listener's ``last_grads`` (kept only while one is attached), and a
    composed listener forwarding the epoch hooks."""
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    col = CollectScoresIterationListener()
    pg = ParamAndGradientIterationListener()
    epochs = []

    class Hook(TrainingListener):
        def on_epoch_end(self, model):
            epochs.append(model.epoch_count)

    net.set_listeners(ScoreIterationListener(2),
                      ComposableIterationListener(col, pg, Hook()))
    assert net._collect_grads
    with caplog.at_level(logging.INFO, "deeplearning4j_tpu_torch"):
        net.fit(ListDataSetIterator(_batches(4)), epochs=1)
    assert [i for i, _ in col.scores] == [1, 2, 3, 4]
    assert "Score at iteration 4" in caplog.text
    assert epochs == [1]
    assert net.last_grads is not None and np.isfinite(
        pg.history[-1]["grad_mean_mag"])
    net.set_listeners(col)
    net.fit_batch(_batches(1)[0])
    assert not net._collect_grads and net.last_grads is None
    graph = _merge_graph()
    gcol = CollectScoresIterationListener()
    graph.add_listener(gcol)
    graph.fit(ListDataSetIterator(_batches(3)), epochs=1)
    assert [i for i, _ in gcol.scores] == [1, 2, 3]


# ---------------------------------------------------- TrainingStats

def test_stats_unit_math():
    s = TrainingStats()
    s.record("step", 0.2)
    s.record("step", 0.4)
    s.record("shard", 0.1)
    e = s.export()
    st = e["phases"]["step"]
    assert st["count"] == 2
    assert abs(st["total_s"] - 0.6) < 1e-9
    assert abs(st["mean_s"] - 0.3) < 1e-9
    assert st["min_s"] == 0.2 and st["max_s"] == 0.4
    assert "shard" in e["phases"]
    assert s.total_phase_s() > 0
    assert "step" in s.summary()
    s.set_cost({"flops_per_step": 3e9, "peak_flops_per_chip": 1e10})
    assert s.export()["analytic_mfu"] == pytest.approx(1.0)


def test_stats_phase_contextmanager_and_timed_iter():
    s = TrainingStats()
    with s.phase("checkpoint"):
        time.sleep(0.01)
    assert s.phases["checkpoint"]["total_s"] >= 0.01
    assert list(s.timed_iter([1, 2, 3], phase="data_wait")) == [1, 2, 3]
    assert s.phases["data_wait"]["count"] == 3


def test_scan_fit_records_phases():
    """A training loop's phases over scan windows (the parallel
    trainer's own recording waits for ROADMAP A6): data_wait per batch,
    a step per window, the listener burst."""
    net = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    net.add_listener(CollectScoresIterationListener())
    s = TrainingStats()
    window = []
    for ds in s.timed_iter(ListDataSetIterator(_batches(4))):
        window.append(ds)
    with s.phase("step"):
        losses = net.fit_batches_scan(window)
    emitted = s.phases
    assert emitted["step"]["count"] == 1
    assert emitted["data_wait"]["count"] == 4
    assert len(losses) == 4


def test_timed_iter_attributes_slow_iterator_to_data_wait():
    class SlowIter:
        def __iter__(self):
            for i in range(3):
                time.sleep(0.02)
                yield i

    s = TrainingStats()
    consumed = []
    for item in s.timed_iter(SlowIter()):
        with s.phase("step"):
            consumed.append(item)
    assert consumed == [0, 1, 2]
    dw = s.phases["data_wait"]
    assert dw["count"] == 3
    assert dw["total_s"] >= 0.05
    assert dw["min_s"] >= 0.015
    e = s.export()
    assert e["phases"]["data_wait"]["total_s"] > \
        e["phases"]["step"]["total_s"] * 5


def test_timed_iter_fast_iterator_near_zero_wait():
    s = TrainingStats()
    list(s.timed_iter(range(50)))
    assert s.phases["data_wait"]["count"] == 50
    assert s.phases["data_wait"]["total_s"] < 0.05


# --------------------------------------------------------------- remat

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_remat_with_dropout_is_bitwise_no_remat_gpt(precision):
    """The GPT with dropout on every layer that takes it: remat on and
    off give bitwise equal gradients and losses over two steps (the
    recompute draws the forward's masks again), and the same net
    without dropout differs (the masks were drawn)."""
    def net(remat, dropout=0.9):
        conf = tgpt.gpt_tiny(vocab_size=16, seq_len=16, dropout=dropout,
                             precision=precision)
        conf.training.remat = remat
        return ComputationGraph(conf, device="cpu").init()

    ds = DataSet(*_gpt_arrays())
    on, off = net(True), net(False)
    for _ in range(2):
        g_on, l_on, _ = on.compute_gradient_and_score(ds)
        g_off, l_off, _ = off.compute_gradient_and_score(ds)
        assert torch.equal(l_on, l_off)
        for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
            assert torch.equal(a, b)
        assert torch.equal(on.fit_batch(ds), off.fit_batch(ds))
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    _, l_plain, _ = net(False, dropout=None).compute_gradient_and_score(ds)
    assert not torch.equal(l_plain, l_off)


def test_remat_with_dropout_is_bitwise_no_remat_char_rnn():
    """The char-RNN's tBPTT with input dropout: a recurrent layer's
    sequence pass under remat gives the same windows' losses and params
    bit for bit."""
    def net(remat):
        conf = char_rnn_lstm(12, hidden=16, layers=2, tbptt_length=4)
        for layer in conf.layers:
            layer.dropout = 0.8
        conf.training.remat = remat
        return MultiLayerNetwork(conf, device="cpu").init()

    ds = DataSet(*_char_arrays(8))
    on, off = net(True), net(False)
    for _ in range(2):
        assert torch.equal(on.fit_batch(ds), off.fit_batch(ds))
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    assert torch.equal(on._rng.get_state(), off._rng.get_state())
