"""The port's data-parallel trainers (``deeplearning4j_tpu_torch/
parallel/``) against the JAX package's, at world 2 on the CPU.

The port's side runs in one group of two gloo processes for the whole
module (``torch_parallel_worker.run_group``: jax-free ranks, weights
copied from the JAX nets with ``convert.params_from_jax``, dropout off);
the JAX side runs here, its ``ParallelTrainer`` / ``ParallelWrapper`` /
``DelayedSyncTrainer`` on ``MeshContext.create(n_data=2)`` in the
replicated mode over two of the eight virtual CPU devices (its zero tests
are ROADMAP C1). Held:

- ``ParallelTrainer`` on an MLP, ``gpt_tiny`` and a small char-RNN (one
  tBPTT window per batch, where the port's per-window step is the JAX
  whole-sequence step): losses at 1e-5, params after 3 steps at rtol
  2e-4 / atol 2e-5, gradient accumulation 4 to the same gate; both ranks
  hold the same params bit for bit;
- ``ParallelWrapper`` at workers=2 (one a rank) against the JAX
  wrapper and against hand-run workers averaged every k
  (``tests/test_parallel.py:83-185``): replicas diverge between averages
  and agree at them; workers=4 (two a rank) converge on Iris;
- a char-RNN over three tBPTT windows a batch (the port's per-window
  step, which the JAX package does not take): ``ParallelTrainer`` at
  accumulation 1 and 2 against the plain ``fit_batch`` of the whole
  global batch at the same gates;
- ``DelayedSyncTrainer``: k=1 bitwise ``ParallelTrainer`` (on the MLP and
  on the tBPTT windows), k=4 against gradient accumulation 4 and the JAX
  trainer; stale params between syncs, ``flush``;
- ``create_trainer`` over the registry, hooks and refusals; the
  ``TrainingStats`` phases (``tests/test_training_stats.py:64-92``); a
  NaN worker under the wrapper's sentinel (``tests/test_resilience.py:
  449``).

In this process (world 1, no group): the trainers against the plain
``fit_batch`` bit for bit, ``device=None`` raising without a card,
``multihost``'s helpers and refusals, and a teardown back to the thread
baseline with no process group left.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iris import IrisDataSetIterator
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import DelayedSyncTrainer as JDelayed
from deeplearning4j_tpu.parallel import MeshContext as JMesh
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 2e-4, 2e-5
GPT_KW = dict(vocab_size=16, seq_len=16)
RNN_KW = dict(vocab_size=12, hidden=16, layers=2)


# ---------------------------------------------------------------------------
# the JAX side's nets and the shared data
# ---------------------------------------------------------------------------

def jax_mlp(seed=12345, lr=0.05, updater="adam", hidden=16, n_in=4,
            n_out=3, clip=None, frozen=False, layer_lr=None):
    b = (JNNC.builder().seed(seed).updater(updater, learning_rate=lr)
         .weight_init("xavier"))
    if clip is not None:
        b = b.gradient_normalization(clip, threshold=0.5)
    first = JDense(n_out=hidden, activation="relu")
    if layer_lr is not None:
        first.learning_rate = layer_lr
    second = JDense(n_out=hidden, activation="tanh")
    if frozen:
        second.frozen = True
    return JNet(b.list().layer(first).layer(second)
                .layer(JOutput(n_out=n_out, activation="softmax"))
                .set_input_type(JInputType.feed_forward(n_in)).build()
                ).init()


def jax_net(kind, **kw):
    if kind == "mlp":
        return jax_mlp(**kw)
    if kind == "gpt":
        return JGraph(jgpt.gpt_tiny(**kw)).init()
    return JNet(jchar_rnn(**kw)).init()


def numpy_params(jnet):
    return jax.tree.map(np.asarray, jnet.params)


def mlp_batches(n, rows=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]
        arrays = [x, y]
        if masked:
            arrays += [None, (rng.random(rows) > 0.3).astype(np.float32)]
        out.append(arrays)
    return out


def seq_batches(n, V, T, rows, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        tok = rng.integers(0, V, (rows, T + 1))
        out.append([eye[tok[:, :-1]], eye[tok[:, 1:]]])
    return out


def iris_batches(batch, n):
    return [[np.asarray(b.features), np.asarray(b.labels)]
            for b in IrisDataSetIterator(batch_size=batch, num_examples=n)]


#: the parity cases: kind, net kwargs, batches, gradient accumulation
PARITY = {
    "mlp": ("mlp", {}, mlp_batches(1), 1),
    "mlp_accum4": ("mlp", {}, mlp_batches(1), 4),
    "gpt": ("gpt", GPT_KW, seq_batches(1, 16, 16, 4, seed=1), 1),
    "gpt_accum4": ("gpt", GPT_KW, seq_batches(1, 16, 16, 8, seed=2), 4),
    "char_rnn": ("char_rnn", RNN_KW, seq_batches(1, 12, 12, 4, seed=3), 1),
    "char_rnn_accum4": ("char_rnn", RNN_KW,
                        seq_batches(1, 12, 12, 8, seed=4), 4),
}
WRAP_BATCHES = iris_batches(12, 72)
DELAY_BATCHES = mlp_batches(4, rows=8, seed=5)
#: a char-RNN whose 12 steps train in three tBPTT windows (5, 5, 2)
TBPTT_KW = dict(RNN_KW, tbptt_length=5)
TBPTT_BATCHES = seq_batches(1, 12, 12, 8, seed=8)


def _cases():
    cases = []
    for name, (kind, kw, batches, accum) in PARITY.items():
        cases.append(dict(name=name, fn="trainer", args=dict(
            kind=kind, net_kw=kw, params=numpy_params(jax_net(kind, **kw)),
            batches=batches, steps=3, accum=accum)))
    mlp = numpy_params(jax_mlp())
    cases += [
        dict(name="wrap", fn="wrapper_semantics",
             args=dict(params=mlp, batches=WRAP_BATCHES, k=3)),
        dict(name="wrap_converges", fn="wrapper_converges",
             args=dict(params=mlp, batches=iris_batches(12, 144),
                       test_batch=iris_batches(144, 144)[0])),
        dict(name="wrap_sentinel", fn="wrapper_sentinel",
             args=dict(batches=mlp_batches(2, rows=4, seed=6))),
        dict(name="delayed", fn="delayed",
             args=dict(params=mlp, batches=DELAY_BATCHES)),
        dict(name="tbptt", fn="tbptt",
             args=dict(net_kw=TBPTT_KW, batches=TBPTT_BATCHES)),
        dict(name="strategies", fn="strategies",
             args=dict(batches=mlp_batches(1, rows=8))),
        dict(name="stats", fn="stats",
             args=dict(batches=mlp_batches(6, rows=8, seed=7))),
    ]
    return cases


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return W.run_group(_cases(), tmp_path_factory.mktemp("parallel"))


# ---------------------------------------------------------------------------
# ParallelTrainer against the JAX package's
# ---------------------------------------------------------------------------

def _jax_trainer_run(kind, kw, batches, accum, steps=3):
    jnet = jax_net(kind, **kw)
    tr = JTrainer(jnet, JMesh.create(n_data=2), gradient_accumulation=accum)
    losses = [float(tr.fit_batch(JDataSet(*b))) for _ in range(steps)
              for b in batches]
    return losses, np.asarray(jnet.params_flat())


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parallel_trainer_matches_jax_at_world_2(group, name):
    kind, kw, batches, accum = PARITY[name]
    want_losses, want_params = _jax_trainer_run(kind, kw, batches, accum)
    got = W.result(group, name)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["params"], want_params, rtol=P_RTOL,
                               atol=P_ATOL)
    other = W.result(group, name, rank=1)
    assert other["params"].tobytes() == got["params"].tobytes()
    assert other["loss_bytes"] == got["loss_bytes"]
    assert got["iterations"] == 3


# ---------------------------------------------------------------------------
# ParallelWrapper
# ---------------------------------------------------------------------------

def test_wrapper_replicas_diverge_between_averages_and_agree_at_them(group):
    r0, r1 = (W.result(group, "wrap", rank) for rank in (0, 1))
    assert not np.allclose(r0["between"], r1["between"])
    assert r0["at"].tobytes() == r1["at"].tobytes()
    assert r0["iterations"] == 3


def test_wrapper_average_equals_the_manual_mean_and_the_jax_wrapper(group):
    """The averaged params equal the hand-run mean of the two workers'
    k-step trajectories (each worker takes every other batch), and the
    JAX wrapper's on the same schedule."""
    k = 3
    batches = [JDataSet(*b) for b in WRAP_BATCHES]
    manual = [jax_mlp() for _ in range(2)]
    for step in range(k):
        for w, m in enumerate(manual):
            m.fit_batch(batches[2 * step + w])
    avg = (np.asarray(manual[0].params_flat())
           + np.asarray(manual[1].params_flat())) / 2
    got = W.result(group, "wrap")["net"]
    np.testing.assert_allclose(got, avg, rtol=P_RTOL, atol=P_ATOL)
    jnet = jax_mlp()
    jw = JWrapper(jnet, workers=2, averaging_frequency=k,
                  mesh=JMesh.create(n_data=2))
    jw._ensure_vstep()
    for step in range(k):
        jw._parallel_iteration([batches[2 * step], batches[2 * step + 1]])
    jw._sync_to_net()
    np.testing.assert_allclose(got, np.asarray(jnet.params_flat()),
                               rtol=P_RTOL, atol=P_ATOL)
    assert W.result(group, "wrap")["score"] == pytest.approx(
        jnet.score_value, rel=1e-5)


def test_wrapper_param_averaging_converges_on_iris(group):
    got = W.result(group, "wrap_converges")
    assert got["s1"] < got["s0"] * 0.7
    assert got["accuracy"] > 0.7


def test_wrapper_replicas_equal_after_every_average(group):
    r0, r1 = (W.result(group, "wrap_converges", rank) for rank in (0, 1))
    assert r0["local_equal"] and r1["local_equal"]
    assert r0["replica0"].tobytes() == r1["replica0"].tobytes()


def test_wrapper_sentinel_skips_a_nan_worker_on_every_rank(group):
    for rank in (0, 1):
        got = W.result(group, "wrap_sentinel", rank)
        assert got["skipped"] == 1 and got["finite"]


# ---------------------------------------------------------------------------
# DelayedSyncTrainer
# ---------------------------------------------------------------------------

def test_delayed_sync_k1_equals_the_parallel_trainer_bitwise(group):
    got = W.result(group, "delayed")["k1"]
    assert got["bitwise"]
    assert got["losses"][0] == got["losses"][1]


@pytest.mark.parametrize("accum", [1, 2])
def test_tbptt_windows_at_world_2_match_the_plain_step_on_the_global_batch(
        group, accum):
    """The port steps each tBPTT window (the JAX trainer the whole
    sequence): at world 2, one update a window, each rank's rows carrying
    their state, is the plain ``fit_batch`` of the whole global batch in
    one process, three windows a batch, two batches."""
    for rank in (0, 1):
        got = W.result(group, "tbptt", rank)
        mine = got[f"accum{accum}"]
        np.testing.assert_allclose(mine["losses"], got["plain_losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(mine["params"], got["plain"],
                                   rtol=P_RTOL, atol=P_ATOL)
        assert mine["iterations"] == got["plain_iterations"] == 6


def test_delayed_sync_k1_equals_the_parallel_trainer_on_tbptt_windows(
        group):
    for rank in (0, 1):
        got = W.result(group, "tbptt", rank)
        assert got["delayed"]["loss_bytes"] == got["accum1"]["loss_bytes"]
        assert got["delayed"]["params"].tobytes() == \
            got["accum1"]["params"].tobytes()
        assert got["delayed"]["iterations"] == 6


def test_delayed_sync_k4_equals_gradient_accumulation_4(group):
    """k=4 delayed sync applies the update accumulation 4 takes over the
    merged batches, and the JAX delayed-sync trainer's."""
    accum, delayed = W.result(group, "delayed")["k4"]
    np.testing.assert_allclose(delayed, accum, rtol=P_RTOL, atol=P_ATOL)
    jnet = jax_mlp()
    jd = JDelayed(jnet, JMesh.create(n_data=2), sync_frequency=4)
    for _ in range(3):
        for b in DELAY_BATCHES:
            jd.fit_batch(JDataSet(*b))
    np.testing.assert_allclose(delayed, np.asarray(jnet.params_flat()),
                               rtol=P_RTOL, atol=P_ATOL)


def test_delayed_sync_defers_updates_and_flush_applies_them(group):
    got = W.result(group, "delayed")
    assert got["stale"] and got["moved"]
    assert got["before_flush"] and got["flushed"]


# ---------------------------------------------------------------------------
# strategies, refusals, stats
# ---------------------------------------------------------------------------

def test_local_batch_slice_is_the_ranks_rows_at_world_2(group):
    for rank in (0, 1):
        got = W.result(group, "strategies", rank)
        assert got["local_slice"] == (4 * rank, 4 * rank + 4)
        assert got["process"] == (2, rank)


def test_create_trainer_builds_each_strategy_and_runs_hooks(group):
    got = W.result(group, "strategies")
    assert got["types"] == {"allreduce": "ParallelTrainer",
                            "param_averaging": "ParallelWrapper",
                            "delayed_sync": "DelayedSyncTrainer"}
    assert got["calls"] == ["pre", "post"]


@pytest.mark.parametrize("label,kind,words", [
    ("pipeline", "NotImplementedError", "A6.2"),
    ("unknown", "ValueError", "Unknown training strategy"),
    ("workers", "ValueError", "3 workers"),
    ("zero_workers", "ValueError", "3 workers"),
    ("tuned", "NotImplementedError", "A7.4"),
    ("n_model", "NotImplementedError", "A6.2"),
    ("n_data", "ValueError", "world 2"),
    ("rows", "ValueError", "not divisible"),
    ("local_slice", "ValueError", "not divisible by process count 2"),
])
def test_refusals_at_world_2(group, label, kind, words):
    err = W.result(group, "strategies")["errors"][label]
    assert err is not None and err[0] == kind and words in err[1], err


def test_parallel_trainer_phases_sum_to_wall(group):
    got = W.result(group, "stats")
    e = got["export"]
    for phase in ("data_wait", "shard", "step", "listener"):
        assert phase in e["phases"], e["phases"].keys()
    assert e["phases"]["step"]["count"] == 12
    assert e["phases"]["data_wait"]["count"] == 12
    assert got["total"] <= got["wall"] * 1.01
    assert e["covered_fraction"] > 0.5
    assert got["off_is_none"]


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

def _port_mlp(**kw):
    return W.build("mlp", **kw)


def _ds(arrays):
    return W.datasets([arrays])[0]


@pytest.mark.parametrize("kind", ["mlp", "gpt", "char_rnn"])
def test_world_1_trainer_is_the_plain_step_bitwise(kind):
    """No group: world 1, no collective; the trainer's steps are the
    net's own ``fit_batch`` bit for bit (the char-RNN's over three tBPTT
    windows)."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    kw = {"mlp": {}, "gpt": GPT_KW,
          "char_rnn": dict(RNN_KW, tbptt_length=5)}[kind]
    arrays = {"mlp": mlp_batches(1)[0],
              "gpt": seq_batches(1, 16, 16, 4)[0],
              "char_rnn": seq_batches(1, 12, 12, 4)[0]}[kind]
    a, b = W.build(kind, **kw), W.build(kind, **kw)
    tr = ParallelTrainer(b, device="cpu")
    for _ in range(2):
        la, lb = a.fit_batch(_ds(arrays)), tr.fit_batch(_ds(arrays))
        assert float(la) == float(lb)
    assert a.params_flat().tobytes() == b.params_flat().tobytes()
    assert a.iteration_count == b.iteration_count


def test_world_1_accumulation_4_holds_the_plain_step_gate():
    """``tests/test_parallel.py:58-80``: SGD, 4 microbatches accumulated
    against one step on the whole batch."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    a = _port_mlp(updater="sgd", lr=0.1)
    b = _port_mlp(updater="sgd", lr=0.1)
    arrays = mlp_batches(1)[0]
    a.fit_batch(_ds(arrays))
    ParallelTrainer(b, device="cpu", gradient_accumulation=4).fit_batch(
        _ds(arrays))
    np.testing.assert_allclose(a.params_flat(), b.params_flat(),
                               rtol=P_RTOL, atol=P_ATOL)


@pytest.mark.parametrize("kind", ["mlp", "char_rnn"])
def test_accumulation_holds_one_gradient_tree_at_a_time(kind):
    """Each microbatch's gradient is reduced into the accumulator and
    dropped before the next microbatch's backward (the char-RNN's in each
    of its three tBPTT windows): none is alive when the next is taken."""
    import weakref

    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    kw = {"mlp": {}, "char_rnn": TBPTT_KW}[kind]
    arrays = {"mlp": mlp_batches(1)[0],
              "char_rnn": TBPTT_BATCHES[0]}[kind]
    tr = ParallelTrainer(W.build(kind, **kw), device="cpu",
                         gradient_accumulation=4)
    take, refs, alive = tr._value_and_grad, [], []

    def spy(loss_fn):
        alive.append(sum(r() is not None for r in refs))
        out = take(loss_fn)
        refs.extend(weakref.ref(t) for t in tree_leaves(out[2]))
        return out
    tr._value_and_grad = spy
    tr.fit_batch(_ds(arrays))
    assert len(alive) == {"mlp": 4, "char_rnn": 12}[kind]
    assert alive == [0] * len(alive)


def test_world_1_fit_batches_scan_is_the_fit_batch_loop():
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    a, b = _port_mlp(), _port_mlp()
    ta, tb = ParallelTrainer(a, device="cpu"), ParallelTrainer(b,
                                                               device="cpu")
    ds = W.datasets(mlp_batches(4))
    la = [float(ta.fit_batch(d)) for d in ds]
    lb = [float(x) for x in tb.fit_batches_scan(ds)]
    assert la == lb and b.iteration_count == 4
    assert a.params_flat().tobytes() == b.params_flat().tobytes()


@pytest.mark.parametrize("strategy", ["allreduce", "param_averaging",
                                      "delayed_sync"])
def test_create_trainer_runs_on_the_card_unless_asked_for_the_cpu(strategy):
    """``device=None`` (the default) is the card: without one it raises;
    ``device="cpu"`` trains here."""
    from deeplearning4j_tpu_torch.parallel.strategy import create_trainer
    net = _port_mlp()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_trainer(strategy, net)
    trainer = create_trainer(strategy, net, device="cpu")
    trainer.fit_batch(_ds(mlp_batches(1, rows=8)[0]))
    assert net.iteration_count == 1


def test_a_cpu_net_under_a_card_mesh_is_refused():
    from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
    mesh = MeshContext.create(device="cpu")
    mesh.device = torch.device("cuda")
    with pytest.raises(ValueError, match="one device"):
        ParallelTrainer(_port_mlp(), mesh)


def test_multihost_helpers_and_refusals():
    from deeplearning4j_tpu_torch.parallel import multihost
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.runtime_fault_count() == 0
    assert multihost.local_batch_slice(8) == slice(0, 8)
    assert multihost.local_batch_slice(7) == slice(0, 7)
    assert multihost.effective_process_count() == 1
    assert multihost.effective_process_index() == 0
    assert not hasattr(multihost, "set_topology_override")   # A6.3
    with pytest.raises(NotImplementedError, match="A6.3"):
        multihost.initialize("file:///nowhere", 1, 0, device="cpu",
                             elastic=True)
    with pytest.raises(NotImplementedError, match="A6.3"):
        multihost.serve_coordination(1, 2)
    for fn in (multihost.shard_sources, multihost.input_pipeline):
        with pytest.raises(NotImplementedError, match="A7.6"):
            fn([])
    tr = multihost.data_parallel_trainer(_port_mlp(),
                                         gradient_accumulation=2)
    assert tr.mesh.n_data == 1 and tr.gradient_accumulation == 2
    from deeplearning4j_tpu_torch.resilience import ElasticTrainer
    with pytest.raises(NotImplementedError, match="A6.3"):
        ElasticTrainer()


def test_teardown_leaves_no_group_and_no_thread(tmp_path):
    """A world-1 gloo group through ``multihost.initialize``: the trainer
    reduces through it (an identity), and ``shutdown`` leaves no process
    group and the threads at their baseline."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer, multihost,
    )
    baseline = {t.ident for t in threading.enumerate()}
    a, b = _port_mlp(), _port_mlp()
    assert multihost.initialize(f"file://{tmp_path}/rdv", 1, 0,
                                device="cpu") == "gloo"
    try:
        mesh = MeshContext.create(device="cpu")
        assert mesh.distributed and mesh.backend == "gloo"
        tr = ParallelTrainer(b, mesh)
        for _ in range(2):
            a.fit_batch(_ds(mlp_batches(1)[0]))
            tr.fit_batch(_ds(mlp_batches(1)[0]))
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()
    assert a.params_flat().tobytes() == b.params_flat().tobytes()
    deadline = time.monotonic() + 5
    while ({t.ident for t in threading.enumerate()} - baseline
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not {t.ident for t in threading.enumerate()} - baseline
