"""The rank side of the port's data-parallel tests: a group of gloo
processes on the CPU, each importing torch and the port, never JAX.

``run_group(cases, tmp)`` pickles the cases (a name, the name of a case
function here and its keyword arguments: configs, numpy weights copied
from a JAX net, numpy batches), starts ``world`` processes of this file
joined through a ``file://`` rendezvous under ``tmp``, and returns each
rank's results: ``{case name: value}``, a case that raised carrying its
traceback (``result`` raises it as ``RankError``). One group serves a
whole test module; each test reads its case's results.

The tensor- and sequence-parallel cases (``case_mesh_*``, ``case_ring``,
``case_scope_routing``) run at world 4, each on a mesh of the layout
they are given (``mesh_for``: over all four ranks, or over each part of
the world cut to the layout's size).

Run alone: ``python tests/torch_parallel_worker.py <spec> <rank>
<world> <init_method> <out>``.

``run_elastic(spec, tmp, world)`` starts ``world`` ranks of an
``ElasticTrainer`` run instead (``python tests/torch_parallel_worker.py
elastic <spec.json> <rank> <world> <init_method> <out_dir>``): each joins
an elastic group, arms the spec's host fault on its victim rank, trains
the elastic MLP and writes ``elastic_r<rank>.json`` (its trajectory,
world, counters, a restart request) and ``params_r<rank>.npy``. A rank a
``kill_host`` fault ends writes nothing and exits with
``KILL_HOST_EXIT_CODE``.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


class RankError(RuntimeError):
    """A case raised on a rank; the message is its traceback."""


#: the key a case's result carries its rank's traceback under
ERROR = "__rank_error__"


def run_group(cases, tmp, world: int = 2, timeout: float = 300.0):
    """Run ``cases`` on ``world`` ranks; returns a list (by rank) of
    ``{name: result}``."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec = tmp / "spec.pkl"
    spec.write_bytes(pickle.dumps({"cases": cases}))
    init = "file://" + str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(spec), str(r), str(world), init,
         str(tmp / f"rank{r}.pkl")], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, p in enumerate(procs):
        path = tmp / f"rank{r}.pkl"
        if p.returncode != 0 or not path.exists():
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{logs[r][-4000:]}")
        out.append(pickle.loads(path.read_bytes()))
    return out


def _reap(procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def spawn_coordination(port: int, world: int, timeout: float = 60.0):
    """``multihost.serve_coordination`` in a process of its own; returns
    it once it printed READY (killed and raised if it does not)."""
    import time
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.multihost",
         "serve", str(port), str(world)], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    try:
        line = b""
        while time.monotonic() < deadline and proc.poll() is None:
            line = proc.stdout.readline()
            if line.startswith(b"READY"):
                return proc
        raise RuntimeError(f"the coordination store never got ready "
                           f"(rc={proc.poll()}): {line!r}")
    except BaseException:
        _reap([proc])
        raise


def run_elastic(spec: dict, tmp, world: int, timeout: float = 180.0,
                init_method: str = None):
    """Run ``world`` ranks of the elastic case ``spec`` (see
    ``elastic_rank``); returns (return codes, {rank: record}). A rank a
    ``freeze`` fault stops is not waited for: it is killed once the
    others ended. Every process is reaped on every path."""
    import json
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = tmp / f"elastic_spec_{spec.get('tag', 'run')}.json"
    spec_path.write_text(json.dumps(spec))
    init = init_method or "file://" + str(
        tmp / f"rdv_{spec.get('tag', 'run')}")
    out = tmp / f"out_{spec.get('tag', 'run')}"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "elastic", str(spec_path),
                 str(r), str(world), init, str(out)], cwd=str(ROOT),
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        fault = spec.get("fault") or {}
        frozen = fault.get("victim") if fault.get("kind") == "freeze" \
            else None
        logs = [None if r == frozen else
                p.communicate(timeout=timeout)[0].decode(errors="replace")
                for r, p in enumerate(procs)]
    finally:
        _reap(procs)
    logs = [log if log is not None
            else p.communicate()[0].decode(errors="replace")
            for log, p in zip(logs, procs)]
    records = {}
    for r in range(world):
        path = out / f"elastic_r{r}.json"
        if path.exists():
            records[r] = json.loads(path.read_text())
            records[r]["params"] = np.load(out / f"params_r{r}.npy")
        records.setdefault(r, {})["log"] = logs[r][-4000:]
    return [p.returncode for p in procs], records


def result(results, name: str, rank: int = 0):
    """One case's value on one rank (raises its ``RankError``)."""
    value = results[rank][name]
    if isinstance(value, dict) and ERROR in value:
        raise RankError(f"{name} on rank {rank}:\n{value[ERROR]}")
    return value


# ---------------------------------------------------------------------------
# nets and data (the port's side of the tests' JAX builders)
# ---------------------------------------------------------------------------

def mlp_conf(seed=12345, lr=0.05, updater="adam", hidden=16, n_in=4,
             n_out=3, clip=None, frozen=False, layer_lr=None, dropout=None):
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.core import (
        DenseLayer, OutputLayer,
    )
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).weight_init("xavier"))
    if dropout is not None:
        b = b.dropout(dropout)
    if clip is not None:
        b = b.gradient_normalization(clip, threshold=0.5)
    first = DenseLayer(n_out=hidden, activation="relu")
    if layer_lr is not None:
        first.learning_rate = layer_lr
    second = DenseLayer(n_out=hidden, activation="tanh")
    if frozen:
        second.frozen = True
    return (b.list().layer(first).layer(second)
            .layer(OutputLayer(n_out=n_out, activation="softmax"))
            .set_input_type(InputType.feed_forward(n_in)).build())


def lenet_bn_conf(seed=12345, lr=0.01):
    """LeNet-5's stack at 16 x 16 x 1, narrowed, with batch norm after the
    first convolution."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.core import (
        DenseLayer, OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.normalization import (
        BatchNormalization,
    )
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater("adam", learning_rate=lr).weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=6, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(BatchNormalization())
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=16, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(16, 16, 1)).build())


def attn_conf(seed=5, causal=False, T=16, F=8, K=5, lr=0.05):
    """``tests/test_attention_sequence.py``'s container: self attention
    (2 heads, blocks of 4) and a per-timestep softmax head, SGD."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater("sgd", learning_rate=lr).weight_init("xavier").list()
            .layer(SelfAttentionLayer(n_heads=2, causal=causal,
                                      block_size=4))
            .layer(RnnOutputLayer(n_out=K, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(F, T)).build())


def build(kind: str, params=None, **kw):
    """A port net on the CPU: ``kind`` "mlp", "lenet_bn"
    (``lenet_bn_conf``), "gpt" (``gpt_tiny``) or "char_rnn"
    (``char_rnn_lstm``), with ``params`` (numpy, the JAX net's layout)
    carried in when given."""
    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if kind == "mlp":
        conf, cls = mlp_conf(**kw), MultiLayerNetwork
    elif kind == "lenet_bn":
        conf, cls = lenet_bn_conf(**kw), MultiLayerNetwork
    elif kind == "gpt":
        from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
        conf, cls = gpt_tiny(**kw), ComputationGraph
    elif kind == "char_rnn":
        from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
        conf, cls = char_rnn_lstm(**kw), MultiLayerNetwork
    elif kind == "attn":
        conf, cls = attn_conf(**kw), MultiLayerNetwork
    else:
        raise ValueError(kind)
    net = cls(conf, device="cpu")
    return net.init(None if params is None
                    else params_from_jax(conf, params))


def datasets(arrays):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(*a) for a in arrays]


def flat(net) -> np.ndarray:
    return net.params_flat()


def f32_bytes(losses) -> list:
    return [np.float32(float(x)).tobytes() for x in losses]


def _rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# cases: ParallelTrainer / ParallelWrapper / DelayedSyncTrainer / strategy
# ---------------------------------------------------------------------------

def case_trainer(kind, net_kw, params, batches, steps=3, accum=1,
                 mode="off", precision=None, sentinel=None):
    """``steps`` passes over ``batches`` through ``ParallelTrainer``:
    each step's loss, the params after, the updater-state leaf shapes."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    net = build(kind, params, **net_kw)
    if sentinel is not None:
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            DivergenceSentinel,
        )
        net.set_divergence_sentinel(DivergenceSentinel(sentinel, lag=0))
    tr = ParallelTrainer(net, MeshContext.create(device="cpu"),
                         gradient_accumulation=accum,
                         weight_update_sharding=mode, precision=precision)
    losses = [tr.fit_batch(b) for _ in range(steps)
              for b in datasets(batches)]
    shapes = sorted(tuple(t.shape) for k, v in net.opt_state.items()
                    if k != "count" for t in _leaves(v))
    out = dict(losses=[float(x) for x in losses],
               loss_bytes=f32_bytes(losses), params=flat(net),
               opt_shapes=shapes, iterations=net.iteration_count,
               states=[t.numpy().copy() for t in _leaves(net.states)])
    if sentinel is not None:
        net._sentinel.flush()
        out["skipped"] = net._sentinel.skipped_batches
    return out


def _leaves(tree):
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    return tree_leaves(tree)


class MaskSpy:
    """Records the keep mask of every dropout a layer draws on its input
    (the elements a dropout zeroed), while installed."""

    def __init__(self):
        from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerConf
        self.cls, self.masks = BaseLayerConf, []
        self.orig = BaseLayerConf._dropout_input

    def __enter__(self):
        spy = self

        def record(layer, x, train, rng):
            y = spy.orig(layer, x, train, rng)
            if train and y is not x:
                spy.masks.append(((y != 0) | (x == 0)).numpy().copy())
            return y
        self.cls._dropout_input = record
        return self

    def __exit__(self, *exc):
        self.cls._dropout_input = self.orig
        return False


def case_dropout_streams(batches, steps=2):
    """Dropout 0.5 on the MLP, every rank fed the same rows: the masks
    ParallelTrainer, DelayedSyncTrainer and ParallelWrapper (workers=4,
    two a rank) draw, by step (and by worker)."""
    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, MeshContext, ParallelTrainer, ParallelWrapper,
    )
    ds = datasets(batches)
    out = {}
    for name, make in (
            ("trainer", lambda n: ParallelTrainer(
                n, MeshContext.create(device="cpu"))),
            ("delayed", lambda n: DelayedSyncTrainer(
                n, MeshContext.create(device="cpu"), sync_frequency=1))):
        tr = make(build("mlp", dropout=0.5))
        with MaskSpy() as spy:
            for _ in range(steps):
                for b in ds:
                    tr.fit_batch(b)
        out[name] = spy.masks
    pw = ParallelWrapper(build("mlp", dropout=0.5), workers=4,
                         mesh=MeshContext.create(device="cpu"))
    with MaskSpy() as spy:
        for _ in range(steps):
            for b in ds:
                pw.fit_batch(b)
    # each iteration: this rank's two workers in turn, three layers each
    out["wrapper"] = spy.masks
    return out


def case_dropout_resume(ckpt_root, batches, steps=4, cut=2):
    """Dropout 0.5 under ParallelTrainer: ``steps`` steps straight, and a
    run saved after ``cut`` steps and resumed by a net of another seed;
    the cursor's per-rank stream seeds."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    ds = datasets(batches)
    mesh = MeshContext.create(device="cpu")
    whole = build("mlp", dropout=0.5)
    tw = ParallelTrainer(whole, mesh)
    want = [float(tw.fit_batch(ds[i % len(ds)])) for i in range(steps)]
    first = build("mlp", dropout=0.5)
    tf = ParallelTrainer(first, mesh)
    for i in range(cut):
        tf.fit_batch(ds[i % len(ds)])
    mgr = CheckpointManager(ckpt_root, sharded=True, mesh_ctx=mesh)
    mgr.save(first)
    import torch.distributed as dist
    dist.barrier()   # rank 0's COMMIT lands before any rank restores
    resumed = build("mlp", dropout=0.5, seed=777)
    tr = ParallelTrainer(resumed, mesh)
    cursor = mgr.restore(resumed)
    got = [float(tr.fit_batch(ds[i % len(ds)])) for i in range(cut, steps)]
    return dict(want=want[cut:], got=got, whole=flat(whole),
                resumed=flat(resumed),
                seeds=cursor.extra.get("torch_rng_ranks"),
                net_stream=cursor.extra.get("torch_rng") ==
                first._rng.get_state().tolist())


def case_gather_roundtrip(net_kw, batches, mode="zero1"):
    """gather_opt_state restores whole moments; the next fit shards again
    and stays bitwise on the replicated twin's trajectory."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    ds = datasets(batches)[0]
    a, b = build("mlp", **net_kw), build("mlp", **net_kw)
    ta = ParallelTrainer(a, MeshContext.create(device="cpu"))
    tb = ParallelTrainer(b, MeshContext.create(device="cpu"),
                         weight_update_sharding=mode)
    for _ in range(2):
        ta.fit_batch(ds)
        tb.fit_batch(ds)
    opt = tb.gather_opt_state()
    gathered = sorted(tuple(t.shape) for k, v in opt.items()
                      if k != "count" for t in _leaves(v))
    whole_equal = all(
        (x == y).all().item() for x, y in zip(
            _leaves({k: v for k, v in opt.items() if k != "count"}),
            _leaves({k: v for k, v in a.opt_state.items()
                     if k != "count"})))
    ta.fit_batch(ds)
    tb.fit_batch(ds)
    return dict(gathered=gathered,
                params=sorted(tuple(t.shape) for t in _leaves(b.params)),
                whole_equal=whole_equal,
                bitwise=flat(a).tobytes() == flat(b).tobytes())


def case_zero_memory(net_kw):
    """Updater-state bytes this rank holds, replicated and sharded."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    net = build("mlp", **net_kw)
    full = sum(t.numel() * t.element_size() for k, v in
               net.opt_state.items() if k != "count" for t in _leaves(v))
    ParallelTrainer(net, MeshContext.create(device="cpu"),
                    weight_update_sharding="zero1")
    rows = sum(t.numel() * t.element_size() for k, v in
               net.opt_state.items() if k != "count" for t in _leaves(v))
    return dict(full=full, rows=rows)


def case_wrapper_semantics(params, batches, k=3, net_kw=None):
    """ParallelWrapper(workers=2, averaging_frequency=k), one worker a
    rank: this rank's replica after k-1 iterations (diverged) and after
    k (averaged), and the net after the sync."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelWrapper,
    )
    net = build("mlp", params, **(net_kw or {}))
    pw = ParallelWrapper(net, workers=2, averaging_frequency=k,
                         average_updaters=True,
                         mesh=MeshContext.create(device="cpu"))
    ds = datasets(batches)
    me = pw.replica(_rank())
    for step in range(k - 1):
        pw._parallel_iteration([ds[2 * step], ds[2 * step + 1]])
    between = flat(me)
    pw._parallel_iteration([ds[2 * (k - 1)], ds[2 * (k - 1) + 1]])
    at = flat(me)
    pw._sync_to_net()
    return dict(between=between, at=at, net=flat(net),
                score=net.score_value, iterations=net.iteration_count)


def case_wrapper_converges(params, batches, test_batch, epochs=20,
                           workers=4, k=3):
    """The reference's ParallelWrapperTest: averaging trains (score and
    accuracy on the whole set), and with k=1 every replica is equal."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelWrapper,
    )
    net = build("mlp", params)
    full = DataSet(*test_batch)
    s0 = net.score(full)
    pw = ParallelWrapper(net, workers=workers, averaging_frequency=k,
                         mesh=MeshContext.create(device="cpu"))
    pw.fit(ListDataSetIterator(datasets(batches)), epochs=epochs)
    acc = net.evaluate(ListDataSetIterator([full])).accuracy()
    eq = build("mlp", params)
    pw1 = ParallelWrapper(eq, workers=workers, averaging_frequency=1,
                          mesh=MeshContext.create(device="cpu"))
    pw1.fit(ListDataSetIterator(datasets(batches)), epochs=1)
    mine = [flat(r) for r in pw1._replicas]
    return dict(s0=s0, s1=net.score(full), accuracy=acc,
                local_equal=all(np.array_equal(mine[0], m)
                                for m in mine[1:]),
                replica0=mine[0])


def case_wrapper_sentinel(batches):
    """A NaN batch on worker 1 under skip_batch (lag 0): one skip, on
    every rank; the net stays finite."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelWrapper,
    )
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        DivergenceSentinel,
    )
    net = build("mlp")
    net.set_divergence_sentinel(DivergenceSentinel("skip_batch", lag=0))
    pw = ParallelWrapper(net, workers=2,
                         mesh=MeshContext.create(device="cpu"))
    ds = datasets(batches)
    bad = datasets([batches[1]])[0]
    bad.features = np.array(bad.features)
    bad.features[0, 0] = np.nan
    pw.fit_batch(ds[0])
    pw._parallel_iteration([ds[0], bad])
    pw._sync_to_net()
    return dict(skipped=net._sentinel.skipped_batches,
                finite=bool(np.isfinite(flat(net)).all()))


def case_delayed(params, batches, net_kw=None):
    """DelayedSyncTrainer: k=1 against ParallelTrainer (bitwise), k=4
    against gradient_accumulation=4 on the merged batches, the deferred
    update, flush."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.strategy import create_trainer
    net_kw = net_kw or {}
    mesh = lambda: MeshContext.create(device="cpu")  # noqa: E731
    ds = datasets(batches)
    a, b = build("mlp", params, **net_kw), build("mlp", params, **net_kw)
    ta, tb = ParallelTrainer(a, mesh()), DelayedSyncTrainer(
        b, mesh(), sync_frequency=1)
    la = [float(ta.fit_batch(d)) for d in ds]
    lb = [float(tb.fit_batch(d)) for d in ds]
    k1 = dict(bitwise=flat(a).tobytes() == flat(b).tobytes(),
              losses=(la, lb))
    c, d4 = build("mlp", params, **net_kw), build("mlp", params, **net_kw)
    tc = ParallelTrainer(c, mesh(), gradient_accumulation=4)
    td = create_trainer("delayed_sync", d4, mesh(), sync_frequency=4)
    merged = DataSet.merge(ds[:4])
    for _ in range(3):
        tc.fit_batch(merged)
        for x in ds[:4]:
            td.fit_batch(x)
    e = build("mlp", params, **net_kw)
    te = DelayedSyncTrainer(e, mesh(), sync_frequency=3)
    p0 = flat(e)
    te.fit_batch(ds[0])
    te.fit_batch(ds[1])
    stale = np.array_equal(flat(e), p0)
    te.fit_batch(ds[2])
    moved = not np.array_equal(flat(e), p0)
    f = build("mlp", params, **net_kw)
    tf = DelayedSyncTrainer(f, mesh(), sync_frequency=10)
    tf.fit_batch(ds[0])
    before_flush = np.array_equal(flat(f), p0)
    tf.flush()
    return dict(k1=k1, k4=(flat(c), flat(d4)), stale=stale, moved=moved,
                before_flush=before_flush,
                flushed=not np.array_equal(flat(f), p0))


def case_tbptt(net_kw, batches, steps=2):
    """A char-RNN's tBPTT windows at world 2: ParallelTrainer (accumulation
    1 and 2) and a twin's plain ``fit_batch`` on the whole global batch in
    this process, no collective; DelayedSyncTrainer(sync_frequency=1)
    against ParallelTrainer."""
    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, MeshContext, ParallelTrainer,
    )
    ds = datasets(batches)
    plain = build("char_rnn", **net_kw)
    out = dict(plain_losses=[float(plain.fit_batch(d))
                             for _ in range(steps) for d in ds])
    out["plain"] = flat(plain)
    out["plain_iterations"] = plain.iteration_count
    for accum in (1, 2):
        net = build("char_rnn", **net_kw)
        tr = ParallelTrainer(net, MeshContext.create(device="cpu"),
                             gradient_accumulation=accum)
        losses = [tr.fit_batch(d) for _ in range(steps) for d in ds]
        out[f"accum{accum}"] = dict(
            losses=[float(x) for x in losses], loss_bytes=f32_bytes(losses),
            params=flat(net), iterations=net.iteration_count)
    net = build("char_rnn", **net_kw)
    td = DelayedSyncTrainer(net, MeshContext.create(device="cpu"),
                            sync_frequency=1)
    losses = [td.fit_batch(d) for _ in range(steps) for d in ds]
    out["delayed"] = dict(
        losses=[float(x) for x in losses], loss_bytes=f32_bytes(losses),
        params=flat(net), iterations=net.iteration_count)
    return out


def case_strategies(batches):
    """create_trainer over the registry, hooks, and the refusals."""
    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, MeshContext, ParallelTrainer, ParallelWrapper,
        multihost,
    )
    from deeplearning4j_tpu_torch.autotune import TunedConfig
    from deeplearning4j_tpu_torch.parallel.strategy import (
        TrainingHook, create_trainer,
    )
    calls = []

    class Hook(TrainingHook):
        def pre_update(self, batch, trainer):
            calls.append("pre")

        def post_update(self, batch, trainer):
            calls.append("post")

    mesh = MeshContext.create(device="cpu")
    pipe = MeshContext.create(n_pipe=2, device="cpu")
    types = {s: type(create_trainer(s, build("mlp"),
                                    pipe if s == "pipeline" else mesh)
                     ).__name__
             for s in ("allreduce", "param_averaging", "delayed_sync",
                       "pipeline")}
    hooked = create_trainer("allreduce", build("mlp"), mesh, hooks=[Hook()])
    hooked.fit_batch(datasets(batches)[0])
    errors = {}
    for label, fn in (
            ("pipeline", lambda: create_trainer(
                "pipeline", build("mlp"), pipe).fit_batch(datasets(
                    [list(batches[0]) + [None, np.ones(
                        len(batches[0][0]), np.float32)]])[0])),
            ("unknown", lambda: create_trainer("gossip", build("mlp"),
                                               mesh)),
            ("workers", lambda: ParallelWrapper(build("mlp"), workers=3,
                                                mesh=mesh)),
            ("zero_workers", lambda: ParallelWrapper(
                build("mlp"), workers=3, mesh=mesh,
                weight_update_sharding="zero1")),
            ("tuned", lambda: multihost.data_parallel_trainer(
                build("mlp"), tuned=TunedConfig(dp=1, pp=2,
                                                device_count=2))),
            ("n_model", lambda: MeshContext.create(n_model=3,
                                                   device="cpu")),
            ("zero1_model", lambda: ParallelTrainer(
                build("mlp"), MeshContext.create(n_model=2, device="cpu"),
                weight_update_sharding="zero1")),
            ("n_data", lambda: MeshContext.create(n_data=4,
                                                  device="cpu")),
            ("rows", lambda: ParallelTrainer(build("mlp"), mesh).fit_batch(
                datasets([[b[:5] for b in batches[0]]])[0])),
            ("local_slice", lambda: multihost.local_batch_slice(7))):
        try:
            fn()
            errors[label] = None
        except Exception as e:   # the type and message are the result
            errors[label] = (type(e).__name__, str(e))
    # tuned= fills the mesh and the knobs left at their defaults; an
    # explicit argument wins
    tuned = TunedConfig(dp=2, gradient_accumulation=2, precision="bf16",
                        weight_update_sharding="zero1", device_count=2)
    tr = ParallelTrainer(build("mlp"), tuned=tuned, device="cpu")
    tr2 = ParallelTrainer(build("mlp"), tuned=tuned, precision="fp32",
                          weight_update_sharding="off", device="cpu")
    pw = ParallelWrapper(build("mlp"), tuned=TunedConfig(
        dp=2, gradient_accumulation=3, device_count=2), device="cpu")
    dpt = multihost.data_parallel_trainer(build("mlp"), tuned=TunedConfig(
        dp=2, gradient_accumulation=2, device_count=2))
    accepted = dict(
        trainer=(tr.mesh.n_data, tr.gradient_accumulation,
                 tr.weight_update_sharding.mode,
                 str(tr.precision.compute_dtype)),
        explicit=(tr2.weight_update_sharding.mode,
                  str(tr2.precision.compute_dtype)),
        wrapper=(pw.workers, pw.averaging_frequency),
        data_parallel=(dpt.mesh.n_data, dpt.gradient_accumulation))
    sl = multihost.local_batch_slice(8)
    return dict(types=types, calls=calls, errors=errors, accepted=accepted,
                local_slice=(sl.start, sl.stop),
                process=(multihost.effective_process_count(),
                         multihost.effective_process_index()),
                classes=(ParallelTrainer.__name__, ParallelWrapper.__name__,
                         DelayedSyncTrainer.__name__))


def case_early_stopping_parallel(params, batches, held_out, epochs=3):
    """``EarlyStoppingParallelTrainer`` over ``ParallelTrainer`` on the
    MLP: ``epochs`` epochs of ``batches``, scored on ``held_out`` by a
    ``DataSetLossCalculator``; the result's fields and the params after
    (the best epoch's, restored by the in-memory saver)."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.parallel import MeshContext
    net = build("mlp", params)
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(epochs)],
        score_calculator=DataSetLossCalculator(
            ListDataSetIterator(datasets(held_out))),
        model_saver=InMemoryModelSaver())
    trainer = EarlyStoppingParallelTrainer(
        cfg, net, ListDataSetIterator(datasets(batches)),
        mesh=MeshContext.create(device="cpu"))
    res = trainer.fit()
    return dict(reason=res.termination_reason, epochs=res.total_epochs,
                best_epoch=res.best_model_epoch,
                best_score=res.best_model_score,
                scores={int(k): float(v)
                        for k, v in res.score_vs_epoch.items()},
                params=flat(net), iterations=net.iteration_count)


def case_stats(batches):
    """ParallelTrainer(collect_training_stats=True) over an iterator."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    net = build("mlp")
    net.set_listeners(ScoreIterationListener(100))
    tr = ParallelTrainer(net, MeshContext.create(device="cpu"),
                         collect_training_stats=True)
    tr.fit(ListDataSetIterator(datasets(batches)), epochs=2,
           use_async=False)
    off = ParallelTrainer(build("mlp"), MeshContext.create(device="cpu"))
    off.fit_batch(datasets(batches)[0])
    stats = tr.training_stats
    return dict(export=stats.export(), wall=stats.wall_s(),
                total=stats.total_phase_s(),
                off_is_none=off.training_stats is None)


# ---------------------------------------------------------------------------
# cases: sharded checkpoints and the fault-tolerant trainer
# ---------------------------------------------------------------------------

def case_save_zero(ckpt_root, params, batches, mode="zero1"):
    """A zero ParallelTrainer one step in, saved through a sharded
    CheckpointManager; then one more step (the uninterrupted run)."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    mesh = MeshContext.create(device="cpu")
    net = build("mlp", params)
    tr = ParallelTrainer(net, mesh, weight_update_sharding=mode)
    ds = datasets(batches)[0]
    tr.fit_batch(ds)
    mgr = CheckpointManager(ckpt_root, sharded=True, mesh_ctx=mesh,
                            weight_update_sharding=mode)
    path = mgr.save(net)
    saved, rows = flat(net), _rows(net)
    count = int(net.opt_state["count"])
    loss = float(tr.fit_batch(ds))
    return dict(path=str(path), saved=saved, rows=rows, count=count,
                next_loss=loss, next_params=flat(net))


def _rows(net) -> dict:
    """Each moment tree's leaves (this rank's rows under ZeRO), numpy."""
    return {k: [t.detach().numpy().copy() for t in _leaves(v)]
            for k, v in net.opt_state.items() if k != "count"}


def case_torn_zero(ckpt_root, batches, mode="zero1"):
    """A torn second save (``truncate_checkpoint`` torn mode on every
    rank's shard file): latest_valid falls back to the first."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule,
    )
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    mesh = MeshContext.create(device="cpu")
    net = build("mlp")
    tr = ParallelTrainer(net, mesh, weight_update_sharding=mode)
    ds = datasets(batches)[0]
    tr.fit_batch(ds)
    mgr = CheckpointManager(ckpt_root, sharded=True, mesh_ctx=mesh,
                            weight_update_sharding=mode)
    mgr.save(net)
    good = net.iteration_count
    tr.fit_batch(ds)
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", at_call=1, mode="torn")]))
    try:
        mgr.save(net)
    finally:
        faultinject.clear()
    import torch.distributed as dist
    dist.barrier()
    return dict(good=good, latest=mgr.latest_valid().step)


def case_restore_zero(ckpt_root, batches, mode="zero1", steps=1):
    """A fresh net (another seed) under a zero trainer restores the latest
    valid sharded checkpoint (its own rows), then trains on."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    mesh = MeshContext.create(device="cpu")
    net = build("mlp", seed=777)
    tr = ParallelTrainer(net, mesh, weight_update_sharding=mode)
    mgr = CheckpointManager(ckpt_root, sharded=True, mesh_ctx=mesh,
                            weight_update_sharding=mode)
    cursor = mgr.restore(net)
    rows = _rows(net)
    restored = flat(net)
    count = int(net.opt_state["count"])
    ds = datasets(batches)[0]
    losses = [float(tr.fit_batch(ds)) for _ in range(steps)]
    return dict(step=None if cursor is None else cursor.step,
                restored=restored, rows=rows, count=count, losses=losses,
                params=flat(net))


def case_ft_parallel(ckpt_root, batches, mode="off"):
    """FaultTolerantTrainer over a ParallelTrainer on each rank, one
    sharded manager: a ``raise`` fault retried, the run completes."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule,
    )
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.resilience.trainer import (
        FaultTolerantTrainer,
    )
    mesh = MeshContext.create(device="cpu")
    net = build("mlp")
    tr = ParallelTrainer(net, mesh, weight_update_sharding=mode)
    mgr = CheckpointManager(ckpt_root, sharded=True, mesh_ctx=mesh,
                            weight_update_sharding=mode, keep_last=2)
    ft = FaultTolerantTrainer(net, mgr, trainer=tr, checkpoint_every=2,
                              backoff_base=0.001, backoff_max=0.01)
    faultinject.set_schedule(FaultSchedule([Fault("raise", step=2)]))
    try:
        ft.fit(datasets(batches), epochs=1)
    finally:
        faultinject.clear()
    return dict(iterations=net.iteration_count, params=flat(net),
                steps=[i.step for i in mgr.checkpoints()],
                latest=mgr.latest_valid().step)


# ---------------------------------------------------------------------------
# a run killed mid-checkpoint (one process, no group)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# cases: the model and sp axes (tensor and sequence parallelism)
# ---------------------------------------------------------------------------

_HALVES: dict = {}


def mesh_for(layout, min_shard=None):
    """A CPU mesh of ``layout`` (n_data, n_model, n_seq): over the default
    group when it spans the world, else over this rank's part of the
    world cut into groups of its size (every rank builds every part, in
    the same order)."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import MeshContext
    nd, nm, ns = layout
    size, world = nd * nm * ns, dist.get_world_size()
    group = None
    if size < world:
        if size not in _HALVES:
            parts = [dist.new_group(list(range(i, i + size)))
                     for i in range(0, world, size)]
            _HALVES[size] = parts[dist.get_rank() // size]
        group = _HALVES[size]
    mesh = MeshContext.create(n_data=nd, n_model=nm, n_seq=ns, device="cpu",
                              group=group)
    if min_shard is not None:
        mesh.min_shard_size = min_shard
    return mesh


def _err(fn):
    try:
        fn()
        return None
    except Exception as e:   # the type and message are the result
        return (type(e).__name__, str(e))


def case_mesh_train(kind, net_kw, params, batches, layout, steps=1,
                    min_shard=16, mode="off", accum=1, save=None):
    """``steps`` passes over ``batches`` through ``ParallelTrainer`` on a
    mesh of ``layout``: the losses, the leaves it shards, the param and
    moment bytes this rank holds (sharded and whole), the refusal of
    ``score`` while the shards are attached, and after ``gather_params``
    the whole params. ``save``: a directory a sharded CheckpointManager
    writes after the last step (before the gather)."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    net = build(kind, params, **net_kw)
    whole = sum(t.numel() * t.element_size() for t in _leaves(net.params))
    mesh = mesh_for(layout, min_shard)
    tr = ParallelTrainer(net, mesh, weight_update_sharding=mode,
                         gradient_accumulation=accum)
    shards = getattr(net, "_model_shards", None)
    sharded = sorted(f"{k}/{n}" for k, v in
                     (shards.spec.items() if shards else ())
                     for n, f in v.items() if f)
    rank_bytes = sum(t.numel() * t.element_size()
                     for t in _leaves(net.params))
    losses = [tr.fit_batch(b) for _ in range(steps)
              for b in datasets(batches)]
    out = dict(losses=[float(x) for x in losses], coords=mesh.coords,
               sharded=sharded, param_bytes=rank_bytes, whole_bytes=whole,
               moment_bytes=sum(t.numel() * t.element_size()
                                for k, v in net.opt_state.items()
                                if k != "count" for t in _leaves(v)),
               score_refused=_err(lambda: net.score(datasets(batches)[0])))
    if save is not None:
        mgr = CheckpointManager(save, sharded=True, mesh_ctx=mesh)
        out["saved"] = str(mgr.save(net))
    tr.gather_params()
    out["params"] = flat(net)
    out["leaves"] = {f"{k}/{n}": t.numpy().copy()
                     for k, v in (enumerate(net.params)
                                  if isinstance(net.params, list)
                                  else net.params.items())
                     for n, t in v.items()}
    out["score"] = net.score(datasets(batches)[0])
    first = (net.params[0] if isinstance(net.params, list)
             else net.params["embed"])
    out["bias0"] = first["b"].numpy().copy() if "b" in first else None
    return out


def case_mesh_roundtrip(kind, net_kw, batches, layout, min_shard=16):
    """Two steps with a ``gather_params`` between them against two steps
    without: the gather re-shards on the next step, bit for bit."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    runs = []
    for gather_between in (False, True):
        net = build(kind, **net_kw)
        tr = ParallelTrainer(net, mesh_for(layout, min_shard))
        tr.fit_batch(datasets(batches)[0])
        if gather_between:
            tr.gather_params()
            mid = flat(net)
        tr.fit_batch(datasets(batches)[0])
        tr.gather_params()
        runs.append(flat(net))
    return dict(straight=runs[0], gathered=runs[1], mid=mid)


def case_mesh_restore(ckpt, kind, net_kw, layout, batches, min_shard=16):
    """A fresh net (another seed) under a trainer on ``layout`` restores
    the sharded checkpoint ``ckpt`` (its column shards), then gathers;
    and one step after the restore."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager, checkpoint_tree,
    )
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        restore_sharded_into,
    )
    net = build(kind, seed=777, **net_kw)
    mesh = mesh_for(layout, min_shard)
    tr = ParallelTrainer(net, mesh)
    tpl = checkpoint_tree(net, True)
    from deeplearning4j_tpu_torch.resilience.manager import _write_back
    _write_back(net, tpl, restore_sharded_into(ckpt, tpl, mesh))
    loss = float(tr.fit_batch(datasets(batches)[0]))
    tr.gather_params()
    return dict(params=flat(net), loss=loss,
                mu=[t.numpy().copy() for t in _leaves(net.opt_state["mu"])])


def case_mesh_refusals(layouts):
    """The mesh layouts' refusals (each an error or None)."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    out = {}
    out["n_model_3"] = _err(lambda: MeshContext.create(n_model=3,
                                                       device="cpu"))
    out["zero1_model"] = _err(lambda: ParallelTrainer(
        build("mlp"), mesh_for((2, 2, 1)), weight_update_sharding="zero1"))
    out["zero2_model_dp1"] = _err(lambda: ParallelTrainer(
        build("mlp"), mesh_for((1, 4, 1)), weight_update_sharding="zero2"))
    for layout in layouts:
        m = mesh_for(layout, 16)
        out[str(tuple(layout))] = dict(
            coords=m.coords, n_data=m.n_data, model_axis=m.model_axis,
            seq_axis=m.seq_axis, rows=(m.batch_slice(8).start,
                                       m.batch_slice(8).stop),
            spec=m.param_spec("l1/W", (8, 64)))
    return out


def case_ring(arrays, layout, causal, block_size, masked):
    """``ring_self_attention`` on this rank's shard of ``x`` (and of the
    mask) over ``layout``'s sp axis, its output shard and the gradients
    of sum(out**2) with respect to the weights (summed over the ranks)."""
    import torch
    from deeplearning4j_tpu_torch.parallel.sequence import (
        ring_self_attention,
    )
    mesh = mesh_for(layout)
    x, mask = arrays["x"], arrays.get("mask")
    params = {k: torch.tensor(arrays[k], requires_grad=True)
              for k in ("Wq", "Wk", "Wv", "Wo")}
    rows = mesh.batch_slice(x.shape[0])
    steps = mesh.seq_slice(x.shape[1])
    xl = torch.tensor(x[rows][:, steps])
    ml = None if mask is None else torch.tensor(mask[rows][:, steps])
    out = ring_self_attention(xl, params, mesh, n_heads=arrays["H"],
                              head_dim=arrays["D"], causal=causal,
                              block_size=block_size,
                              mask=ml if masked else None)
    (out ** 2).sum().backward()
    grads = {k: mesh.sum_over_ranks(v.grad, "replicas").numpy().copy()
             for k, v in params.items()}
    return dict(out=out.detach().numpy().copy(), rows=(rows.start, rows.stop),
                steps=(steps.start, steps.stop), grads=grads)


def case_scope_routing():
    """``_ring_context`` inside and outside ``sequence_parallel_scope``,
    with the opt-out flag, and ``batch_sharding`` / ``shard_batch`` for
    a T that divides the sp axis and one that does not."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import (
        sequence_parallel_scope,
    )
    mesh = mesh_for((1, 1, 4))
    layer = SelfAttentionLayer(n_heads=2, sequence_parallel=False)
    layer.set_n_in(InputType.recurrent(8, 16))
    x = torch.zeros((2, 4, 8))
    out = {}
    with sequence_parallel_scope(mesh):
        out["opt_out"] = layer._ring_context(x, None)
        layer.sequence_parallel = True
        out["ring"] = layer._ring_context(x, None) is mesh
        out["masked_ring"] = layer._ring_context(
            x, torch.ones((2, 4))) is mesh
    with sequence_parallel_scope(mesh, seq_split=False):
        out["not_split"] = layer._ring_context(x, None)
    out["exited"] = layer._ring_context(x, None)
    a15 = np.zeros((4, 15, 8), np.float32)
    a16 = np.arange(4 * 16 * 8, dtype=np.float32).reshape(4, 16, 8)
    out["spec15"] = mesh.batch_sharding(3, a15.shape)
    out["spec16"] = mesh.batch_sharding(3, a16.shape)
    out["shape15"] = tuple(mesh.shard_batch(a15).shape)
    out["piece16"] = mesh.shard_batch(a16)
    return out


def sigkill_mid_checkpoint(ckpt_root: str, out: str) -> None:
    """Train three checkpointed steps, write the intact params to ``out``,
    then die by SIGKILL inside the next checkpoint's commit (the
    ``truncate_checkpoint`` crash fault tears the tmp file first)."""
    import signal

    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule, KilledByFault,
    )
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.resilience.trainer import (
        FaultTolerantTrainer,
    )
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(6, 4)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])
               for _ in range(4)]
    net = build("mlp", hidden=8, seed=1)
    mgr = CheckpointManager(ckpt_root, keep_last=3)
    FaultTolerantTrainer(net, mgr, checkpoint_every=1).fit(
        datasets(batches[:3]), epochs=1)
    np.save(out, flat(net))
    net.fit_batch(datasets(batches[3:])[0])
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", at_call=1, mode="crash")]))
    try:
        mgr.save(net)
    except KilledByFault:
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# the elastic trainer's ranks
# ---------------------------------------------------------------------------

def elastic_net(seed=99, kind="mlp"):
    """The elastic cases' net: the MLP with Adam, so zero1 has moments to
    move across widths, or (``kind="lenet_bn"``) LeNet with batch norm,
    whose training forward sums its statistics over the ranks."""
    if kind == "lenet_bn":
        return build("lenet_bn", seed=seed)
    return build("mlp", hidden=8, seed=seed)


def elastic_batches(n=6, rows=8, kind="mlp"):
    """The same global batches on every rank (for ``elastic_net(kind)``)."""
    rng = np.random.default_rng(0)
    shape, classes = (((16, 16, 1), 10) if kind == "lenet_bn"
                      else ((4,), 3))
    return datasets([(rng.normal(size=(rows,) + shape).astype(np.float32),
                      np.eye(classes, dtype=np.float32)[
                          rng.integers(0, classes, rows)])
                     for _ in range(n)])


def freeze_at(step: int) -> None:
    """Arm this process to stop (SIGSTOP) before its step ``step``: a host
    that hangs or is preempted without closing its sockets. Every thread
    stops, its heartbeat's too, and a peer's collective waits on it
    until the group's timeout: no connection reset tells the peer."""
    import signal

    from deeplearning4j_tpu_torch.resilience import faultinject
    check_kill = faultinject.check_kill

    def check(step_id):
        if step_id == step:
            os.kill(os.getpid(), signal.SIGSTOP)
        check_kill(step_id)
    faultinject.check_kill = check


def elastic_rank(spec_path, rank, world, init_method, out_dir) -> int:
    """One rank of an elastic case: ``spec`` names the checkpoint
    directory, the fault (kind, step, victim rank, duration, join rank),
    the epochs, the trainer's windows, whether the ranks join an external
    coordination store (``host_service: false``) and the rendezvous
    epoch."""
    import json

    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.profiling.metrics import get_registry
    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.elastic import (
        ElasticRestartRequired, ElasticTrainer,
    )
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule,
    )
    spec = json.loads(Path(spec_path).read_text())
    rank, world = int(rank), int(world)
    if world > 1:
        multihost.initialize(
            init_method, world, rank, device="cpu", elastic=True,
            timeout_s=spec.get("group_timeout_s", 30.0),
            host_service=spec.get("host_service"),
            rendezvous_epoch=spec.get("rendezvous_epoch", 0))
    fault = spec.get("fault")
    if fault and rank == fault.get("victim", 1):
        if fault["kind"] == "freeze":
            freeze_at(fault["step"])
        else:
            faultinject.set_schedule(FaultSchedule([Fault(
                kind=fault["kind"], step=fault["step"],
                duration=fault.get("duration", 0.0),
                rank=fault.get("rank", -1))]))
    kind = spec.get("net", "mlp")
    trainer = ElasticTrainer(
        functools.partial(elastic_net, kind=kind), spec["ckpt"],
        weight_update_sharding=spec.get("mode", "zero1"),
        checkpoint_every=1, keep_last=50,
        step_timeout_s=spec.get("step_timeout_s", 5.0),
        heartbeat_interval_s=0.1,
        heartbeat_timeout_s=spec.get("heartbeat_timeout_s", 1.0),
        commit_timeout_s=30.0)
    restart = None
    try:
        trainer.fit(elastic_batches(kind=kind),
                    epochs=spec.get("epochs", 1))
    except ElasticRestartRequired as e:
        restart = dict(survivors=e.survivors, coordinator=e.coordinator,
                       epoch=e.epoch, grow=e.grow)
    finally:
        trainer.close()
    reg = get_registry()
    out = Path(out_dir)
    np.save(out / f"params_r{rank}.npy", flat(trainer.net))
    (out / f"elastic_r{rank}.json").write_text(json.dumps(dict(
        trajectory=trainer.trajectory, world=trainer.world,
        dp=trainer.dp_width, restart=restart,
        cursor_step=None if trainer._cursor is None
        else trainer._cursor.step,
        runtime_faults=multihost.runtime_fault_count(),
        quarantined=multihost.group_quarantined(),
        abandoned_step_threads=len(trainer._step_threads),
        topology=trainer.manager.topology(),
        metrics=dict(reg.snapshot("elastic_"),
                     **reg.snapshot("resilience_host")))))
    multihost.shutdown()
    return 0


# ---------------------------------------------------------------------------
# cases: the pipeline and expert axes (pipeline and expert parallelism)
# ---------------------------------------------------------------------------

_PIPE_PARTS: dict = {}


def pipe_mesh(layout):
    """A CPU mesh of the pipeline ``layout`` (n_data, n_pipe): over the
    default group when it spans the world, else over this rank's part of
    the world cut into groups of its size (pp-only meshes)."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import MeshContext
    nd, npp = layout
    size, world = nd * npp, dist.get_world_size()
    group = None
    if size < world:
        if size not in _PIPE_PARTS:
            parts = [dist.new_group(list(range(i, i + size)))
                     for i in range(0, world, size)]
            _PIPE_PARTS[size] = parts[dist.get_rank() // size]
        group = _PIPE_PARTS[size]
    return MeshContext.create(n_data=nd, n_pipe=npp, device="cpu",
                              group=group)


def conf_net(conf_json, graph=False, params=None):
    """A port net on the CPU from a JAX config's JSON, with ``params``
    (numpy, the JAX net's layout) carried in when given."""
    import deeplearning4j_tpu_torch.parallel.expert  # noqa: F401 (MoELayer)
    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if graph:
        conf = ComputationGraphConfiguration.from_json(conf_json)
        net = ComputationGraph(conf, device="cpu")
    else:
        conf = MultiLayerConfiguration.from_json(conf_json)
        net = MultiLayerNetwork(conf, device="cpu")
    return net.init(None if params is None else params_from_jax(conf, params))


def batches_of(arrays, multi=False):
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    if multi:
        return [MultiDataSet(list(f), list(l)) for f, l in arrays]
    return datasets(arrays)


def _tree_numpy(tree):
    from deeplearning4j_tpu_torch.convert import params_to_numpy
    return params_to_numpy(tree)


def case_pp_fit(conf, batches, layout=(1, 2), M=None, steps=1, graph=False,
                params=None, stages=None, multi=False, sentinel=None,
                poison=None, save=None):
    """``steps`` passes over ``batches`` through the pipeline trainer of
    ``create_trainer("pipeline", ...)`` on a mesh of ``layout``: the
    losses, the stages, the param and moment bytes this rank holds
    against the whole net's, ``score`` refused while attached, and after
    ``gather_params`` the params, states and moments (and, with
    ``save``, the params a zip written and restored holds). ``poison``:
    the index of a batch whose features are NaN, under a sentinel."""
    import torch
    from deeplearning4j_tpu_torch.parallel.strategy import create_trainer
    net = conf_net(conf, graph, params)
    if sentinel is not None:
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            DivergenceSentinel,
        )
        net.set_divergence_sentinel(DivergenceSentinel(sentinel, lag=0))
    nbytes = [sum(t.numel() * t.element_size() for t in _leaves(tree))
              for tree in (net.params, {k: v for k, v in
                                        net.opt_state.items()
                                        if k != "count"})]
    mesh = pipe_mesh(layout)
    kw = {} if stages is None else dict(stages=stages)
    tr = create_trainer("pipeline", net, mesh, n_microbatches=M, **kw)
    rank_bytes = [sum(t.numel() * t.element_size() for t in _leaves(tree))
                  for tree in (net.params, {k: v for k, v in
                                            net.opt_state.items()
                                            if k != "count"})]
    data = batches_of(batches, multi)
    losses, mid = [], None
    for step in range(steps):
        for i, b in enumerate(data):
            if poison == i and step == 0:
                b = type(b)(b.features * np.nan, b.labels)
                before = [t.clone() for t in _leaves(net.params)]
                losses.append(float(tr.fit_batch(b)))
                mid = all(torch.equal(a, c) for a, c in
                          zip(before, _leaves(net.params)))
                continue
            losses.append(float(tr.fit_batch(b)))
    out = dict(losses=losses, type=type(tr).__name__,
               stages=[list(st) for st in tr.stages], S=tr.S, M=tr.M,
               coords=(mesh.data_index, mesh.pipe_index),
               whole_bytes=nbytes, rank_bytes=rank_bytes,
               iterations=net.iteration_count, poisoned_kept=mid,
               score_refused=_err(lambda: net.score(data[0])))
    if sentinel is not None:
        net._sentinel.flush()
        out["skipped"] = net._sentinel.skipped_batches
    tr.gather_params()
    out["params"] = flat(net)
    out["leaves"] = _tree_numpy(net.params)
    out["states"] = _tree_numpy(net.states)
    out["moments"] = {k: _tree_numpy(v) for k, v in net.opt_state.items()
                      if k != "count"}
    out["score"] = net.score(data[0])
    if save is not None:
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        path = Path(save) / f"pp_rank{_rank()}.zip"
        ModelSerializer.write_model(net, str(path))
        out["zip_params"] = ModelSerializer.restore_model(
            str(path), device="cpu").params_flat()
    if out["type"] == "PipelineTrainer" and len(data[0].features.shape) < 3:
        out["output"] = net.output(data[0].features).numpy()
    return out


def case_pp_repeat(conf, batches, layout=(1, 2), M=2, steps=3, graph=False):
    """Two trainers from one config seed on the same batches (dropout
    inside the stages): both runs' losses, and two inference passes
    after ``gather_params``."""
    runs = []
    for _ in range(2):
        from deeplearning4j_tpu_torch.parallel.strategy import (
            create_trainer,
        )
        net = conf_net(conf, graph)
        tr = create_trainer("pipeline", net, pipe_mesh(layout),
                            n_microbatches=M)
        runs.append([float(tr.fit_batch(b)) for _ in range(steps)
                     for b in batches_of(batches)])
        tr.gather_params()
    x = batches_of(batches)[0].features
    o = net.output(x)
    return dict(runs=runs, outputs_equal=bool((o == net.output(x)).all()))


def case_pp_refusals(conf, batches, layout=(1, 2), M=None, graph=False,
                     masked=False, multi_arrays=None, remat=False,
                     tbptt_bwd=None, dp_layout=None, rank2_labels=False,
                     full=False):
    """The pipeline trainers' refusals, each an error or None."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, MultiDataSet,
    )
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GraphPipelineTrainer, PipelineTrainer,
    )
    cls = GraphPipelineTrainer if graph else PipelineTrainer
    out = {}

    def fresh():
        net = conf_net(conf, graph)
        if remat:
            net.conf.training.remat = True
        if tbptt_bwd is not None:
            net.conf.training.tbptt_bwd_length = tbptt_bwd
        return net
    out["construct"] = _err(lambda: cls(fresh(), pipe_mesh(layout),
                                        n_microbatches=M))
    out["axis"] = _err(lambda: cls(fresh(), pipe_mesh(layout), axis="x"))
    if out["construct"] is None:
        tr = cls(conf_net(conf, graph), pipe_mesh(layout), n_microbatches=M)
        b = batches_of(batches)[0]
        if masked:
            out["masked"] = _err(lambda: tr.fit_batch(DataSet(
                b.features, b.labels,
                labels_mask=np.ones((b.features.shape[0],), np.float32))))
        if rank2_labels:
            out["rank2"] = _err(lambda: tr.fit_batch(DataSet(
                b.features, b.labels[:, 0])))
        if multi_arrays is not None:
            out["multi"] = [_err(lambda f=f, l=l: tr.fit_batch(
                MultiDataSet(list(f), list(l)))) for f, l in multi_arrays]
        out["rows"] = _err(lambda: tr.fit_batch(DataSet(
            b.features[:-1], b.labels[:-1])))
        if full:
            out["full"] = _err(lambda: tr.fit_batch(b))
        tr.gather_params()
    if dp_layout is not None:
        out["dp"] = _err(lambda: cls(fresh(), pipe_mesh(dp_layout),
                                     n_microbatches=M))
    return out


def case_pp_stats(conf, batches, layout=(1, 2), M=2, graph=False):
    """``fit`` over an iterator (two epochs) with
    ``collect_training_stats``: the exported phases and the listener's
    iteration and epoch events."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel.strategy import create_trainer
    events = []

    class Hook(TrainingListener):
        def on_epoch_start(self, model):
            events.append("start")

        def on_epoch_end(self, model):
            events.append("end")

        def iteration_done(self, model, iteration, score):
            events.append("iter")

    net = conf_net(conf, graph)
    net.set_listeners(Hook())
    tr = create_trainer("pipeline", net, pipe_mesh(layout), n_microbatches=M,
                        collect_training_stats=True)
    tr.fit(ListDataSetIterator(batches_of(batches)), epochs=2)
    st = tr.training_stats
    return dict(export=st.export(), total=st.total_phase_s(),
                wall=st.wall_s(), events=events, epochs=net.epoch_count)


def case_pipeline_apply(stacked, xs, layout):
    """``pipeline_apply`` of tanh(x @ W + b) stages over ``layout``: the
    result on this rank and the gradient of sum(out**2) with respect to
    this rank's row of the stack."""
    import torch
    from deeplearning4j_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = pipe_mesh(layout)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in stacked.items()}

    def stage_fn(p, x):
        return torch.tanh(x @ p["W"] + p["b"]) if "b" in p \
            else torch.tanh(x @ p["W"])
    out = pipeline_apply(stage_fn, params, torch.tensor(xs), mesh)
    (out ** 2).sum().backward()
    mesh.wait_sends()
    row = mesh.pipe_index
    return dict(out=out.detach().numpy().copy(), row=row,
                grads={k: v.grad[row].numpy().copy()
                       for k, v in params.items()},
                other_rows_zero=all(
                    bool((v.grad[[i for i in range(v.shape[0])
                                  if i != row]] == 0).all())
                    for v in params.values()))


def case_moe_sharded(params, x, n_ep=2, activation="relu",
                     capacity_factor=1.25):
    """``moe_ffn`` with the experts sharded over an 'ep' axis of
    ``n_ep`` ranks (each its rows of W1/b1/W2/b2, the same tokens): the
    output, the aux loss and the gradients of sum(out**2) + aux with
    respect to Wg, x and this rank's expert rows (and their span)."""
    import torch
    from deeplearning4j_tpu_torch.parallel import MeshContext
    from deeplearning4j_tpu_torch.parallel.expert import (
        expert_rows, expert_span, moe_ffn,
    )
    mesh = MeshContext.create(n_expert=n_ep, device="cpu")
    full = {k: torch.tensor(v) for k, v in params.items()}
    mine = {k: v.requires_grad_() for k, v in
            expert_rows(full, mesh).items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe_ffn(mine, xt, activation, capacity_factor, mesh=mesh)
    ((out ** 2).sum() + aux).backward()
    span = expert_span(full["Wg"].shape[-1], mesh)
    return dict(out=out.detach().numpy().copy(), aux=float(aux.detach()),
                span=(span.start, span.stop), dx=xt.grad.numpy().copy(),
                grads={k: v.grad.numpy().copy() for k, v in mine.items()})


def case_moe_data(conf, params, batches, layout=(2, 1, 1), steps=1,
                  mode="off", accum=1, graph=False):
    """A net with an MoELayer through ``ParallelTrainer`` on a mesh of
    ``layout``, ``steps`` passes over ``batches``: the losses, the params
    after, the layer's aux-loss state, and what the step's dispatch
    moved over the data axis (all-gathers, and the differentiable sums
    forward and back)."""
    from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
    net = conf_net(conf, graph, params)
    mesh = mesh_for(layout)
    gathers, sums = [], []
    gather, total = MeshContext.all_gather, MeshContext.sum_over_ranks

    def counted_gather(self, row, axis="data"):
        gathers.append((axis, row.numel() * row.element_size()))
        return gather(self, row, axis)

    def counted_sum(self, t, axis="data"):
        sums.append((axis, t.numel() * t.element_size()))
        return total(self, t, axis)
    MeshContext.all_gather = counted_gather
    MeshContext.sum_over_ranks = counted_sum
    try:
        tr = ParallelTrainer(net, mesh, weight_update_sharding=mode,
                             gradient_accumulation=accum)
        losses = [float(tr.fit_batch(b)) for _ in range(steps)
                  for b in batches_of(batches)]
    finally:
        MeshContext.all_gather = gather
        MeshContext.sum_over_ranks = total
    aux = [float(s["aux_loss"]) for s in
           (net.states.values() if isinstance(net.states, dict)
            else net.states) if isinstance(s, dict) and "aux_loss" in s]
    return dict(losses=losses, params=flat(net), aux=aux,
                coords=mesh.coords, gathers=gathers, sums=sums)


def case_moe_crossings(conf, batches, layout=(2, 1, 1), steps=1):
    """C31's gate on an MoE MLP (``Dense(relu) -> MoELayer``, the net the
    port inits from ``conf``'s seed): the plain ``fit_batch`` of each
    global batch, then ``ParallelTrainer`` on a mesh of ``layout``; before
    each mesh step the units whose ReLU pre-activation has another sign
    than before the plain step (``chip_smoke.Crossings``), and after
    the run ``chip_smoke.moe_crossing_gate``."""
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nn.updater import tree_map
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    run = batches_of(batches) * steps
    plain, snaps = conf_net(conf), []
    for b in run:
        snaps.append(tree_map(lambda t: t.detach().clone(), plain.params))
        plain.fit_batch(b)
    net = conf_net(conf)
    mesh = mesh_for(layout)
    tr = ParallelTrainer(net, mesh)
    crossed = cs.Crossings(snaps, mesh.n_data, net.layers[1].capacity_factor)
    for i, b in enumerate(run):
        crossed.before(i, net.params, torch.as_tensor(b.features))
        tr.fit_batch(b)
    gate = cs.moe_crossing_gate(net.params, plain.params, crossed.units)
    return dict(gate, per_step=crossed.per_step,
                crossed_expert=crossed.units["expert"].nonzero().tolist())


def case_autotune(conf, global_batch=16):
    """The autotuner over this group (every rank searches, probes and
    picks together; real probes, ``top_k=1``), then its trainer against a
    hand-built ``ParallelTrainer(**tuned.trainer_kwargs())`` for 3 steps
    of the probe batch, each on a fresh net: the tuned config's dict, the
    two runs' loss bytes and params."""
    from deeplearning4j_tpu_torch.autotune import autotune
    from deeplearning4j_tpu_torch.autotune.probe import synthesize_batch
    from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
    tuned = autotune(conf_net(conf), global_batch=global_batch, top_k=1,
                     probe_steps=1)
    ds = synthesize_batch(conf_net(conf).conf, global_batch)

    def run(build):
        net = conf_net(conf)
        tr = build(net)
        losses = [tr.fit_batch(ds) for _ in range(3)]
        return f32_bytes(losses), flat(net)
    tuned_run = run(lambda n: tuned.trainer(n))
    hand_run = run(lambda n: ParallelTrainer(
        n, MeshContext.create(n_data=tuned.dp, n_model=tuned.tp,
                              n_seq=tuned.sp, device="cpu"),
        **tuned.trainer_kwargs()))
    return dict(tuned=tuned.to_dict(), tuned_run=tuned_run,
                hand_run=hand_run)


def case_moe_refusals(conf, batches):
    """A net with an MoELayer under each data-parallel trainer at world 2:
    ParallelTrainer's step over the global batch (the losses and the
    params after one step), the wrapper and the delayed trainer with
    their per-worker semantics, and the expert / pipeline axes'
    refusals."""
    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, MeshContext, ParallelTrainer, ParallelWrapper,
    )
    mesh = MeshContext.create(device="cpu")
    b = batches_of(batches)[0]
    net = conf_net(conf)
    loss = float(ParallelTrainer(net, mesh).fit_batch(b))
    out = dict(
        parallel=dict(loss=loss, params=flat(net)),
        wrapper=_err(lambda: ParallelWrapper(conf_net(conf), mesh=mesh,
                                             workers=2).fit_batch(b)),
        delayed=_err(lambda: DelayedSyncTrainer(conf_net(conf),
                                                mesh=mesh).fit_batch(b)),
        ep_data=_err(lambda: MeshContext.create(n_expert=2, n_data=2,
                                                device="cpu")),
        pp_model=_err(lambda: MeshContext.create(n_pipe=2, n_model=2,
                                                 device="cpu")),
        pp_in_parallel=_err(lambda: ParallelTrainer(
            conf_net(conf), MeshContext.create(n_pipe=2, device="cpu"))))
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(spec_path, rank, world, init_method, out_path) -> int:
    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import multihost
    spec = pickle.loads(Path(spec_path).read_bytes())
    multihost.initialize(init_method, world_size=int(world),
                         rank=int(rank), device="cpu", timeout_s=120.0)
    import torch.distributed as dist
    results = {}
    try:
        for case in spec["cases"]:
            try:
                results[case["name"]] = CASES[case["fn"]](
                    **case.get("args", {}))
            except Exception:
                results[case["name"]] = {ERROR: traceback.format_exc()}
            dist.barrier()
    finally:
        multihost.shutdown()
    Path(out_path).write_bytes(pickle.dumps(results))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "elastic":
        sys.exit(elastic_rank(*sys.argv[2:7]))
    if sys.argv[1] == "sigkill":
        sigkill_mid_checkpoint(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main(*sys.argv[1:6]))
