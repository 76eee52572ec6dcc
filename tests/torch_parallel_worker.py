"""The rank side of the port's data-parallel tests: a group of gloo
processes on the CPU, each importing torch and the port, never JAX.

``run_group(cases, tmp)`` pickles the cases (a name, the name of a case
function here and its keyword arguments: configs, numpy weights copied
from a JAX net, numpy batches), starts ``world`` processes of this file
joined through a ``file://`` rendezvous under ``tmp``, and returns each
rank's results: ``{case name: value}``, a case that raised carrying its
traceback (``result`` raises it as ``RankError``). One group serves a
whole test module; each test reads its case's results.

Run alone: ``python tests/torch_parallel_worker.py <spec> <rank>
<world> <init_method> <out>``.
"""

from __future__ import annotations

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
             n_out=3, clip=None, frozen=False, layer_lr=None):
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.core import (
        DenseLayer, OutputLayer,
    )
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).weight_init("xavier"))
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


def build(kind: str, params=None, **kw):
    """A port net on the CPU: ``kind`` "mlp", "gpt" (``gpt_tiny``) or
    "char_rnn" (``char_rnn_lstm``), with ``params`` (numpy, the JAX net's
    layout) carried in when given."""
    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if kind == "mlp":
        conf, cls = mlp_conf(**kw), MultiLayerNetwork
    elif kind == "gpt":
        from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
        conf, cls = gpt_tiny(**kw), ComputationGraph
    elif kind == "char_rnn":
        from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
        conf, cls = char_rnn_lstm(**kw), MultiLayerNetwork
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
               opt_shapes=shapes, iterations=net.iteration_count)
    if sentinel is not None:
        net._sentinel.flush()
        out["skipped"] = net._sentinel.skipped_batches
    return out


def _leaves(tree):
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    return tree_leaves(tree)


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
    types = {s: type(create_trainer(s, build("mlp"), mesh)).__name__
             for s in ("allreduce", "param_averaging", "delayed_sync")}
    hooked = create_trainer("allreduce", build("mlp"), mesh, hooks=[Hook()])
    hooked.fit_batch(datasets(batches)[0])
    errors = {}
    for label, fn in (
            ("pipeline", lambda: create_trainer("pipeline", build("mlp"),
                                                mesh)),
            ("unknown", lambda: create_trainer("gossip", build("mlp"),
                                               mesh)),
            ("workers", lambda: ParallelWrapper(build("mlp"), workers=3,
                                                mesh=mesh)),
            ("zero_workers", lambda: ParallelWrapper(
                build("mlp"), workers=3, mesh=mesh,
                weight_update_sharding="zero1")),
            ("tuned", lambda: ParallelTrainer(build("mlp"), mesh,
                                              tuned=object())),
            ("n_model", lambda: MeshContext.create(n_model=2,
                                                   device="cpu")),
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
    sl = multihost.local_batch_slice(8)
    return dict(types=types, calls=calls, errors=errors,
                local_slice=(sl.start, sl.stop),
                process=(multihost.effective_process_count(),
                         multihost.effective_process_index()),
                classes=(ParallelTrainer.__name__, ParallelWrapper.__name__,
                         DelayedSyncTrainer.__name__))


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
    if sys.argv[1] == "sigkill":
        sigkill_mid_checkpoint(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main(*sys.argv[1:6]))
