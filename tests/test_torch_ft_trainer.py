"""Sharded checkpoints, ``CheckpointManager`` and ``FaultTolerantTrainer``
in the port (``parallel/checkpoint.py``, ``resilience/manager.py``,
``resilience/trainer.py``), against the JAX package's files.

At world 2 (one group of two gloo processes for the module,
``torch_parallel_worker``):

- a port zero1 run saves through a sharded manager: a fresh zero1
  trainer restores it and goes on bit for bit as the uninterrupted run
  (``tests/test_zero1.py:138``); the JAX package's ``CheckpointManager``
  (its ``restore_sharded_into``) restores the same directory into a JAX
  zero1 net with every leaf equal, row for row; the port restores it at
  world 1 (``reshard=True``) and its next step agrees with the world-2
  run at 2e-4 / 2e-5;
- a JAX-written zero1 dp=2 directory restores into the port at world 2
  (each rank's rows) and at world 1 (un-padded), every leaf equal;
- a torn sharded save is skipped by ``latest_valid``
  (``tests/test_zero1.py:166``); ``FaultTolerantTrainer`` over a
  ``ParallelTrainer`` on each rank retries a ``raise`` fault.

In this process: the cases of ``tests/test_resilience.py`` on the
manager and the trainer (rotation, the torn-zip skip, a run SIGKILLed in
a checkpoint's commit — a jax-free subprocess — resuming from the intact
one, cursor resume, retry, rollback, escalation, driving
``ParallelWrapper``, the counters, the cursor's generator state); the
sharded format's integrity contracts (a missing COMMIT, a bit flip, a
missing shard file, incomplete coverage each raise naming it); and a
``FaultTolerantTrainer`` over a ``ParallelTrainer`` on ``gpt_tiny``:
rolled back past a NaN batch, and resumed by a fresh trainer from the
cursor, bit for bit the uninterrupted run.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import MeshContext as JMesh
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu.resilience import (
    CheckpointManager as JCheckpointManager,
)

from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
from deeplearning4j_tpu_torch.parallel.checkpoint import (
    RowShard, restore_sharded, restore_sharded_into, save_sharded,
    verify_sharded,
)
from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.resilience import (
    CheckpointError, CheckpointManager, DivergenceError, DivergenceSentinel,
    Fault, FaultInjected, FaultSchedule, FaultTolerantTrainer,
    TrainingCursor, faultinject,
)

P_RTOL, P_ATOL = 2e-4, 2e-5
BATCH = [[np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32),
          np.eye(3, dtype=np.float32)[
              np.random.default_rng(1).integers(0, 3, 16)]]]


def jax_mlp(seed=12345):
    return JNet(JNNC.builder().seed(seed).updater("adam", learning_rate=0.05)
                .weight_init("xavier").list()
                .layer(JDense(n_out=16, activation="relu"))
                .layer(JDense(n_out=16, activation="tanh"))
                .layer(JOutput(n_out=3, activation="softmax"))
                .set_input_type(JInputType.feed_forward(4)).build()).init()


def _jax_zero1_dir(root):
    """A JAX zero1 dp=2 run one step in, saved by the JAX manager."""
    jnet = jax_mlp()
    mesh = JMesh.create(n_data=2)
    JTrainer(jnet, mesh, weight_update_sharding="zero1").fit_batch(
        JDataSet(*BATCH[0]))
    JCheckpointManager(root, sharded=True, mesh_ctx=mesh,
                       weight_update_sharding="zero1").save(jnet)
    return jnet


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ft")
    jnet = _jax_zero1_dir(tmp / "jax")
    params = jax.tree.map(np.asarray, jax_mlp().params)
    cases = [
        dict(name="save", fn="save_zero",
             args=dict(ckpt_root=str(tmp / "port"), params=params,
                       batches=BATCH)),
        dict(name="restore_port", fn="restore_zero",
             args=dict(ckpt_root=str(tmp / "port"), batches=BATCH)),
        dict(name="restore_jax", fn="restore_zero",
             args=dict(ckpt_root=str(tmp / "jax"), batches=BATCH)),
        dict(name="torn", fn="torn_zero",
             args=dict(ckpt_root=str(tmp / "torn"), batches=BATCH)),
        dict(name="ft", fn="ft_parallel",
             args=dict(ckpt_root=str(tmp / "ft"),
                       batches=[[b[:8] for b in BATCH[0]]] * 5)),
    ]
    return tmp, jnet, W.run_group(cases, tmp / "group")


@pytest.fixture(autouse=True)
def _fresh_registry_and_schedule():
    prev = set_registry(MetricsRegistry())
    yield
    faultinject.clear()
    set_registry(prev)


def _jax_rows(jnet):
    """The JAX net's optax moments as (2, chunk) numpy views, by slot."""
    leaves = jax.tree_util.tree_flatten_with_path(jnet.opt_state)[0]
    out = {"mu": [], "nu": []}
    for path, leaf in leaves:
        key = jax.tree_util.keystr(path)
        for slot in out:
            if f".{slot}" in key:
                out[slot].append(np.asarray(leaf))
    return out


# ---------------------------------------------------------------------------
# world 2
# ---------------------------------------------------------------------------

def test_zero1_checkpoint_round_trips_bitwise_at_world_2(world2):
    _, _, group = world2
    for rank in (0, 1):
        saved = W.result(group, "save", rank)
        got = W.result(group, "restore_port", rank)
        assert got["restored"].tobytes() == saved["saved"].tobytes()
        assert got["count"] == saved["count"] == 1
        for slot in saved["rows"]:
            for a, b in zip(got["rows"][slot], saved["rows"][slot]):
                assert a.tobytes() == b.tobytes()
        assert np.float32(got["losses"][0]).tobytes() == \
            np.float32(saved["next_loss"]).tobytes()
        assert got["params"].tobytes() == saved["next_params"].tobytes()


def test_port_zero1_directory_restores_in_the_jax_package(world2):
    """The JAX manager restores the port's directory into a JAX zero1 net
    (``restore_sharded_into`` over the same leaf keys): the params, each
    rank's rows of mu and nu, and the counts, every leaf equal."""
    tmp, _, group = world2
    saved = [W.result(group, "save", r) for r in (0, 1)]
    jnet = jax_mlp(seed=777)
    mesh = JMesh.create(n_data=2)
    JTrainer(jnet, mesh, weight_update_sharding="zero1")
    cursor = JCheckpointManager(tmp / "port", sharded=True, mesh_ctx=mesh,
                                weight_update_sharding="zero1").restore(jnet)
    assert cursor.step == 1
    assert np.asarray(jnet.params_flat()).tobytes() == \
        saved[0]["saved"].tobytes()
    rows = _jax_rows(jnet)
    for slot in ("mu", "nu"):
        assert len(rows[slot]) == len(saved[0]["rows"][slot])
        for i, leaf in enumerate(rows[slot]):
            assert leaf.shape[0] == 2
            for r in (0, 1):
                assert leaf[r:r + 1].tobytes() == \
                    saved[r]["rows"][slot][i].tobytes()
    counts = [int(np.asarray(x)) for p, x in
              jax.tree_util.tree_flatten_with_path(jnet.opt_state)[0]
              if "count" in jax.tree_util.keystr(p)]
    assert counts == [1, 1]


def test_port_zero1_directory_restores_at_world_1(world2):
    """The world-2 directory in one process: refused without reshard;
    with it the moments come back whole, and the next step agrees with
    the world-2 run's."""
    tmp, _, group = world2
    saved = W.result(group, "save")
    net = W.build("mlp", seed=777)
    mesh = MeshContext.create(device="cpu")
    mgr = CheckpointManager(tmp / "port", sharded=True, mesh_ctx=mesh)
    with pytest.raises(CheckpointError, match="dp=2"):
        mgr.restore(net)
    assert mgr.restore(net, reshard=True).step == 1
    assert net.params_flat().tobytes() == saved["saved"].tobytes()
    loss = float(ParallelTrainer(net, mesh).fit_batch(
        W.datasets(BATCH)[0]))
    np.testing.assert_allclose(loss, saved["next_loss"], rtol=1e-5)
    np.testing.assert_allclose(net.params_flat(), saved["next_params"],
                               rtol=P_RTOL, atol=P_ATOL)


def test_jax_zero1_directory_restores_into_the_port_at_worlds_2_and_1(
        world2):
    tmp, jnet, group = world2
    want = np.asarray(jnet.params_flat())
    jrows = _jax_rows(jnet)
    for rank in (0, 1):
        got = W.result(group, "restore_jax", rank)
        assert got["restored"].tobytes() == want.tobytes()
        for slot in ("mu", "nu"):
            for mine, full in zip(got["rows"][slot], jrows[slot]):
                assert mine.tobytes() == full[rank:rank + 1].tobytes()
    net = W.build("mlp", seed=777)
    CheckpointManager(tmp / "jax", sharded=True).restore(net, reshard=True)
    assert net.params_flat().tobytes() == want.tobytes()
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    for slot in ("mu", "nu"):
        for t, full in zip(tree_leaves(net.opt_state[slot]), jrows[slot]):
            whole = full.reshape(-1)[:t.numel()].reshape(tuple(t.shape))
            assert t.numpy().tobytes() == whole.tobytes()
    assert net.opt_state["count"] == 1


def test_torn_sharded_save_is_skipped_at_world_2(world2):
    for rank in (0, 1):
        got = W.result(world2[2], "torn", rank)
        assert got["latest"] == got["good"] == 1


def test_ft_trainer_over_a_parallel_trainer_retries_at_world_2(world2):
    r0, r1 = (W.result(world2[2], "ft", r) for r in (0, 1))
    assert r0["iterations"] == r1["iterations"] == 5
    assert r0["params"].tobytes() == r1["params"].tobytes()
    assert r0["latest"] == 5 and r0["steps"] == [4, 5]


# ---------------------------------------------------------------------------
# the sharded format, in this process
# ---------------------------------------------------------------------------

def _params():
    return {"W": torch.from_numpy(np.random.default_rng(7).normal(
        size=(8, 4)).astype(np.float32))}


def test_sharded_missing_commit_marker(tmp_path):
    save_sharded(tmp_path / "ck", _params())
    (tmp_path / "ck" / "COMMIT").unlink()
    with pytest.raises(CheckpointError, match="COMMIT"):
        verify_sharded(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="COMMIT"):
        restore_sharded(tmp_path / "ck", None)


def test_sharded_v1_checkpoint_without_commit_still_restores(tmp_path):
    p = _params()
    save_sharded(tmp_path / "ck", p)
    (tmp_path / "ck" / "COMMIT").unlink()
    m = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    m["version"] = 1
    (tmp_path / "ck" / "manifest.json").write_text(json.dumps(m))
    np.testing.assert_array_equal(restore_sharded(tmp_path / "ck")["W"],
                                  p["W"].numpy())


def test_sharded_bitflip_and_missing_file_are_named(tmp_path):
    save_sharded(tmp_path / "ck", _params())
    shard = tmp_path / "ck" / "shards_p0.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(CheckpointError, match="shards_p0.npz"):
        verify_sharded(tmp_path / "ck")
    shard.unlink()
    with pytest.raises(CheckpointError, match="shards_p0.npz.*missing"):
        verify_sharded(tmp_path / "ck")


def test_sharded_incomplete_coverage_is_detected(tmp_path):
    """Rank 0's row of a 2-way leaf alone (rank 1's shard file never
    listed): the assembly refuses the hole."""
    row = RowShard(torch.ones(1, 3), rank=0, n=2)
    save_sharded(tmp_path / "ck", {"m": row})
    meta = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert meta["leaves"]["m"]["shape"] == [2, 3]
    assert meta["leaves"]["m"]["spec"] == ["data", None]
    with pytest.raises(IOError, match="coverage"):
        restore_sharded(tmp_path / "ck")


def test_sharded_restore_onto_a_mesh_gives_its_rank_rows(tmp_path):
    """With a mesh, leaves come back as tensors on its device; a leaf
    saved over the data axis at the mesh's width as this rank's row."""
    whole = torch.arange(6.0).reshape(1, 6)
    save_sharded(tmp_path / "ck", {"m": RowShard(whole, rank=0, n=1),
                                   "W": _params()["W"]},
                 MeshContext.create(device="cpu"))
    out = restore_sharded(tmp_path / "ck", MeshContext.create(device="cpu"))
    assert isinstance(out["W"], torch.Tensor)
    assert torch.equal(out["W"], _params()["W"])
    assert torch.equal(out["m"], whole)


def test_sharded_restore_into_keeps_the_structure(tmp_path):
    net = W.build("mlp")
    save_sharded(tmp_path / "ck", net.params)
    orig = net.params[0]["W"].clone()
    with torch.no_grad():
        net.params[0]["W"].add_(1.0)
    out = restore_sharded_into(tmp_path / "ck", net.params)
    assert isinstance(out, list) and isinstance(out[0], dict)
    assert torch.equal(out[0]["W"], orig)


# ---------------------------------------------------------------------------
# the manager and the fault-tolerant trainer (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def _net(seed=1):
    return W.build("mlp", hidden=8, seed=seed)


def _batches(n, b=6, seed=7):
    rng = np.random.default_rng(seed)
    return W.datasets([[rng.normal(size=(b, 4)).astype(np.float32),
                        np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]]
                       for _ in range(n)])


def _snapshot():
    return get_registry().snapshot("resilience_")


def test_manager_rotation_keeps_last_n(tmp_path):
    net = _net()
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for b in _batches(5):
        net.fit_batch(b)
        mgr.save(net)
    assert [i.step for i in mgr.checkpoints()] == [4, 5]
    assert mgr.latest_valid().step == 5


def test_latest_valid_skips_a_torn_checkpoint(tmp_path):
    net = _net()
    mgr = CheckpointManager(tmp_path, keep_last=3)
    net.fit_batch(_batches(1)[0])
    mgr.save(net)
    net.fit_batch(_batches(1, seed=8)[0])
    faultinject.set_schedule(FaultSchedule(
        [Fault("truncate_checkpoint", at_call=1, mode="torn")]))
    mgr.save(net)
    faultinject.clear()
    assert mgr.latest_valid().step == 1
    assert _snapshot()["resilience_invalid_checkpoints_total"] >= 1


def test_sigkill_mid_checkpoint_resumes_from_the_intact_one(tmp_path):
    """A jax-free process trains three checkpointed steps, then dies by
    SIGKILL inside the fourth checkpoint's commit: the directory's latest
    valid checkpoint is the third, and a fresh net resumes from it."""
    proc = subprocess.run(
        [sys.executable, str(W.ROOT / "tests" / "torch_parallel_worker.py"),
         "sigkill", str(tmp_path / "ck"), str(tmp_path / "intact.npy")],
        cwd=str(W.ROOT), env=dict(os.environ, PYTHONPATH=str(W.ROOT)),
        capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert list((tmp_path / "ck").glob("*.tmp")), "no torn stump"
    net = _net(seed=99)
    cursor = CheckpointManager(tmp_path / "ck", keep_last=3).restore(net)
    assert cursor is not None and net.iteration_count == 3
    assert net.params_flat().tobytes() == \
        np.load(tmp_path / "intact.npy").tobytes()
    net.fit_batch(_batches(1)[0])
    assert net.iteration_count == 4


def test_cursor_resume_mid_epoch(tmp_path):
    batches = _batches(4)
    net = _net()
    ft = FaultTolerantTrainer(net, CheckpointManager(tmp_path, keep_last=4),
                              checkpoint_every=1, max_retries=0)
    faultinject.set_schedule(FaultSchedule([Fault("raise", step=3)]))
    with pytest.raises(FaultInjected):
        ft.fit(batches, epochs=1)
    faultinject.clear()
    assert net.iteration_count == 2
    net2 = _net(seed=5)
    FaultTolerantTrainer(net2, CheckpointManager(tmp_path, keep_last=4)
                         ).fit(batches, epochs=1)
    assert net2.iteration_count == 4


def test_transient_fault_retried_with_backoff(tmp_path):
    net = _net()
    ft = FaultTolerantTrainer(net, CheckpointManager(tmp_path),
                              max_retries=3, backoff_base=0.001,
                              backoff_max=0.01)
    faultinject.set_schedule(FaultSchedule([Fault("raise", step=2)]))
    ft.fit(_batches(3), epochs=1)
    assert net.iteration_count == 3
    assert _snapshot()["resilience_retries_total"] == 1


def test_rollback_restores_and_rerandomizes(tmp_path):
    net = _net()
    mgr = CheckpointManager(tmp_path, keep_last=3)
    ft = FaultTolerantTrainer(net, mgr, checkpoint_every=1,
                              sentinel=DivergenceSentinel("rollback", lag=0))
    faultinject.set_schedule(FaultSchedule([Fault("nan", step=3)]))
    ft.fit(_batches(4), epochs=1)
    assert _snapshot()["resilience_rollbacks_total"] == 1
    assert ft._salt == 1
    assert np.isfinite(net.params_flat()).all()
    assert mgr.latest_valid().cursor.epoch == 1


def test_rollback_escalates_after_k_consecutive(tmp_path):
    net = _net()
    ft = FaultTolerantTrainer(net, CheckpointManager(tmp_path, keep_last=2),
                              sentinel=DivergenceSentinel("rollback", lag=0),
                              max_consecutive_rollbacks=2)
    bad = _batches(1)[0]
    bad.features = np.full_like(bad.features, np.nan)
    with pytest.raises(DivergenceError, match="consecutive rollbacks"):
        ft.fit([bad], epochs=1)
    assert _snapshot()["resilience_rollbacks_total"] == 3


def test_ft_trainer_drives_parallel_wrapper(tmp_path):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    net = _net()
    pw = ParallelWrapper(net, workers=2, device="cpu")
    ft = FaultTolerantTrainer(net, CheckpointManager(tmp_path), trainer=pw,
                              checkpoint_every=2)
    ft.fit(_batches(3, b=4), epochs=1)
    assert net.iteration_count == 3
    assert np.isfinite(net.params_flat()).all()
    assert CheckpointManager(tmp_path).latest_valid() is not None
    with pytest.raises(TypeError, match="fit_batch"):
        FaultTolerantTrainer(net, CheckpointManager(tmp_path),
                             trainer=object())


def test_cursor_order_and_reshuffled_tail(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=5)
    ft = FaultTolerantTrainer(_net(), mgr, resume=False)
    ft._save(epoch=0, next_pos=1, order=[2, 0, 1])
    info = mgr.latest_valid()
    assert info.cursor.extra["order"] == [2, 0, 1]
    assert FaultTolerantTrainer._cursor_order(info.cursor, 3) == [2, 0, 1]
    info.cursor.extra["order"] = [0, 0, 1]
    assert FaultTolerantTrainer._cursor_order(info.cursor, 3) == [0, 1, 2]
    ft._salt = 1
    out = ft._reshuffle_tail(list(range(10)), 4, epoch=0)
    assert out[:4] == [0, 1, 2, 3] and sorted(out[4:]) == list(range(4, 10))


def test_resilience_counters_render_for_the_metrics_endpoint(tmp_path):
    FaultTolerantTrainer(_net(), CheckpointManager(tmp_path),
                         sentinel=DivergenceSentinel("skip_batch"))
    text = get_registry().to_prometheus()
    for name in ("resilience_nonfinite_steps_total",
                 "resilience_skipped_batches_total",
                 "resilience_retries_total", "resilience_rollbacks_total",
                 "resilience_checkpoints_saved_total",
                 "resilience_invalid_checkpoints_total"):
        assert name in text


def test_cursor_round_trips_the_generator_and_reads_a_jax_cursor():
    net = _net()
    net.fit_batch(_batches(1)[0])
    cur = TrainingCursor.from_json(
        TrainingCursor.of(net, epoch=2, data_position=5).to_json())
    net2 = _net(seed=9)
    cur.apply(net2)
    assert net2.iteration_count == net.iteration_count
    assert net2.epoch_count == 2
    assert torch.equal(net2._rng.get_state(), net._rng.get_state())
    jax_cursor = TrainingCursor.from_json(json.dumps(
        {"version": 1, "epoch": 1, "step": 4, "data_position": 2,
         "rng_key": [0, 42], "topology": None, "extra": {}}))
    before = net2._rng.get_state().clone()
    jax_cursor.apply(net2)
    assert net2.iteration_count == 4
    assert torch.equal(net2._rng.get_state(), before)


def test_zip_save_of_zero_rows_is_refused(tmp_path):
    net = _net()
    net._zero_shards = (0, 2)
    with pytest.raises(ValueError, match="gather_opt_state"):
        CheckpointManager(tmp_path).save(net)


def test_ft_over_parallel_trainer_rolls_back_and_resumes_bitwise(tmp_path):
    """``gpt_tiny`` under a ParallelTrainer (world 1) and a sharded
    manager: a NaN batch under a rollback sentinel restores the last
    checkpoint; a run cut after 3 steps and resumed by a fresh trainer
    from its cursor equals the uninterrupted run bit for bit."""
    kw = dict(vocab_size=16, seq_len=8)
    rng = np.random.default_rng(4)
    eye = np.eye(16, dtype=np.float32)
    batches = []
    for _ in range(5):
        tok = rng.integers(0, 16, (4, 9))
        batches.append([eye[tok[:, :-1]], eye[tok[:, 1:]]])

    def run(root, n_batches, net=None, sentinel=None, max_retries=3):
        net = net or W.build("gpt", **kw)
        mesh = MeshContext.create(device="cpu")
        ft = FaultTolerantTrainer(
            net, CheckpointManager(root, sharded=True, mesh_ctx=mesh),
            trainer=ParallelTrainer(net, mesh), checkpoint_every=1,
            sentinel=sentinel, max_retries=max_retries)
        ft.fit(W.datasets(batches[:n_batches]), epochs=1)
        return net

    whole = run(tmp_path / "whole", 5)
    # a run that dies before its 4th step (no retry left) ...
    faultinject.set_schedule(FaultSchedule([Fault("raise", step=4)]))
    with pytest.raises(FaultInjected):
        run(tmp_path / "cut", 5, max_retries=0)
    faultinject.clear()
    # ... and a fresh net over the same directory resumes at its cursor
    resumed = run(tmp_path / "cut", 5, net=W.build("gpt", seed=7, **kw))
    assert resumed.iteration_count == 5
    assert resumed.params_flat().tobytes() == whole.params_flat().tobytes()
    faultinject.set_schedule(FaultSchedule([Fault("nan", step=2)]))
    net = run(tmp_path / "nan", 3,
              sentinel=DivergenceSentinel("rollback", lag=0))
    faultinject.clear()
    assert _snapshot()["resilience_rollbacks_total"] == 1
    assert np.isfinite(net.params_flat()).all()
    assert net.iteration_count == 3
