"""The port's ``ElasticTrainer`` and the elastic runtime's single-process
seams, held against the JAX package's (``tests/test_elastic.py``) on the
same scenarios, the port's net carrying the JAX net's weights
(``convert.params_from_jax``). The JAX trainer runs on the eight virtual
CPU devices (dp 8), the port at world 1 (no process group): the losses
agree at 1e-5, the params at rtol 2e-4 / atol 2e-5; lease records,
restart requests, consumed indices and counters agree exactly. Held:

- fit and exact cursor resume, the indivisible batch, the losses against
  the plain trainer (bitwise the port's own ``fit_batch``), recovery
  without a checkpoint;
- the lease protocol: the founding lease, election on the coordinator's
  death (elected and not), the sole survivor's in-process resize,
  scale-up at the epoch boundary (not at the last one, not without
  checkpoints), fencing (partition, the save seam), a newer lease
  followed, a restarted world adopting the lease's epoch, expired and
  stale join requests, the shuffle signature in the cursor;
- ``nn/updater``'s ``reshard_updater_state`` / ``updater_state_template``,
  the topology override, the topology record in cursor and manifest, a
  ZeRO checkpoint restored into another width's rows (the manager's route
  through ``reshard_updater_state``);
- a directory the JAX ``ElasticTrainer`` wrote (zero1 at dp 8, cut after
  its second step) resumed by the port at world 1: the tail consumed
  once, the losses within 1e-5 of the JAX trainer's own resumed run;
- ``ElasticTrainer.close`` joining the heartbeat and step threads.

The multi-process cases (kill, coordinator kill, rejoin, straggler) are
``tests/test_torch_elastic_multihost.py``.
"""

import json
import shutil
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn import updater as jupdater
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import MeshContext as JMesh
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel import multihost as jmultihost
from deeplearning4j_tpu.profiling.metrics import get_registry as jregistry
from deeplearning4j_tpu.resilience import elastic as jelastic
from deeplearning4j_tpu.resilience import faultinject as jfaultinject
from deeplearning4j_tpu.resilience.manager import (
    CheckpointManager as JManager,
)

from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import (
    ZeroLayout, reshard_updater_state, shard_updater_state, tree_leaves,
    updater_state_template,
)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.checkpoint import read_topology
from deeplearning4j_tpu_torch.parallel.mesh import (
    MeshContext, zero1_shard_leaf,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.resilience import elastic, faultinject
from deeplearning4j_tpu_torch.resilience.manager import CheckpointManager

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 2e-4, 2e-5


# ---------------------------------------------------------------------------
# the two packages' nets, data and modules
# ---------------------------------------------------------------------------

def _jnet():
    return JNet(JNNC.builder().seed(7).updater("adam").learning_rate(0.05)
                .list()
                .layer(JDense(n_out=8, activation="relu"))
                .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(JInputType.feed_forward(6)).build()).init()


def _conf():
    return (NeuralNetConfiguration.builder().seed(7).updater("adam")
            .learning_rate(0.05).list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


_JPARAMS = jax.tree.map(np.asarray, _jnet().params)


def _pnet():
    """The port's net on the CPU, with the JAX net's weights."""
    conf = _conf()
    return MultiLayerNetwork(conf, device="cpu").init(
        params_from_jax(conf, _JPARAMS))


def _arrays(n, rows=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


class _Shuffled(list):
    """Batches announcing a shuffle identity (the input pipeline's
    ``shuffle_signature``)."""

    def __init__(self, batches, seed):
        super().__init__(batches)
        self.seed = seed

    def shuffle_signature(self):
        return {"kind": "windowed_shuffle", "seed": self.seed, "window": 3}


PKGS = {
    "jax": SimpleNamespace(E=jelastic, mh=jmultihost, fi=jfaultinject,
                           factory=_jnet, ds=JDataSet, reg=jregistry),
    "port": SimpleNamespace(E=elastic, mh=multihost, fi=faultinject,
                            factory=_pnet, ds=DataSet, reg=get_registry),
}


def _batches(pkg, n, rows=8, seed=0):
    return [pkg.ds(*a) for a in _arrays(n, rows, seed)]


def _trainer(pkg, where, **kw):
    kw.setdefault("step_timeout_s", 30.0)
    return pkg.E.ElasticTrainer(pkg.factory, where, **kw)


def _snap(pkg):
    reg = pkg.reg()
    return dict(reg.snapshot("elastic_"), **reg.snapshot("resilience_host"))


def _delta(before, after, key):
    return after.get(key, 0.0) - before.get(key, 0.0)


@pytest.fixture(autouse=True)
def _clean_runtime():
    yield
    for pkg in PKGS.values():
        pkg.fi.clear()
        pkg.mh.set_rendezvous_epoch(0)
        pkg.mh.clear_topology_override()


def _both(scenario, tmp_path):
    """``scenario(pkg, directory)`` run on each package."""
    return {name: scenario(pkg, tmp_path / name)
            for name, pkg in PKGS.items()}


def _lease(pkg, trainer):
    lease = pkg.E.read_lease(trainer.heartbeat_dir)
    return None if lease is None else {k: lease[k] for k in (
        "epoch", "coordinator", "world", "pending")}


def _restart(e):
    return dict(survivors=e.survivors, dead=e.dead,
                coordinator=e.coordinator, epoch=e.epoch, grow=e.grow)


# ---------------------------------------------------------------------------
# fit, resume, losses
# ---------------------------------------------------------------------------

def test_elastic_trainer_fit_and_exact_cursor_resume(tmp_path):
    """A second trainer over the same directory resumes at the cursor:
    the same epoch count replays nothing, one more consumes exactly the
    new epoch."""
    def scenario(pkg, d):
        batches = _batches(pkg, 4)
        first = _trainer(pkg, d, checkpoint_every=1)
        try:
            first.fit(batches, epochs=1)
        finally:
            first.close()
        second = _trainer(pkg, d, checkpoint_every=1)
        try:
            second.fit(batches, epochs=1)
            replayed = list(second.trajectory)
            second.fit(batches, epochs=2)
        finally:
            second.close()
        return dict(first=first.consumed_indices(0),
                    losses=[e["loss"] for e in first.trajectory],
                    replayed=replayed, second=second.consumed_indices(1),
                    iterations=second.net.iteration_count)
    got = _both(scenario, tmp_path)
    np.testing.assert_allclose(got["port"].pop("losses"),
                               got["jax"].pop("losses"), rtol=LOSS_RTOL)
    assert got["port"] == got["jax"] == dict(
        first=[0, 1, 2, 3], replayed=[], second=[0, 1, 2, 3],
        iterations=8)


def test_elastic_trainer_indivisible_batch_is_clear_error(tmp_path):
    """A batch the surviving width cannot split is refused before its
    step: the JAX trainer's 9 rows over dp 8; the port's 9 rows over
    world 1 and gradient accumulation 2."""
    for name, pkg in PKGS.items():
        kw = {"gradient_accumulation": 2} if name == "port" else {}
        trainer = _trainer(pkg, tmp_path / name, checkpoint_every=0, **kw)
        try:
            with pytest.raises(pkg.E.ElasticError, match="not divisible"):
                trainer.fit(_batches(pkg, 1, rows=9), epochs=1)
            assert trainer.trajectory == []
        finally:
            trainer.close()


def test_elastic_trainer_losses_match_plain_trainer(tmp_path):
    """No faults: the port's trainer at world 1 against the JAX trainer
    at dp 8 on the same batches, and bit for bit the port net's own
    ``fit_batch``."""
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=1)
        try:
            trainer.fit(_batches(pkg, 3), epochs=1)
        finally:
            trainer.close()
        return ([e["loss"] for e in trainer.trajectory],
                np.asarray(trainer.net.params_flat()))
    got = _both(scenario, tmp_path)
    np.testing.assert_allclose(got["port"][0], got["jax"][0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=P_RTOL,
                               atol=P_ATOL)
    plain = _pnet()
    want = [float(plain.fit_batch(b)) for b in _batches(PKGS["port"], 3)]
    assert got["port"][0] == want
    assert got["port"][1].tobytes() == plain.params_flat().tobytes()
    jnet = _jnet()
    jt = JTrainer(jnet, JMesh.create(n_data=8, n_model=1))
    jwant = [float(jt.fit_batch(b)) for b in _batches(PKGS["jax"], 3)]
    np.testing.assert_array_equal(np.float64(got["jax"][0]),
                                  np.float64(jwant))


def test_recovery_without_checkpoint_clears_trajectory(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=0, resume=True)
        try:
            trainer.trajectory = [{"step": 1, "epoch": 0, "index": 0,
                                   "loss": 1.0}]
            trainer._bootstrap()   # an empty directory: no cursor
            return trainer.trajectory
        finally:
            trainer.close()
    assert _both(scenario, tmp_path) == {"jax": [], "port": []}


# ---------------------------------------------------------------------------
# the lease protocol
# ---------------------------------------------------------------------------

def test_initial_boot_founds_epoch0_lease(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=0)
        try:
            return _lease(pkg, trainer), trainer.rdv_epoch
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (
        {"epoch": 0, "coordinator": 0, "world": [0], "pending": []}, 0)


def test_election_on_coordinator_death_lowest_survivor_takes_lease(
        tmp_path):
    """A world of 4 loses rank 0: this process, rank 1, the lowest
    survivor, writes the epoch-1 lease and, with more survivors, asks for
    a restart."""
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=0)
        before = _snap(pkg)
        try:
            trainer._world, trainer._rank = [0, 1, 2, 3], 1
            with pytest.raises(pkg.E.ElasticRestartRequired) as ei:
                trainer._on_hosts_lost(pkg.E._HostsLost([0], "step 5"))
            after = _snap(pkg)
            return (_restart(ei.value), _lease(pkg, trainer),
                    _delta(before, after, "elastic_elections_total"),
                    _delta(before, after, "resilience_host_failures_total"))
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (
        dict(survivors=[1, 2, 3], dead=[0], coordinator=1, epoch=1,
             grow=False),
        {"epoch": 1, "coordinator": 1, "world": [1, 2, 3], "pending": []},
        1.0, 1.0)


def test_election_non_elected_survivor_does_not_write_lease(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=0)
        try:
            boot = _lease(pkg, trainer)
            trainer._world, trainer._rank = [0, 1, 2, 3], 2
            with pytest.raises(pkg.E.ElasticRestartRequired) as ei:
                trainer._on_hosts_lost(pkg.E._HostsLost([0], "step 5"))
            return (ei.value.coordinator, ei.value.epoch,
                    _lease(pkg, trainer) == boot)
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (1, 1, True)


def test_sole_survivor_of_coordinator_death_continues_in_process(tmp_path):
    """World [0, 1] loses rank 0: rank 1 elects itself, takes the epoch-1
    lease, rebuilds in process, and its checkpoints carry epoch 1."""
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=1)
        before = _snap(pkg)
        try:
            trainer._world, trainer._rank = [0, 1], 1
            trainer._on_hosts_lost(pkg.E._HostsLost([0], "step 2"))
            after = _snap(pkg)
            return (trainer.world, trainer.rdv_epoch, _lease(pkg, trainer),
                    _delta(before, after, "elastic_elections_total"),
                    _delta(before, after, "elastic_resizes_total"),
                    trainer.manager.topology()["rendezvous_epoch"],
                    trainer.dp_width >= 1)
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (
        [1], 1, {"epoch": 1, "coordinator": 1, "world": [1],
                 "pending": []}, 1.0, 1.0, 1, True)


def test_scale_up_admission_at_epoch_boundary(tmp_path):
    """A ``rejoin_host`` fault announces rank 5 at step 2; the lease
    records it at that step's checkpoint and the epoch boundary admits
    it: a grow restart request, the lease over the grown world, the join
    file consumed, the boundary checkpoint there to resume from."""
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=1)
        before = _snap(pkg)
        pkg.fi.set_schedule(pkg.fi.FaultSchedule(
            [pkg.fi.Fault(kind="rejoin_host", step=2, rank=5)]))
        try:
            with pytest.raises(pkg.E.ElasticRestartRequired) as ei:
                trainer.fit(_batches(pkg, 3), epochs=2)
            info = trainer.manager.latest_valid()
            return dict(
                restart=_restart(ei.value),
                consumed=trainer.consumed_indices(0),
                losses=[e["loss"] for e in trainer.trajectory],
                cursor=(info.cursor.epoch, info.cursor.data_position),
                lease=_lease(pkg, trainer),
                joins=pkg.E.pending_join_ranks(trainer.heartbeat_dir),
                scale_ups=_delta(before, _snap(pkg),
                                 "elastic_scale_ups_total"))
        finally:
            pkg.fi.clear()
            trainer.close()
    got = _both(scenario, tmp_path)
    np.testing.assert_allclose(got["port"].pop("losses"),
                               got["jax"].pop("losses"), rtol=LOSS_RTOL)
    assert got["port"] == got["jax"] == dict(
        restart=dict(survivors=[0, 5], dead=[], coordinator=0, epoch=1,
                     grow=True),
        consumed=[0, 1, 2], cursor=(1, 0),
        lease={"epoch": 1, "coordinator": 0, "world": [0, 5],
               "pending": []},
        joins=[], scale_ups=1.0)


def test_no_scale_up_at_the_final_epoch_boundary(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=1)
        pkg.fi.set_schedule(pkg.fi.FaultSchedule(
            [pkg.fi.Fault(kind="rejoin_host", step=2, rank=5)]))
        try:
            trainer.fit(_batches(pkg, 3), epochs=1)
            return (trainer.consumed_indices(0),
                    pkg.E.pending_join_ranks(trainer.heartbeat_dir),
                    _lease(pkg, trainer))
        finally:
            pkg.fi.clear()
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (
        [0, 1, 2], [5],
        {"epoch": 0, "coordinator": 0, "world": [0], "pending": [5]})


def test_scale_up_needs_checkpointing(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=0)
        pkg.fi.set_schedule(pkg.fi.FaultSchedule(
            [pkg.fi.Fault(kind="rejoin_host", step=1, rank=3)]))
        try:
            trainer.fit(_batches(pkg, 2), epochs=2)
            return (trainer.consumed_indices(0),
                    trainer.consumed_indices(1),
                    pkg.E.pending_join_ranks(trainer.heartbeat_dir),
                    (_lease(pkg, trainer) or {}).get("pending", []))
        finally:
            pkg.fi.clear()
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == ([0, 1], [0, 1], [3], [])


def test_partition_host_self_fences_and_never_commits(tmp_path):
    """``partition_host`` stops this host's beats at step 2; a slow step 3
    carries its own staleness past the timeout: ``ElasticFenced`` before
    another step, and no checkpoint past step 2."""
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=1,
                           heartbeat_interval_s=0.05,
                           heartbeat_timeout_s=0.4)
        before = _snap(pkg)
        pkg.fi.set_schedule(pkg.fi.FaultSchedule([
            pkg.fi.Fault(kind="partition_host", step=2, duration=0.0),
            pkg.fi.Fault(kind="slow_host", step=3, duration=0.8)]))
        try:
            trainer._world = [0, 1]   # a peer exists: fencing arms
            with pytest.raises(pkg.E.ElasticFenced, match="self-fencing"):
                trainer.fit(_batches(pkg, 5), epochs=1)
            steps = [i.step for i in trainer.manager.checkpoints()]
            return (_delta(before, _snap(pkg), "elastic_fenced_total")
                    >= 1.0, bool(steps) and max(steps) <= 2,
                    pkg.E.read_heartbeat_ages(trainer.heartbeat_dir)[0]
                    >= 0.4)
        finally:
            pkg.fi.clear()
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (True, True, True)


def test_save_is_fenced_directly(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=1,
                           heartbeat_timeout_s=0.2)
        try:
            trainer._world = [0, 1]
            trainer._hb._last_written = time.monotonic() - 10.0
            n = len(trainer.manager.checkpoints())
            with pytest.raises(pkg.E.ElasticFenced):
                trainer._save(epoch=0, next_pos=1)
            return len(trainer.manager.checkpoints()) == n
        finally:
            trainer.close()
    assert _both(scenario, tmp_path) == {"jax": True, "port": True}


def test_newer_lease_is_followed_not_overridden(tmp_path):
    def scenario(pkg, d):
        trainer = _trainer(pkg, d, checkpoint_every=0)
        try:
            pkg.E.write_lease(trainer.heartbeat_dir, 2, [0, 1], 0)
            trainer._world = [0, 1]
            with pytest.raises(pkg.E.ElasticRestartRequired) as ei:
                trainer._on_hosts_lost(pkg.E._HostsLost([1], "step 3"))
            followed = _restart(ei.value)
            pkg.E.write_lease(trainer.heartbeat_dir, 3, [1, 2], 1)
            trainer.rdv_epoch, trainer._world = 2, [0, 1, 2]
            with pytest.raises(pkg.E.ElasticFenced,
                               match="re-formed without"):
                trainer._on_hosts_lost(pkg.E._HostsLost([1], "step 4"))
            return followed
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == dict(
        survivors=[0, 1], dead=[], coordinator=0, epoch=2, grow=False)


def test_restart_adopts_lease_epoch_over_renumbered_world(tmp_path):
    def scenario(pkg, d):
        pkg.E.write_lease(d / "heartbeats", 2, [1, 3], 1)
        trainer = _trainer(pkg, d, checkpoint_every=0)
        try:
            return (trainer.rdv_epoch, _lease(pkg, trainer),
                    trainer.manager.topology()["rendezvous_epoch"])
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (
        2, {"epoch": 2, "coordinator": 0, "world": [0], "pending": []}, 2)


def test_expired_join_request_not_snapshotted_into_lease(tmp_path):
    def scenario(pkg, d):
        (d / "heartbeats").mkdir(parents=True)
        (d / "heartbeats" / "join_p7.json").write_text(
            json.dumps({"rank": 7, "time": time.time() - 3600}))
        trainer = _trainer(pkg, d, checkpoint_every=1)
        try:
            boot = _lease(pkg, trainer)["pending"]
            trainer.fit(_batches(pkg, 2), epochs=2)
            return (boot, trainer.consumed_indices(1),
                    _lease(pkg, trainer)["pending"])
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == ([], [0, 1], [])


def test_stale_join_file_cannot_bypass_checkpoint_gate_at_boot(tmp_path):
    def scenario(pkg, d):
        pkg.E.request_join(d / "heartbeats", 7)
        trainer = _trainer(pkg, d, checkpoint_every=0)
        try:
            boot = _lease(pkg, trainer)["pending"]
            trainer.fit(_batches(pkg, 2), epochs=1)
            return boot, trainer.consumed_indices(0)
        finally:
            trainer.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == ([], [0, 1])


def test_cursor_records_shuffle_signature_and_rejects_mismatch(tmp_path):
    """The data's shuffle identity rides in the cursor; a resume against
    another one raises before any step; the matching one resumes."""
    def scenario(pkg, d):
        batches = _batches(pkg, 4)
        first = _trainer(pkg, d, checkpoint_every=1)
        try:
            first.fit(_Shuffled(batches, 11), epochs=1)
            recorded = first.manager.latest_valid().cursor.extra["input"]
        finally:
            first.close()
        second = _trainer(pkg, d, checkpoint_every=1)
        try:
            with pytest.raises(pkg.E.ElasticError, match="re-randomize"):
                second.fit(_Shuffled(batches, 99), epochs=1)
            second.fit(_Shuffled(batches, 11), epochs=1)
            return recorded, second.trajectory
        finally:
            second.close()
    got = _both(scenario, tmp_path)
    assert got["port"] == got["jax"] == (
        {"kind": "windowed_shuffle", "seed": 11, "window": 3}, [])


def test_unshuffled_cursor_rejects_shuffled_resume(tmp_path):
    def scenario(pkg, d):
        batches = _batches(pkg, 4)
        first = _trainer(pkg, d, checkpoint_every=1)
        try:
            first.fit(batches, epochs=1)
        finally:
            first.close()
        second = _trainer(pkg, d, checkpoint_every=1)
        try:
            with pytest.raises(pkg.E.ElasticError, match="re-randomize"):
                second.fit(_Shuffled(batches, 11), epochs=2)
            return second.trajectory
        finally:
            second.close()
    assert _both(scenario, tmp_path) == {"jax": [], "port": []}


# ---------------------------------------------------------------------------
# reshard helpers, topology
# ---------------------------------------------------------------------------

def _trained_port_net(steps=2):
    net = _pnet()
    for b in _batches(PKGS["port"], steps):
        net.fit_batch(b)
    return net


def _mesh(world, rank):
    return MeshContext(world=world, rank=rank, device=torch.device("cpu"))


def _whole_moments(opt_state):
    return {k: [t.clone() for t in tree_leaves(v)]
            for k, v in opt_state.items() if k != "count"}


def test_reshard_updater_state_roundtrip():
    """Every rank's rows of a (4, chunk) layout (what a checkpoint
    holds) re-laid at width 2 with no collective: each rank's row is
    (1, chunk'), and the two rows together give back the whole moments
    bit for bit."""
    net = _trained_port_net()
    whole = _whole_moments(net.opt_state)
    four = {"count": net.opt_state["count"]}
    for k, v in net.opt_state.items():
        if k != "count":
            four[k] = [zero1_shard_leaf(t, 4) for t in tree_leaves(v)]
    template = ZeroLayout(next(v for k, v in net.opt_state.items()
                               if k != "count"), 4, 0)
    rows = {}
    for rank in (0, 1):
        out, tpl = reshard_updater_state(four, template, _mesh(2, rank))
        assert tpl.n == 2 and tpl.rank == rank
        for leaf in (t for k, v in out.items() if k != "count"
                     for t in tree_leaves(v)):
            assert leaf.shape[0] == 1
        rows[rank] = out
    for k in whole:
        row = [torch.cat([t.reshape(-1) for t in tree_leaves(rows[r][k])])
               for r in (0, 1)]
        back = tpl.whole_leaves(torch.cat(row))
        assert len(back) == len(whole[k])
        for a, b in zip(back, whole[k]):
            assert torch.equal(a, b)


def test_updater_state_template_describes_replicated_state():
    """Like the JAX template (a shape per shardable leaf), the port's
    describes every moment leaf's whole shape, one row wide."""
    net = _pnet()
    tpl = updater_state_template(net.opt_state)
    slots = [k for k in net.opt_state if k != "count"]
    assert tpl.n == 1 and tpl.rank == 0
    for k in slots:
        assert tpl.shapes == [tuple(t.shape)
                              for t in tree_leaves(net.opt_state[k])]
    # the JAX template describes every moment leaf of every slot
    jdescs = [d for d in jax.tree_util.tree_leaves(
        jupdater.updater_state_template(_jnet().opt_state),
        is_leaf=lambda x: x is None) if d is not None]
    assert sorted(tuple(d.shape) for d in jdescs) == sorted(
        s for _ in slots for s in tpl.shapes)
    assert updater_state_template({"count": 0}) is None


def test_topology_override_changes_batch_slice_and_save_world(tmp_path):
    """Both packages: the override sets the effective world and the batch
    slice and refuses a rank outside it; the port's sharded writer then
    records the surviving world, and a mesh of several survivors is a
    restart, not an in-process re-form."""
    for mh in (jmultihost, multihost):
        mh.set_topology_override(1, 0)
        try:
            assert mh.effective_process_count() == 1
            assert mh.effective_process_index() == 0
            assert mh.local_batch_slice(16) == slice(0, 16)
        finally:
            mh.clear_topology_override()
        with pytest.raises(ValueError):
            mh.set_topology_override(2, 5)
    multihost.set_topology_override(1, 0)
    try:
        net = _pnet()
        mesh = MeshContext.create(device="cpu")
        assert (mesh.world, mesh.distributed) == (1, False)
        path = CheckpointManager(tmp_path, sharded=True,
                                 mesh_ctx=mesh).save(net)
        assert json.loads((path / "COMMIT").read_text())[
            "process_count"] == 1
    finally:
        multihost.clear_topology_override()
    multihost.set_topology_override(2, 1)
    try:
        assert multihost.local_batch_slice(16) == slice(8, 16)
        with pytest.raises(ValueError, match="restart"):
            MeshContext.create(device="cpu")
    finally:
        multihost.clear_topology_override()


def test_topology_recorded_in_cursor_and_manifest(tmp_path):
    """The record carries the rendezvous epoch (here 3) in the cursor and
    in the manifest, as the JAX package's does; the port reads a
    JAX-written record to the same keys."""
    multihost.set_rendezvous_epoch(3)
    mesh = MeshContext.create(device="cpu")
    mgr = CheckpointManager(tmp_path / "port", sharded=True, mesh_ctx=mesh)
    mgr.save(_trained_port_net(1))
    info = mgr.latest_valid()
    assert info.cursor.topology == {"dp": 1, "weight_update_sharding": "off",
                                    "process_count": 1,
                                    "rendezvous_epoch": 3}
    assert read_topology(info.path) == info.cursor.topology
    jnet = _jnet()
    jmesh = JMesh.create(n_data=4, n_model=1, devices=jax.devices()[:4])
    JTrainer(jnet, jmesh, weight_update_sharding="zero1").fit_batch(
        _batches(PKGS["jax"], 1)[0])
    JManager(tmp_path / "jax", sharded=True, mesh_ctx=jmesh,
             weight_update_sharding="zero1").save(jnet)
    jinfo = CheckpointManager(tmp_path / "jax", sharded=True,
                              mesh_ctx=mesh).latest_valid()
    assert jinfo.cursor.topology == read_topology(jinfo.path) == {
        "dp": 4, "weight_update_sharding": "zero1", "process_count": 1,
        "rendezvous_epoch": 0}


def test_zero_checkpoint_restores_into_another_widths_rows(tmp_path):
    """A JAX zero1 checkpoint cut at dp 4, restored with ``reshard=True``
    into nets whose moments are rank 0's and rank 1's rows at width 2
    (the manager's route through ``reshard_updater_state``): the two
    ranks' rows are the whole moments a restore into whole tensors
    gives, bit for bit, and the params and count come back too."""
    jnet = _jnet()
    jmesh = JMesh.create(n_data=4, n_model=1, devices=jax.devices()[:4])
    jt = JTrainer(jnet, jmesh, weight_update_sharding="zero1")
    for b in _batches(PKGS["jax"], 3):
        jt.fit_batch(b)
    JManager(tmp_path, sharded=True, mesh_ctx=jmesh,
             weight_update_sharding="zero1").save(jnet)
    whole_net = _pnet()
    CheckpointManager(tmp_path, sharded=True,
                      mesh_ctx=MeshContext.create(device="cpu")).restore(
        whole_net, reshard=True)
    rows, layout = {}, None
    for rank in (0, 1):
        net, mesh = _pnet(), _mesh(2, rank)
        net.opt_state, layout = shard_updater_state(net.opt_state, mesh)
        net._zero_shards = (rank, 2)
        cursor = CheckpointManager(
            tmp_path, sharded=True, mesh_ctx=mesh,
            weight_update_sharding="zero1").restore(net, reshard=True)
        assert cursor.step == 3
        assert net.params_flat().tobytes() == \
            whole_net.params_flat().tobytes()
        assert int(net.opt_state["count"]) == int(
            whole_net.opt_state["count"])
        rows[rank] = net.opt_state
    for k, v in _whole_moments(whole_net.opt_state).items():
        gathered = torch.cat([torch.cat([t.reshape(-1) for t in
                                         tree_leaves(rows[r][k])])
                              for r in (0, 1)])
        for a, b in zip(layout.whole_leaves(gathered), v):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# a JAX-written directory resumed by the port
# ---------------------------------------------------------------------------

def test_jax_written_zero1_directory_resumes_in_the_port(tmp_path):
    """The JAX trainer (zero1, dp 8) is cut after its second step; the
    port resumes a copy of its directory at world 1 and the JAX trainer
    resumes the original: both consume the tail [2, 3] once, the losses
    within 1e-5 and the params within 2e-4 / 2e-5."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = jelastic.ElasticTrainer(_jnet, jdir, weight_update_sharding="zero1",
                                 checkpoint_every=1, step_timeout_s=30.0)
    fit_batch, calls = jt.trainer.fit_batch, []

    def cut(batch):
        calls.append(1)
        if len(calls) == 3:
            raise jfaultinject.FaultInjected("cut after step 2")
        return fit_batch(batch)
    jt.trainer.fit_batch = cut
    try:
        with pytest.raises(jfaultinject.FaultInjected):
            jt.fit(_batches(PKGS["jax"], 4), epochs=1)
    finally:
        jt.close()
    assert jt.consumed_indices(0) == [0, 1]
    shutil.copytree(jdir, pdir)
    resumed = {}
    for name, d in (("jax", jdir), ("port", pdir)):
        pkg = PKGS[name]
        trainer = pkg.E.ElasticTrainer(pkg.factory, d,
                                       weight_update_sharding="zero1",
                                       checkpoint_every=1,
                                       step_timeout_s=30.0)
        try:
            trainer.fit(_batches(pkg, 4), epochs=1)
        finally:
            trainer.close()
        resumed[name] = trainer
    port, jax_ = resumed["port"], resumed["jax"]
    assert port.consumed_indices(0) == jax_.consumed_indices(0) == [2, 3]
    assert [e["step"] for e in port.trajectory] == [3, 4]
    np.testing.assert_allclose([e["loss"] for e in port.trajectory],
                               [e["loss"] for e in jax_.trajectory],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(port.net.params_flat(),
                               np.asarray(jax_.net.params_flat()),
                               rtol=P_RTOL, atol=P_ATOL)
    assert port.dp_width == 1 and port.net.iteration_count == 4


# ---------------------------------------------------------------------------
# teardown
# ---------------------------------------------------------------------------

def test_close_joins_the_heartbeat_and_step_threads(tmp_path):
    baseline = {t.ident for t in threading.enumerate()}
    trainer = _trainer(PKGS["port"], tmp_path, checkpoint_every=1)
    trainer.fit(_batches(PKGS["port"], 3), epochs=1)
    assert trainer._step_threads
    trainer.close()
    assert trainer._hb._thread is None and trainer._step_threads == []
    deadline = time.monotonic() + 5
    while ({t.ident for t in threading.enumerate()} - baseline
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not {t.ident for t in threading.enumerate()} - baseline
