"""The port's ``ElasticTrainer`` across processes: gloo ranks on the CPU
(``torch_parallel_worker.run_elastic``), each joined through
``multihost.initialize(..., elastic=True)``, training the elastic MLP
under zero1 with a host fault armed on one rank. These cases are the
port's alone: the JAX package's own (``tests/test_multihost.py``) fail
here (ROADMAP C1). Held:

- ``kill_host``: rank 1 hard-exits at step 4 with ``KILL_HOST_EXIT_CODE``;
  rank 0 detects the loss, elects itself, resizes in process to world 1
  (its old group quarantined, the collective failure counted), reshard-
  restores the zero1 checkpoint and consumes the tail exactly once, its
  tail losses and params bitwise a clean world-1 ``ElasticTrainer``
  restart from the same checkpoint;
- ``kill_coordinator`` against a ``serve_coordination`` store: rank 0 dies,
  rank 1 elects itself at lease epoch 1 and resumes the same way;
- ``rejoin_host``: a sole host announces a replacement at step 3, admits
  it at the epoch boundary (``ElasticRestartRequired(grow=True)``), and
  the restarted two-rank group (rendezvous epoch 1) resumes epoch 1 at
  zero1, bitwise a clean world-2 restart from the same checkpoint;
- ``slow_host``: a 4 s straggle against a 1 s barrier window surfaces as
  ``elastic_barrier_timeouts_total >= 1`` on its peer, with no resize and
  no hang;
- a frozen host (``freeze``: rank 1 stops itself with SIGSTOP before step
  4, its sockets left open, so no connection reset reaches rank 0) on
  LeNet with batch norm: rank 0's step thread is left inside the batch
  norm's all-reduce on the old group, the heartbeats declare rank 1 dead,
  and the survivor resizes and resumes bitwise a clean world-1 restart,
  issuing no collective on the old group (one would raise, the group
  being quarantined, and fail the run).

Every spawned process is reaped on every path (``run_elastic``).
"""

import functools
import shutil
import socket

import numpy as np
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.resilience.elastic import (
    ElasticTrainer, read_lease,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (
    KILL_HOST_EXIT_CODE,
)

#: the trainer's windows: heartbeats every 0.1 s, stale after 2 s (room
#: for a loaded box), a 1 s step barrier
WINDOWS = dict(heartbeat_timeout_s=2.0, step_timeout_s=1.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_restart(ckpt, step, tmp, tag, kind="mlp"):
    """A clean world-1 ElasticTrainer (zero1 asked for, replicated at
    world 1) of ``W.elastic_net(kind)`` over a copy of ``ckpt`` holding
    the checkpoints up to ``step``: its trajectory and params."""
    ref = tmp / f"ref_{tag}"
    shutil.copytree(ckpt, ref, ignore=shutil.ignore_patterns("heartbeats"))
    for d in ref.glob("ckpt-*"):
        if int(d.name.split("-")[1]) > step:
            shutil.rmtree(d)
    trainer = ElasticTrainer(functools.partial(W.elastic_net, kind=kind),
                             ref, weight_update_sharding="zero1",
                             checkpoint_every=1, heartbeat_interval_s=0.1,
                             **WINDOWS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the ranks run: one summation order
    try:
        trainer.fit(W.elastic_batches(kind=kind), epochs=1)
    finally:
        torch.set_num_threads(threads)
        trainer.close()
        multihost.set_rendezvous_epoch(0)
    return trainer.trajectory, W.flat(trainer.net)


def _survivor_matches_clean_restart(rec, ckpt, tmp, tag, kind="mlp"):
    traj = rec["trajectory"]
    assert [e["index"] for e in traj if e["epoch"] == 0] == list(range(6))
    cut = rec["cursor_step"]
    assert cut is not None and 1 <= cut < 6
    ref_traj, ref_params = _clean_restart(ckpt, cut, tmp, tag, kind)
    tail = [e["loss"] for e in traj if e["step"] > cut]
    assert [e["step"] for e in ref_traj] == list(range(cut + 1, 7))
    assert tail == [e["loss"] for e in ref_traj]        # bit for bit
    assert rec["params"].tobytes() == ref_params.tobytes()


def test_kill_host_survivor_resizes_and_resumes_bitwise(tmp_path):
    spec = dict(tag="kill", ckpt=str(tmp_path / "ckpt"),
                fault=dict(kind="kill_host", step=4, victim=1), **WINDOWS)
    rcs, recs = W.run_elastic(spec, tmp_path, 2)
    assert rcs[1] == KILL_HOST_EXIT_CODE, recs[1]["log"]
    assert rcs[0] == 0, recs[0]["log"]
    r0 = recs[0]
    assert r0["world"] == [0] and r0["dp"] == 1 and r0["restart"] is None
    m = r0["metrics"]
    assert m["elastic_resizes_total"] == 1.0
    assert m["resilience_host_failures_total"] == 1.0
    assert m["elastic_reshard_restores_total"] == 1.0
    assert m["elastic_dp_width"] == 1.0 and m["elastic_epoch"] == 1.0
    assert r0["quarantined"] and r0["runtime_faults"] >= 1
    assert r0["topology"] == {"dp": 1, "weight_update_sharding": "off",
                              "process_count": 1, "rendezvous_epoch": 1}
    lease = read_lease(tmp_path / "ckpt" / "heartbeats")
    assert lease["epoch"] == 1 and lease["coordinator"] == 0
    assert lease["world"] == [0]
    _survivor_matches_clean_restart(r0, tmp_path / "ckpt", tmp_path,
                                    "kill")


def test_kill_coordinator_survivor_elects_itself_against_the_store(
        tmp_path):
    port = _free_port()
    store = W.spawn_coordination(port, 2)
    try:
        spec = dict(tag="coord", ckpt=str(tmp_path / "ckpt"),
                    host_service=False,
                    fault=dict(kind="kill_coordinator", step=4, victim=0),
                    **WINDOWS)
        rcs, recs = W.run_elastic(spec, tmp_path, 2,
                                  init_method=f"tcp://localhost:{port}")
    finally:
        W._reap([store])
    assert rcs[0] == KILL_HOST_EXIT_CODE, recs[0]["log"]
    assert rcs[1] == 0, recs[1]["log"]
    r1 = recs[1]
    assert r1["world"] == [1] and r1["dp"] == 1
    m = r1["metrics"]
    assert m["elastic_elections_total"] == 1.0
    assert m["elastic_resizes_total"] == 1.0
    assert m["elastic_epoch"] == 1.0
    lease = read_lease(tmp_path / "ckpt" / "heartbeats")
    assert lease["epoch"] == 1 and lease["coordinator"] == 1
    assert lease["world"] == [1]
    _survivor_matches_clean_restart(r1, tmp_path / "ckpt", tmp_path,
                                    "coord")


def test_rejoin_host_admitted_then_the_grown_group_resumes_bitwise(
        tmp_path):
    ckpt = tmp_path / "ckpt"
    rcs, recs = W.run_elastic(
        dict(tag="solo", ckpt=str(ckpt), epochs=2,
             fault=dict(kind="rejoin_host", step=3, victim=0, rank=1),
             **WINDOWS), tmp_path, 1)
    assert rcs == [0], recs[0]["log"]
    solo = recs[0]
    assert solo["restart"] == {"survivors": [0, 1], "coordinator": 0,
                               "epoch": 1, "grow": True}
    assert [e["index"] for e in solo["trajectory"]] == list(range(6))
    assert solo["metrics"]["elastic_scale_ups_total"] == 1.0
    assert solo["metrics"]["elastic_resizes_total"] == 0.0
    assert read_lease(ckpt / "heartbeats")["world"] == [0, 1]
    twin = tmp_path / "ckpt_twin"
    shutil.copytree(ckpt, twin)
    runs = []
    for tag, where in (("grown", ckpt), ("clean", twin)):
        rcs, recs = W.run_elastic(
            dict(tag=tag, ckpt=str(where), epochs=2, rendezvous_epoch=1,
                 **WINDOWS), tmp_path, 2)
        assert rcs == [0, 0], recs[0]["log"] + recs[1]["log"]
        runs.append(recs)
    grown, clean = runs
    for r in (0, 1):
        traj = grown[r]["trajectory"]
        assert [e["index"] for e in traj if e["epoch"] == 1] == \
            list(range(6))
        assert [e for e in traj if e["epoch"] == 0] == []
        assert grown[r]["dp"] == 2
        assert grown[r]["topology"]["weight_update_sharding"] == "zero1"
        assert grown[r]["topology"]["rendezvous_epoch"] == 1
        assert traj == clean[r]["trajectory"]          # bit for bit
        assert grown[r]["params"].tobytes() == \
            clean[r]["params"].tobytes()
    assert grown[0]["trajectory"] == grown[1]["trajectory"]


def test_slow_host_is_a_barrier_timeout_not_a_loss(tmp_path):
    spec = dict(tag="slow", ckpt=str(tmp_path / "ckpt"),
                fault=dict(kind="slow_host", step=3, victim=1,
                           duration=4.0), **WINDOWS)
    rcs, recs = W.run_elastic(spec, tmp_path, 2)
    assert rcs == [0, 0], recs[0]["log"] + recs[1]["log"]
    t0, t1 = recs[0]["trajectory"], recs[1]["trajectory"]
    assert t0 == t1 and [e["index"] for e in t0] == list(range(6))
    m0 = recs[0]["metrics"]
    assert m0["elastic_barrier_timeouts_total"] >= 1.0
    assert m0["elastic_resizes_total"] == 0.0
    assert m0["resilience_host_failures_total"] == 0.0
    assert recs[0]["dp"] == recs[1]["dp"] == 2
    assert np.array_equal(recs[0]["params"], recs[1]["params"])


def test_frozen_host_survivor_resizes_past_a_step_stuck_in_batch_norm(
        tmp_path):
    spec = dict(tag="freeze", ckpt=str(tmp_path / "ckpt"), net="lenet_bn",
                group_timeout_s=120.0,
                fault=dict(kind="freeze", step=4, victim=1), **WINDOWS)
    rcs, recs = W.run_elastic(spec, tmp_path, 2)
    assert rcs[0] == 0, recs[0]["log"]
    r0 = recs[0]
    assert r0["world"] == [0] and r0["dp"] == 1 and r0["restart"] is None
    assert r0["quarantined"]
    # the step-4 thread is still inside the batch norm's all-reduce on the
    # old group (its timeout is far off), and nothing failed on that group
    assert r0["abandoned_step_threads"] == 1
    assert r0["runtime_faults"] == 0
    m = r0["metrics"]
    assert m["elastic_resizes_total"] == 1.0
    assert m["resilience_host_failures_total"] == 1.0
    assert m["elastic_epoch"] == 1.0
    lease = read_lease(tmp_path / "ckpt" / "heartbeats")
    assert lease["epoch"] == 1 and lease["world"] == [0]
    _survivor_matches_clean_restart(r0, tmp_path / "ckpt", tmp_path,
                                    "freeze", kind="lenet_bn")
