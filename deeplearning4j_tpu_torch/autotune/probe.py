"""Measured probes: a few REAL steps per shortlisted candidate (the JAX
package's ``autotune/probe.py``).

The analytic model ranks; the probe decides. Each probe builds a FRESH
net from the model's own configuration on the net's device (same seed:
deterministic init), wraps it in a ``ParallelTrainer`` over the current
process group constructed from the candidate's ``trainer_kwargs()`` (the
recipe ``TunedConfig`` uses, so what is measured is what ships), runs the
warm-up steps (the first builds the kernels' libraries and fills the
allocator), then times ``steps`` steps closed by one
``torch.cuda.synchronize()``. The warm-up's seconds are reported apart
(``compile_s``), never inside the measurement.

Probes never touch the caller's net: parameter state, optimizer state
and random streams all belong to the throwaway probe net.
"""

from __future__ import annotations

import time

import numpy as np


def _one_hot_labels(rng, t, batch_size: int):
    """Deterministic one-hot labels matching one loss head's OUTPUT
    InputType: [B, K] for feed-forward heads, [B, T, K] per-timestep
    for recurrent heads (the LM case)."""
    k = max(2, int(t.size or 2))
    if t.kind == "rnn":
        T = int(t.timesteps or 1)
        return np.eye(k, dtype=np.float32)[
            rng.integers(0, k, (batch_size, T))]
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, batch_size)]


def synthesize_batch(conf, batch_size: int):
    """A deterministic synthetic batch for a shape-resolved config
    (seeded by the conf's own seed).

    MultiLayer configs: random-normal features in the input type's
    example shape, one-hot labels at the loss head's width.

    ComputationGraph configs: one feature array per
    ``network_inputs`` entry from the declared ``input_types``, one
    one-hot label array per ``network_outputs`` head from the RESOLVED
    output type — returned as a DataSet for single-input/single-output
    graphs (every trainer path accepts it) and a MultiDataSet
    otherwise, so ``autotune(ComputationGraph(...), ...)`` needs no
    explicit example batch."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, MultiDataSet,
    )
    rng = np.random.default_rng(int(conf.training.seed))
    if hasattr(conf, "nodes"):  # ComputationGraph configuration
        if not conf.input_types or not conf.resolved_types:
            raise ValueError(
                "cannot synthesize a probe batch: the graph config has "
                "no input_types (call set_input_types(...) at build, or "
                "pass batch= to autotune())")
        feats = []
        for name in conf.network_inputs:
            t = conf.input_types[name]
            feats.append(rng.normal(
                size=(batch_size,) + tuple(t.example_shape())
                ).astype(np.float32))
        labels = [_one_hot_labels(rng, conf.resolved_types[o], batch_size)
                  for o in conf.network_outputs]
        if len(feats) == 1 and len(labels) == 1:
            return DataSet(feats[0], labels[0])
        return MultiDataSet(feats, labels)
    input_type = getattr(conf, "input_type", None)
    if input_type is None:
        raise ValueError(
            "cannot synthesize a probe batch: the config has no "
            "input_type")
    feats = rng.normal(size=(batch_size,) + tuple(
        input_type.example_shape())).astype(np.float32)
    head = conf.layers[-1]
    n_out = int(getattr(head, "n_out", None) or 2)
    labels = np.eye(n_out, dtype=np.float32)[
        rng.integers(0, n_out, batch_size)]
    if input_type.kind == "rnn":
        # recurrent heads emit per-timestep distributions: [B, T, K]
        T = feats.shape[1] if feats.ndim == 3 else 1
        labels = np.eye(n_out, dtype=np.float32)[
            rng.integers(0, n_out, (batch_size, T))]
    return DataSet(feats, labels)


def build_probe_net(net):
    """A fresh, identically-seeded container from ``net``'s config on
    ``net``'s device: the throwaway model every probe trains instead of
    the caller's."""
    return type(net)(net.conf, device=net.device).init()


def world_size() -> int:
    """The default process group's world, 1 without a group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _sync(net) -> None:
    import torch
    if net.device.type == "cuda":
        torch.cuda.synchronize(net.device)


def measure_candidate(net, candidate, batch, steps: int = 3,
                      warmup: int = 1, devices=None) -> dict:
    """Run one candidate for real on the current process group and return
    {measured_step_s, compile_s, losses}.

    ``net`` is only the blueprint (config + container class + device);
    the trained state lives and dies here. ``candidate`` must be
    probeable (pp == 1: enforced by the tuner's shortlist) and span the
    group's world. ``devices`` is the JAX package's device list, unused:
    a rank is one device here."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer

    if not candidate.probeable:
        raise ValueError(f"candidate {candidate.slug()} is not probeable "
                         "(pp > 1 needs the pipeline trainer)")
    world = world_size()
    if candidate.devices != world:
        raise ValueError(
            f"candidate {candidate.slug()} spans {candidate.devices} "
            f"rank(s), but the process group has world {world}: a probe "
            "trains on the group it runs in")
    probe_net = build_probe_net(net)
    mesh = MeshContext.create(n_data=candidate.dp, n_model=candidate.tp,
                              n_seq=candidate.sp, device=net.device)
    trainer = ParallelTrainer(probe_net, mesh,
                              **candidate.trainer_kwargs())
    t0 = time.perf_counter()
    losses = []
    for _ in range(max(1, warmup)):
        losses.append(trainer.fit_batch(batch))
    _sync(probe_net)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(max(1, steps)):
        losses.append(trainer.fit_batch(batch))
    _sync(probe_net)
    dt = time.perf_counter() - t0
    return {"measured_step_s": dt / max(1, steps),
            "compile_s": compile_s,
            "losses": [float(l) for l in losses]}
