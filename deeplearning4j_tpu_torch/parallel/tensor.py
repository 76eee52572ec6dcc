"""The model and sequence axes inside a training step: what the
containers' forward walks and the layers do while ``ParallelTrainer``
runs a step on a mesh with a ``model`` or ``sp`` axis (inside its
``mesh.sequence_parallel_scope``). The JAX package annotates shardings
and GSPMD partitions the step; the port writes each rank's part out.

The model axis (tensor parallelism). While the trainer is attached, a
leaf ``MeshContext.param_spec`` shards holds this rank's columns (the
net's ``_model_shards`` records which). The Dense family, the output
layers and ``SelfAttentionLayer`` (when its heads divide by the axis)
consume theirs column-parallel (:func:`column_linear`): the input passes
``copy_to_model`` (its gradient all-reduced over the axis), the product
runs on this rank's columns, and ``gather_model`` puts the whole
activation on every model rank; a replicated bias is added after the
gather, so its gradient is whole on every rank. Every other sharded leaf
(an LSTM's ``W`` / ``RW``, a convolution's kernel, the position table,
the tied head's embedding) is gathered whole on use
(:func:`layer_params`).

The sequence axis. A batch whose T divides the axis is split on T: the
walks mark the input series as this rank's time steps, a layer that
works token by token (``sequence_local``) runs on them as it is, the
attention layer runs as a ring, the positional embedding adds its
shard's positions (``seq_shard``), and any other layer sees the whole
sequence (``gather_seq`` before, its slice taken after when its output
keeps that T). A head's loss on this rank's tokens is its share of the
global loss; a head on a whole (replicated) input, the L1/L2 penalty and
the auxiliary losses count ``1 / n_seq`` on each sp rank, so the sum over
the sp ranks, which the trainer's reduction takes, counts each once.

Outside a sharded step a net that holds column shards refuses to run:
``ParallelTrainer.gather_params`` puts the whole tensors back first.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (
    MeshContext, active_mesh, active_model_context, active_sequence_context,
)

Tensor = torch.Tensor


def step_mesh(net) -> Optional[MeshContext]:
    """The mesh of the sharded step ``net`` runs in, or None for a plain
    forward. A net holding column shards outside such a step raises."""
    mesh = active_mesh()
    if mesh is None and getattr(net, "_model_shards", None) is not None:
        raise RuntimeError(
            "the net holds this rank's columns of its model-sharded leaves "
            "while a tensor-parallel ParallelTrainer is attached; call "
            "trainer.gather_params() on every rank before output, score "
            "or serialization")
    if getattr(net, "_pipeline_stage", None) is not None:
        raise RuntimeError(
            "the net holds its pipeline stage's params only while a "
            "PipelineTrainer / GraphPipelineTrainer is attached; call "
            "trainer.gather_params() on every rank before output, score "
            "or serialization")
    return mesh


def seq_split(mesh: Optional[MeshContext]) -> bool:
    """True when this step's batch is split on T over the sp axis."""
    return mesh is not None and active_sequence_context() is not None


def layer_params(net, key, layer, p: Dict[str, Tensor],
                 tied: Optional[tuple] = None) -> Dict[str, Tensor]:
    """``p`` (the params of the layer at ``key``) with every model-sharded
    leaf the layer does not consume column-parallel gathered whole.
    ``tied``: (the tied node's key, "W_tok"), the tied head's injected
    embedding."""
    shards = getattr(net, "_model_shards", None)
    mesh = active_model_context()
    if shards is None or mesh is None:
        return p
    spec = dict(shards.spec.get(key) or {})
    if tied is not None:
        spec[tied[1]] = (shards.spec.get(tied[0]) or {}).get("W", False)
    if not any(spec.values()):
        return p
    keep = layer.column_parallel_params(mesh.n_model)
    return {n: mesh.gather_model(t) if spec.get(n) and n not in keep
            else t for n, t in p.items()}


def column_linear(x: Tensor, W: Tensor, b: Optional[Tensor],
                  n_out: int) -> Tensor:
    """``x @ W + b``. A column shard ``W`` (last axis short of ``n_out``)
    runs column-parallel: ``gather_model(copy_to_model(x) @ W) + b``."""
    if W.shape[-1] == n_out:
        out = x @ W
    else:
        mesh = active_model_context()
        if mesh is None:
            raise RuntimeError(
                f"a weight of {W.shape[-1]} of {n_out} columns outside a "
                "tensor-parallel step")
        out = mesh.gather_model(mesh.copy_to_model(x) @ W)
    return out if b is None else out + b


def sequence_local(layer) -> bool:
    """True when ``layer`` works on a time shard as it is."""
    return bool(getattr(layer, "sequence_local", False))


def whole_sequence(mesh: MeshContext, h: Tensor, mask: Optional[Tensor]):
    """(the whole sequence of ``h``, the whole mask, T): the sp ranks'
    time shards gathered."""
    h = mesh.gather_seq(h)
    if mask is not None:
        mask = mesh.gather_seq(mask)
    return h, mask, h.shape[1]


def own_steps(mesh: MeshContext, out: Tensor, mask: Optional[Tensor],
              T: int):
    """(out, mask, sharded) after a layer that saw the whole sequence of
    ``T`` steps: this rank's time steps where the output keeps that T,
    else the whole (replicated) output."""
    if out.dim() >= 3 and out.shape[1] == T:
        if mask is not None and mask.dim() >= 2 and mask.shape[1] == T:
            mask = mesh.take_seq(mask)
        return mesh.take_seq(out), mask, True
    return out, mask, False


def seq_kwargs(layer, sharded: bool) -> dict:
    """``{"seq_shard": True}`` for a layer that takes it (the positional
    embedding, attention) when its input is this rank's time shard."""
    if sharded and getattr(layer, "takes_seq_shard", False):
        return {"seq_shard": True}
    return {}


def replicated_scale(mesh: Optional[MeshContext]) -> float:
    """The share a value every sp rank computes whole counts for."""
    return 1.0 / mesh.n_seq if mesh is not None and mesh.n_seq > 1 else 1.0


def head_scale(mesh: Optional[MeshContext], labels: Tensor) -> float:
    """The share of a head's loss: 1 on this rank's tokens (time-series
    labels of a split batch), ``1 / n_seq`` on a whole input."""
    if seq_split(mesh) and labels.dim() == 3:
        return 1.0
    return replicated_scale(mesh)


def penalty(net, mesh: MeshContext, keyed_params, layers):
    """The L1/L2 penalty of a sharded step: a column shard's term summed
    over the model axis (its gradient this rank's own), all of it counted
    ``1 / n_seq`` on each sp rank. ``keyed_params``: (key, params) pairs
    aligned with ``layers``."""
    shards = getattr(net, "_model_shards", None)
    total = 0.0
    for (key, p), layer in zip(keyed_params, layers):
        if not p:
            continue
        reg = layer.regularization()
        spec = (shards.spec.get(key) or {}) if shards is not None else {}
        for name, arr in p.items():
            l1, l2 = reg.get(name, (0.0, 0.0))
            term = 0.0
            if l2:
                term = term + 0.5 * l2 * (arr * arr).sum()
            if l1:
                term = term + l1 * arr.abs().sum()
            if isinstance(term, Tensor) and spec.get(name):
                term = mesh.model_sum_value(term)
            total = total + term
    return total * replicated_scale(mesh)


class ModelShards:
    """What a tensor-parallel trainer's net holds (``net._model_shards``):
    this rank's model index of ``n``, which leaves are column shards
    (``spec``: layer key -> {param name: bool}, the keys of ``net.params``:
    node names or layer indices) and whether this rank writes them to a
    sharded checkpoint (data and sp index 0)."""

    def __init__(self, index: int, n: int, spec: dict, writer: bool):
        self.index, self.n, self.spec, self.writer = index, n, spec, writer

    def mirror(self, params):
        """``params``' structure (a list or dict of per-layer dicts) with a
        bool leaf for each tensor: True for a column shard."""
        keys = range(len(params)) if isinstance(params, list) else params
        out = [None] * len(params) if isinstance(params, list) else {}
        for k in keys:
            out[k] = {n: bool(self.spec.get(k, {}).get(n))
                      for n in params[k]}
        return out
