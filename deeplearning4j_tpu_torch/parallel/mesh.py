"""The device mesh over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``), and the collectives the parallel trainers issue.

The JAX package names a device mesh with ``data``, ``model`` and ``sp``
axes and lets XLA insert the collectives; its pipeline and expert tests
name ``("dp", "pp")`` and ``("ep",)`` meshes. The port runs one process
per rank: a ``MeshContext`` lays the world of a ``torch.distributed``
process group out as the JAX mesh's ``reshape(n_data, n_model, n_seq)``
(rank = (d * n_model + m) * n_seq + s), or with a pipeline axis as
``reshape(n_data, n_pipe)`` (rank = d * n_pipe + p; 'pp' composes with
the data axis only, as the JAX pipeline knows 'dp' and 'pp' alone), or
as an expert axis alone (rank = e), builds one sub-group per axis and
the data x sp group ("replicas"), and this module is the one place that
issues collectives: ``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``broadcast``, the sp ring's point-to-point
shift, and the differentiable ones a sharded step's autograd runs:

- ``sum_over_ranks``: the sum batch norm takes its global statistics
  with (all-reduce, backward all-reduce);
- ``gather_model``: the model axis' gather of column shards on the last
  axis (backward: this rank's columns, since what follows runs
  replicated on every model rank);
- ``copy_to_model``: the identity whose backward all-reduces over the
  model axis (Megatron's ``f``, in front of a column-parallel product);
- ``gather_seq``: the sp axis' gather of time shards (backward:
  reduce-scatter, since each sp rank's loss sees only its own tokens);
- ``ring_shift``: the pass to the next sp rank (backward: the pass the
  other way). gloo refuses point-to-point sends of CUDA tensors (its
  collectives stage them, its sends do not), so a gloo group over the
  card stages the shift through host buffers, chosen from the backend;
- ``send_stage`` / ``recv_stage``: the pipeline's pair to another stage
  of the 'pp' axis. The send is posted and the step goes on (its work
  is kept on the mesh until ``wait_sends``); the receive waits. The
  backward of a send receives the gradient of what it sent, the
  backward of a receive sends the gradient back. Each message carries a
  tag (the microbatch), and they stage through host buffers as the
  shift does;
- ``copy_to`` / ``sum_value`` on any axis: the expert axis' identity
  with an all-reduced backward and its forward sum.

With no process group initialized the mesh is world 1 and issues no
collective at all; a group of world 1 (NCCL on one card) issues them, and
each is an identity. ``create`` reads the surviving world (``multihost.
effective_process_count``): after an elastic sole-survivor resize it is
world 1 with no group, though the dead group still exists, and a
collective on that quarantined group raises at once. A collective that
fails in elastic mode is counted (``multihost.runtime_fault_count``)
before its error goes on.

Each rank trains on its data index's rows of the global batch (the JAX
package's multi-process contract; the model and sp ranks of one data
index hold the same rows), and with an sp axis on its time steps of a
batch whose T divides the axis. A batch whose rows do not divide by the
data axis is refused: each rank's mean over its B/dp rows, averaged over
the ranks, is the global mean only because the ranks hold equal rows.

The weight-update layout (``WeightUpdateSharding``) and its per-leaf
helpers (``zero1_chunk`` / ``zero1_shard_leaf`` / ``zero1_unshard_leaf``)
are the JAX package's: each leaf flattened, padded to a multiple of dp
and viewed as ``(dp, chunk)``, row ``r`` owned by data index ``r``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from deeplearning4j_tpu_torch.analysis import steprecord
from deeplearning4j_tpu_torch.device import resolve_device

Tensor = torch.Tensor

# torch 2.13 renamed the single-tensor collectives (the old names warn);
# the card's torch 2.11 has only the old ones
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)


# ---------------------------------------------------------------------------
# weight-update sharding (ZeRO-1/2) config + layout helpers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WeightUpdateSharding:
    """How the data-parallel trainers lay out the weight update.

    ``off``   — every rank holds the full params and the full updater
    state; the gradients are all-reduced and every rank applies the same
    update.

    ``zero1`` — ZeRO-1 (arxiv 2004.13336): each updater-state leaf is kept
    as this rank's row of its flattened, pad-to-divisible ``(dp, chunk)``
    view. The gradients are packed into one ``(dp, row)`` buffer (the
    replicated-size gradient anchor, kept between steps) and
    reduce-scattered into this rank's row; the update runs on the row
    only, and the updated param rows are all-gathered. Updater-state
    memory drops by ``dp``.

    ``zero2`` — the same layout, and the gradients too live only as this
    rank's row from the reduce-scatter on: the packed buffer is transient,
    the accumulation buffer, mask / clip / update math and the
    divergence sentinel's grad-norm (an all-reduced sum of squares over
    the rows) all run on the row, and no full-size gradient outlives the
    reduce-scatter.

    Both are execution-layout changes only: the fp32 loss and param
    trajectories are those of the replicated layout (bit for bit at
    world 2, where a sum over ranks is ``a + b`` in every collective).
    """

    mode: str = "off"    # "off" | "zero1" | "zero2"
    axis: str = "data"

    MODES = ("off", "zero1", "zero2")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(
                f"weight_update_sharding mode must be one of {self.MODES}, "
                f"got {self.mode!r}")

    @property
    def enabled(self) -> bool:
        """True when the weight update runs on the sharded rows (zero1
        and zero2 share that machinery)."""
        return self.mode in ("zero1", "zero2")

    @property
    def zero2(self) -> bool:
        """True when gradients live only as rows (no anchor buffer)."""
        return self.mode == "zero2"

    @staticmethod
    def parse(value: Union["WeightUpdateSharding", str, None]
              ) -> "WeightUpdateSharding":
        """None / "off" / "zero1" / "zero2" / an instance."""
        if value is None:
            return WeightUpdateSharding()
        if isinstance(value, WeightUpdateSharding):
            return value
        return WeightUpdateSharding(mode=str(value))


def zero1_chunk(size: int, n: int) -> int:
    """Per-shard element count for a flattened leaf of ``size`` split
    ``n`` ways (pad-to-divisible)."""
    return -(-int(size) // max(1, n))


def zero1_shard_leaf(x: Tensor, n: int) -> Tensor:
    """The flattened pad-to-divisible ``(n, chunk)`` view of one leaf (a
    copy; the padding is zeros)."""
    flat = x.reshape(-1)
    chunk = zero1_chunk(flat.numel(), n)
    pad = chunk * n - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n, chunk)


def zero1_unshard_leaf(y: Tensor, shape: Tuple[int, ...]) -> Tensor:
    """Inverse of :func:`zero1_shard_leaf`: drop the padding tail and
    restore the original shape."""
    size = int(np.prod(shape)) if shape else 1
    return y.reshape(-1)[:size].reshape(shape)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _group_world(group) -> Tuple[int, int, bool]:
    """(world, rank, the mesh reduces through a group): the surviving
    world when an elastic resize installed one (a sole survivor has no
    group to reduce through; more survivors re-form in a restart), else
    the group's."""
    from deeplearning4j_tpu_torch.parallel import multihost
    override = multihost.topology_override()
    if override is not None:
        if override[0] != 1:
            raise ValueError(
                f"a resized world of {override[0]} processes re-forms "
                "through a restart (ElasticRestartRequired), not in "
                "process")
        return 1, 0, False
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0, False
    return dist.get_world_size(group), dist.get_rank(group), True


def _note_collective(fn, args, kwargs, axis: Optional[str],
                     staged: bool) -> None:
    """Report one collective to the step's listeners (``analysis/
    steprecord``): its kind, the mesh axis it runs over, the group's size,
    its logical full payload and, when ``staged``, the host buffers its
    tensors travel through."""
    group = kwargs.get("group")
    buffers = args[:1]
    if fn is dist.batch_isend_irecv:
        buffers = tuple(op.tensor for op in args[0])
        kind, t, group = "collective-permute", buffers[0], args[0][0].group
    elif fn is dist.all_reduce:
        kind, t = "all-reduce", args[0]
    elif fn is _REDUCE_SCATTER:
        kind, t = "reduce-scatter", args[1]
    elif fn is _ALL_GATHER:
        kind, t = "all-gather", args[0]
    elif fn is dist.broadcast:
        kind, t = "broadcast", args[0]
    elif fn is dist.isend:
        kind, t = "send", args[0]
    elif fn is dist.recv:
        kind, t = "recv", args[0]
    else:
        raise ValueError(f"no collective kind for {fn!r}")
    steprecord.note_collective(kind, axis, dist.get_world_size(group), t,
                               buffers if staged else ())


def _collective(fn, *args, axis: Optional[str] = None, staged: bool = False,
                **kwargs):
    """Run one ``torch.distributed`` collective over the mesh ``axis``
    (reported to the step's listeners, ``staged`` when its tensors are
    host buffers staged here); a failure in elastic mode
    is counted before it goes on. None is issued once an elastic resize
    quarantined the group: that raises at once, where the collective
    would wait on a dead peer for the group's timeout."""
    from deeplearning4j_tpu_torch.parallel import multihost
    if multihost.group_quarantined():
        raise RuntimeError(
            "the process group was quarantined by an elastic resize: no "
            "collective runs on it again")
    if steprecord.recording():
        _note_collective(fn, args, kwargs, axis, staged)
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        multihost.note_runtime_fault(e)
        raise


class _SumOverRanks(torch.autograd.Function):
    """``t`` summed over the group, differentiable: the gradient of every
    rank's loss with respect to the sum reaches each rank's ``t`` through
    the same all-reduce in the backward."""

    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.group, ctx.axis = group, axis
        out = t.clone()
        _collective(dist.all_reduce, out, group=group, axis=axis)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _collective(dist.all_reduce, grad, group=ctx.group, axis=ctx.axis)
        return grad, None, None


class _SumForward(torch.autograd.Function):
    """``t`` summed over the group, its gradient passed through as it is:
    a value every rank of the group counts once (a sharded leaf's share
    of the L1/L2 penalty)."""

    @staticmethod
    def forward(ctx, t, group, axis):
        out = t.clone()
        _collective(dist.all_reduce, out, group=group, axis=axis)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyToGroup(torch.autograd.Function):
    """The identity, whose backward all-reduces the gradient over the group
    (Megatron's ``f``): the input of a column-parallel product, whose
    ranks each see the gradient of their own columns only."""

    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.group, ctx.axis = group, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _collective(dist.all_reduce, grad, group=ctx.group, axis=ctx.axis)
        return grad, None, None


def _gather_dim(t: Tensor, dim: int, group, n: int, axis: str) -> Tensor:
    """Every rank's ``t`` concatenated on ``dim`` in group-rank order."""
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _collective(_ALL_GATHER, out, src, group=group, axis=axis)
    return out.movedim(0, dim)


class _GatherDim(torch.autograd.Function):
    """All-gather on ``dim`` whose backward takes this rank's slice of the
    gradient: what follows the gather runs replicated on every rank of
    the group, so each already holds the whole gradient (the model axis'
    gather of column shards)."""

    @staticmethod
    def forward(ctx, t, dim, group, n, index, axis):
        ctx.dim, ctx.index, ctx.size = dim, index, t.shape[dim]
        return _gather_dim(t, dim, group, n, axis)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None, None, None, None)


class _GatherReduceScatter(torch.autograd.Function):
    """All-gather on ``dim`` whose backward reduce-scatters the gradient:
    each rank's loss sees its own slice of what follows only (the
    sequence axis' gather of time shards), so the gradient of the whole
    is the sum over the ranks."""

    @staticmethod
    def forward(ctx, t, dim, group, n, axis):
        ctx.dim, ctx.group, ctx.n, ctx.axis = dim, group, n, axis
        return _gather_dim(t, dim, group, n, axis)

    @staticmethod
    def backward(ctx, grad):
        g = grad.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((g.shape[0] // ctx.n,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        _collective(_REDUCE_SCATTER, out, g, group=ctx.group, axis=ctx.axis)
        return out.movedim(0, ctx.dim), None, None, None, None


def _staged(t: Tensor, stage: bool) -> Tensor:
    """``t`` as a point-to-point op sends it: contiguous, detached, and
    in host memory when ``stage`` (a gloo group over CUDA tensors: gloo's
    collectives stage CUDA tensors themselves, its point-to-point sends
    do not)."""
    src = t.detach().contiguous()
    return src.cpu() if stage else src


def _shift(t: Tensor, group, send_to: int, recv_from: int,
           stage: bool) -> Tensor:
    """``t`` sent to rank ``send_to`` while ``recv_from``'s arrives (global
    ranks), through host buffers when ``stage``."""
    src = _staged(t, stage)
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, send_to, group=group),
           dist.P2POp(dist.irecv, buf, recv_from, group=group)]
    for work in _collective(dist.batch_isend_irecv, ops, axis="sp",
                            staged=stage):
        work.wait()
    return buf.to(t.device) if stage else buf


class _RingShift(torch.autograd.Function):
    """``t`` passed to the next rank of the ring; the backward passes the
    gradient to the previous one."""

    @staticmethod
    def forward(ctx, t, group, send_to, recv_from, stage):
        ctx.args = (group, recv_from, send_to, stage)
        return _shift(t, group, send_to, recv_from, stage)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, *ctx.args), None, None, None, None


class _SendStage(torch.autograd.Function):
    """``t`` posted to the global rank ``peer`` under ``tag``; the output
    is a zero scalar, the token a stage's backward starts from. Its
    backward receives the gradient of ``t`` from ``peer``."""

    @staticmethod
    def forward(ctx, t, mesh, peer, tag):
        ctx.mesh, ctx.peer, ctx.tag = mesh, peer, tag
        ctx.meta = (tuple(t.shape), t.dtype, t.device)
        mesh._post(t, peer, tag)
        return t.new_zeros(())

    @staticmethod
    def backward(ctx, _token):
        shape, dtype, device = ctx.meta
        return (ctx.mesh._take(shape, dtype, device, ctx.peer, ctx.tag),
                None, None, None)


class _RecvStage(torch.autograd.Function):
    """What the global rank ``peer`` posted under ``tag``; the backward
    sends its gradient back. ``anchor`` is a scalar that requires grad,
    so that autograd reaches the backward."""

    @staticmethod
    def forward(ctx, anchor, mesh, peer, tag, shape, dtype):
        ctx.mesh, ctx.peer, ctx.tag = mesh, peer, tag
        return mesh._take(shape, dtype, anchor.device, peer, tag)

    @staticmethod
    def backward(ctx, grad):
        ctx.mesh._post(grad, ctx.peer, ctx.tag)
        return None, None, None, None, None, None


# ---------------------------------------------------------------------------
# the mesh's layout: ranks and sub-groups
# ---------------------------------------------------------------------------

#: the axes a rank's collectives run over; "replicas" is the data and sp
#: axes together (the ranks that hold the same columns of every leaf)
AXES = ("data", "model", "sp", "replicas")

#: each layout's sub-groups of the default group, this rank's by axis
_GROUPS: Dict[tuple, Dict[str, Any]] = {}


def mesh_coords(rank: int, n_model: int, n_seq: int) -> Tuple[int, int, int]:
    """(data, model, sp) index of ``rank`` in the JAX mesh's
    ``reshape(n_data, n_model, n_seq)``: rank = (d * n_model + m) * n_seq
    + s."""
    return (rank // (n_model * n_seq), (rank // n_seq) % n_model,
            rank % n_seq)


def axis_ranks(shape: Tuple[int, int, int], axis: str,
               coords: Tuple[int, int, int]) -> List[int]:
    """The ranks that share every index of ``coords`` but ``axis``'s, in
    rank order (so a rank's place in its axis group is its index on the
    axis)."""
    nd, nm, ns = shape
    d, m, s = coords

    def rank(i, j, k):
        return (i * nm + j) * ns + k
    if axis == "data":
        return [rank(i, m, s) for i in range(nd)]
    if axis == "model":
        return [rank(d, j, s) for j in range(nm)]
    if axis == "sp":
        return [rank(d, m, k) for k in range(ns)]
    return [rank(i, m, k) for i in range(nd) for k in range(ns)]


def pipe_axis_ranks(shape: Tuple[int, int], axis: str,
                    rank: int) -> List[int]:
    """The ranks of ``rank``'s group on ``axis`` ("pp", or "data" /
    "replicas") in the pipeline layout ``(n_data, n_pipe)``: rank = d *
    n_pipe + p, the JAX tests' ``reshape(n_dp, n_pp)``."""
    nd, npp = shape
    d, p = divmod(rank, npp)
    if axis == "pp":
        return [d * npp + j for j in range(npp)]
    return [i * npp + p for i in range(nd)]


def _layout_groups(shape: Tuple[int, ...], rank: int,
                   pipe: bool = False) -> Dict[str, Any]:
    """This rank's sub-group on each axis that spans more than one rank
    and less than the world ("world" for an axis that is the whole
    default group). ``shape``: (n_data, n_model, n_seq), or with
    ``pipe`` the pipeline layout (n_data, n_pipe). Every rank calls
    ``dist.new_group`` for every group of the layout in the same order,
    or the rendezvous hangs; the groups are built once a layout and a
    default group."""
    key = (id(dist.group.WORLD), shape, pipe)
    if key in _GROUPS:
        return _GROUPS[key]
    world = int(np.prod(shape))
    if pipe:
        axes = ("data", "pp", "replicas")

        def ranks_of(axis, r):
            return pipe_axis_ranks(shape, axis, r)
    else:
        axes = AXES

        def ranks_of(axis, r):
            return axis_ranks(shape, axis, mesh_coords(r, shape[1],
                                                       shape[2]))
    mine: Dict[str, Any] = {}
    for axis in axes:
        seen = set()
        for r in range(world):
            ranks = tuple(ranks_of(axis, r))
            if ranks in seen or len(ranks) == 1:
                continue
            seen.add(ranks)
            if len(ranks) == world:
                mine[axis] = "world"
                continue
            g = dist.new_group(list(ranks))
            if rank in ranks:
                mine[axis] = g
    _GROUPS[key] = mine
    return mine


def forget_groups() -> None:
    """Drop the cached sub-groups (the default group they belong to is
    being destroyed)."""
    _GROUPS.clear()


@dataclass
class MeshContext:
    """The mesh over a ``torch.distributed`` group: ``world`` ranks laid out
    as the JAX mesh's ``(n_data, n_model, n_seq)``, as ``(n_data,
    n_pipe)`` with a pipeline axis, or as ``(n_expert,)`` with an expert
    axis; one device a rank. ``group=None`` is the default group."""

    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    distributed: bool = False
    data_axis: str = "data"
    n_model: int = 1
    n_seq: int = 1
    n_pipe: int = 1
    n_expert: int = 1
    # shard a param's last axis over `model` only when it is at least
    # this big (the JAX package's policy)
    min_shard_size: int = 1024
    groups: Dict[str, Any] = field(default_factory=dict, repr=False)
    # the pipeline's posted sends (work, buffer) until wait_sends()
    _sends: List[Any] = field(default_factory=list, repr=False,
                              compare=False)

    @staticmethod
    def create(n_data: Optional[int] = None, n_model: int = 1,
               n_seq: int = 1, device=None, group=None, n_pipe: int = 1,
               n_expert: int = 1) -> "MeshContext":
        """The mesh over ``group`` (the default process group), on
        ``device`` (``None``: the CUDA card, raising without one;
        ``"cpu"`` for the CPU). The world is ``n_data * n_model * n_seq *
        n_pipe * n_expert`` ranks; ``n_data`` defaults to the world over
        the other axes, and a world the axes cannot split raises.
        ``n_seq > 1`` adds the 'sp' axis: ``SelfAttentionLayer`` routes
        through ring attention over it when ``ParallelTrainer`` trains
        the net. ``n_pipe > 1`` adds the pipeline axis 'pp' (for
        ``PipelineTrainer`` / ``GraphPipelineTrainer``), which composes
        with the data axis only; ``n_expert > 1`` the expert axis 'ep'
        (``parallel/expert.moe_ffn``), alone."""
        if min(n_model, n_seq, n_pipe, n_expert) < 1 or (
                n_data is not None and n_data < 1):
            raise ValueError(f"mesh axes must be >= 1, got n_data="
                             f"{n_data}, n_model={n_model}, n_seq={n_seq}, "
                             f"n_pipe={n_pipe}, n_expert={n_expert}")
        if n_pipe > 1 and max(n_model, n_seq, n_expert) > 1:
            raise ValueError(
                "the pipeline axis 'pp' composes with the data axis only "
                "(the pipeline knows 'dp' and 'pp'); got n_model="
                f"{n_model}, n_seq={n_seq}, n_expert={n_expert}")
        device = resolve_device(device)
        world, rank, distributed = _group_world(group)
        per = n_model * n_seq * n_pipe * n_expert
        if n_data is None:
            if world % per:
                raise ValueError(
                    f"a world of {world} ranks cannot be laid out as "
                    f"n_model={n_model} x n_seq={n_seq} x n_pipe={n_pipe} "
                    f"x n_expert={n_expert}")
            n_data = world // per
        if n_expert > 1 and max(n_data, n_model, n_seq) > 1:
            raise ValueError(
                "the expert axis 'ep' stands alone (the expert mesh is "
                f"('ep',)); got n_data={n_data}, n_model={n_model}, "
                f"n_seq={n_seq}")
        if n_data * per != world:
            raise ValueError(
                f"n_data={n_data} x n_model={n_model} x n_seq={n_seq} x "
                f"n_pipe={n_pipe} x n_expert={n_expert} = {n_data * per} "
                f"ranks, but the process group has world {world}: one "
                "rank is one device of the mesh")
        if distributed and device.type == "cpu" and \
                dist.get_backend(group) == "nccl":
            raise ValueError("an nccl process group cannot reduce CPU "
                             "tensors; initialize a gloo group for "
                             "device='cpu'")
        groups = {}
        shape = (n_data, n_pipe) if n_pipe > 1 else (n_data, n_model, n_seq)
        if distributed and sum(a > 1 for a in shape) > 1:
            if group is not None:
                raise ValueError(
                    f"a mesh of {shape} needs sub-groups, which are laid "
                    "out over the default process group; pass group=None")
            groups = _layout_groups(shape, rank, pipe=n_pipe > 1)
        return MeshContext(world=world, rank=rank, device=device,
                           group=group, distributed=distributed,
                           n_model=n_model, n_seq=n_seq, n_pipe=n_pipe,
                           n_expert=n_expert, groups=groups)

    # ----------------------------------------------------------------- layout
    #: the port's axes: each is there, of size 1 where the layout has
    #: none ("pp" is the JAX pipeline's, "data" its "dp")
    axis_names = ("data", "model", "sp", "pp", "ep")

    @property
    def n_data(self) -> int:
        return self.world // (self.n_model * self.n_seq * self.n_pipe
                              * self.n_expert)

    @property
    def model_axis(self) -> Optional[str]:
        """'model' when params shard over a model axis, else None."""
        return "model" if self.n_model > 1 else None

    @property
    def seq_axis(self) -> Optional[str]:
        """'sp' when the mesh has a sequence axis, else None."""
        return "sp" if self.n_seq > 1 else None

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This rank's (data, model, sp) index (a pipeline layout's data
        index; 0 on the expert axis, whose ranks hold the same rows)."""
        if self.n_pipe > 1:
            return (self.rank // self.n_pipe, 0, 0)
        if self.n_expert > 1:
            return (0, 0, 0)
        return mesh_coords(self.rank, self.n_model, self.n_seq)

    @property
    def pipe_index(self) -> int:
        """This rank's stage on the 'pp' axis."""
        return self.rank % self.n_pipe

    @property
    def expert_index(self) -> int:
        """This rank's index on the 'ep' axis."""
        return self.rank % self.n_expert

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    @property
    def seq_index(self) -> int:
        return self.coords[2]

    @property
    def n_replicas(self) -> int:
        """Ranks that hold the same columns (the data x sp group)."""
        return self.n_data * self.n_seq

    @property
    def replica_index(self) -> int:
        d, _, s = self.coords
        return d * self.n_seq + s

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.distributed else None

    def _axis(self, axis: str) -> Tuple[bool, Any, int]:
        """(a collective runs, its group, the axis' size). An axis as wide
        as the world runs over the mesh's group (a world-1 group too, as
        an identity); one of a single rank inside a wider world runs
        nothing."""
        n = {"data": self.n_data, "model": self.n_model, "sp": self.n_seq,
             "replicas": self.n_replicas, "pp": self.n_pipe,
             "ep": self.n_expert}[axis]
        if not self.distributed:
            return False, None, n
        if n == self.world:
            return True, self.group, n
        if n == 1:
            return False, None, 1
        return True, self.groups[axis], n

    def zero1_shards(self, axis: Optional[str] = None) -> int:
        """Number of weight-update shards = the data axis' size."""
        return self.n_data

    def validate_weight_update_sharding(
            self, wus: WeightUpdateSharding) -> None:
        """Raise at trainer construction when the mesh cannot carry the
        requested weight-update layout."""
        if not wus.enabled:
            return
        if wus.axis != self.data_axis:
            raise ValueError(
                f"weight_update_sharding axis {wus.axis!r} is not a mesh "
                f"axis (have ({self.data_axis!r},))")
        if self.n_data < 2:
            raise ValueError(
                f"{wus.mode} weight-update sharding needs at least 2 "
                f"replicas on axis {wus.axis!r} (mesh has {self.n_data}) "
                "— with dp=1 there is nothing to shard; use mode='off'")
        if self.n_model > 1:
            raise ValueError(
                f"{wus.mode} weight-update sharding composes with pure "
                "data parallelism only; this mesh tensor-shards params "
                f"over 'model' ({self.n_model} ways) — the updater state "
                "of a model-sharded kernel is already distributed")

    # -------------------------------------------------------------- policies
    def param_spec(self, name: str, shape: Tuple[int, ...]) -> tuple:
        """Tensor-parallel policy (the JAX package's): shard the last axis
        of a tensor of at least 2 dims over 'model' when it divides by
        ``n_model`` and the tensor has at least ``min_shard_size``
        elements; replicate everything else. The spec as a tuple
        (``(None, "model")``; ``()`` replicated)."""
        shape = tuple(shape)
        if (self.model_axis is not None and len(shape) >= 2
                and shape[-1] % self.n_model == 0
                and int(np.prod(shape)) >= self.min_shard_size):
            return (None,) * (len(shape) - 1) + (self.model_axis,)
        return ()

    def param_sharding(self, name: str, shape) -> tuple:
        """The placement of a leaf: its :meth:`param_spec`."""
        return self.param_spec(name, tuple(shape))

    def model_columns(self, t: Tensor) -> Tensor:
        """This rank's columns of a model-sharded leaf (a copy)."""
        c = t.shape[-1] // self.n_model
        return t.narrow(-1, self.model_index * c, c).clone()

    def batch_sharding(self, ndim: int,
                       shape: Optional[Tuple[int, ...]] = None) -> tuple:
        """The batch's spec: rows over 'data'; with a seq axis a rank-3
        ``[B, T, F]`` batch whose T divides the axis is split on T over
        'sp' too (a non-divisible T stays whole: the sp ranks then hold
        the same tokens)."""
        if (self.seq_axis is not None and ndim == 3
                and (shape is None or shape[1] % self.n_seq == 0)):
            return (self.data_axis, self.seq_axis, None)
        return (self.data_axis,) + (None,) * (ndim - 1)

    # -------------------------------------------------------------- placement
    def shard_params(self, params):
        """Every tensor on this rank's device (a tensor already there is
        kept as it is, in place). The trainer cuts model-sharded leaves to
        this rank's columns (:meth:`model_columns`)."""
        from deeplearning4j_tpu_torch.nn.updater import tree_map
        return tree_map(lambda t: t.to(self.device), params)

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch`` rows: the
        rows of its data index (the model and sp ranks of one data index
        hold the same rows)."""
        if global_batch % self.n_data:
            raise ValueError(
                f"global batch {global_batch} not divisible by the "
                f"{self.n_data}-way data axis")
        per = global_batch // self.n_data
        d = self.data_index
        return slice(d * per, (d + 1) * per)

    def rank_rows(self, global_batch: int, microbatches: int = 1):
        """This rank's rows of a global batch of ``global_batch`` rows
        trained in ``microbatches`` microbatches: its data index's share of
        each microbatch, in microbatch order (``batch_slice`` for one, else
        an index array). A trainer that cuts these rows, marked
        ``data_ranks``, into its microbatches hands each rank the rows the
        global batch's microbatches give it."""
        k = microbatches
        if global_batch % (k * self.n_data):
            raise ValueError(
                f"global batch {global_batch} not divisible into {k} "
                f"microbatches over the {self.n_data}-way data axis")
        if k == 1:
            return self.batch_slice(global_batch)
        mb = global_batch // k
        per = mb // self.n_data
        start = self.data_index * per
        return np.concatenate([np.arange(i * mb + start, i * mb + start + per)
                               for i in range(k)])

    def holds_local_rows(self, batch) -> bool:
        """True when ``batch`` is marked ``data_ranks`` (this data rank's
        rows of a global batch, cut already); a mark of another width than
        the data axis raises."""
        marked = batch.data_ranks
        if marked is not None and marked != self.n_data:
            raise ValueError(
                f"the batch holds one rank's rows of {marked} data ranks, "
                f"but the mesh's data axis is {self.n_data} wide")
        return marked is not None

    def seq_slice(self, T: int) -> slice:
        """This rank's time steps of a sequence of ``T`` split over 'sp'."""
        per = T // self.n_seq
        return slice(self.seq_index * per, (self.seq_index + 1) * per)

    def shard_batch(self, *arrays):
        """This rank's part of each array (None passes through): its rows,
        and its time steps where :meth:`batch_sharding` splits T."""
        out = []
        for a in arrays:
            if a is not None:
                a = a[self.batch_slice(int(a.shape[0]))]
                if self.batch_sharding(a.ndim, a.shape)[1:2] == ("sp",):
                    a = a[:, self.seq_slice(int(a.shape[1]))]
            out.append(a)
        return tuple(out) if len(out) > 1 else out[0]

    def seq_length(self, batch) -> Optional[int]:
        """The T a batch is split on over 'sp' (its first feature's, a
        rank-3 series whose T divides the axis), or None when it stays
        whole."""
        if self.seq_axis is None:
            return None
        feats = batch.features
        f = feats[0] if isinstance(feats, (list, tuple)) else feats
        if f is None or len(f.shape) != 3 or f.shape[1] % self.n_seq:
            return None
        return int(f.shape[1])

    def local_rows(self, batch, seq: bool = True):
        """``batch`` (a DataSet or MultiDataSet) cut to this rank's rows
        and, with ``seq`` where it splits on T, time steps (its rank-3
        arrays and the ``[B, T]`` masks of that T); the batch itself on a
        mesh of one rank. A batch marked ``data_ranks`` holds this rank's
        rows already: no rows are cut."""
        if self.world == 1:
            return batch
        if self.n_data > 1 and not self.holds_local_rows(batch):
            batch = take_rows(batch, self.batch_slice(batch.num_examples()))
        T = self.seq_length(batch) if seq else None
        return batch if T is None else take_steps(batch, T,
                                                  self.seq_slice(T))

    # ------------------------------------------------------------ collectives
    def all_reduce_(self, t: Tensor, op: str = "sum",
                    axis: str = "data") -> Tensor:
        """``t`` reduced over ``axis`` (default the data axis), in place
        (``op``: "sum" or "max")."""
        run, group, _ = self._axis(axis)
        if run:
            _collective(dist.all_reduce, t,
                        op=(dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM), group=group, axis=axis)
        return t

    def sum_over_ranks(self, t: Tensor, axis: str = "data") -> Tensor:
        """``t`` summed over ``axis``, differentiably (the backward
        all-reduces the gradient); ``t`` itself without a group."""
        run, group, _ = self._axis(axis)
        if not run:
            return t
        return _SumOverRanks.apply(t, group, axis)

    def sum_over_replicas(self, t: Tensor) -> Tensor:
        """:meth:`sum_over_ranks` over the data x sp group: a global-batch
        statistic (the model ranks of a replica hold the same rows and
        are not counted twice)."""
        return self.sum_over_ranks(t, "replicas")

    def reduce_scatter(self, flat: Tensor, axis: str = "data") -> Tensor:
        """The sum over ``axis`` of ``flat`` (``n * k`` elements), this
        rank's ``k``-element slice of it."""
        run, group, n = self._axis(axis)
        if not run:
            return flat.clone()
        out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                          device=flat.device)
        _collective(_REDUCE_SCATTER, out, flat, group=group, axis=axis)
        return out

    def all_gather(self, row: Tensor, axis: str = "data") -> Tensor:
        """Every rank's ``row`` on ``axis`` concatenated in index order."""
        run, group, n = self._axis(axis)
        if not run:
            return row.clone()
        out = torch.empty(row.numel() * n, dtype=row.dtype,
                          device=row.device)
        _collective(_ALL_GATHER, out, row.contiguous(), group=group,
                    axis=axis)
        return out

    def broadcast_(self, t: Tensor, src: int = 0,
                   axis: str = "data") -> Tensor:
        """``t`` from index ``src`` of ``axis`` (the data axis) on every
        rank of it, in place."""
        run, group, _ = self._axis(axis)
        if run:
            _collective(dist.broadcast, t,
                        src=dist.get_global_rank(group, src)
                        if group is not None else src,
                        group=group, axis=axis)
        return t

    def any_flag(self, flag: Tensor, axis: str = "data") -> Tensor:
        """A bool flag set on any rank of ``axis``, on every rank of it
        (all-reduce MAX)."""
        if not self._axis(axis)[0]:
            return flag
        x = flag.to(torch.uint8).reshape(1)
        self.all_reduce_(x, "max", axis)
        return x.reshape(()).bool()

    def mean_(self, tensors: Sequence[Tensor]) -> None:
        """Each tensor replaced by its mean over the data axis, in place,
        through one all-reduce of their concatenation (a no-op at world
        1)."""
        tensors = [t for t in tensors if t.is_floating_point()]
        run, _, n = self._axis("data")
        if not run or not tensors:
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        self.all_reduce_(flat).div_(n)
        copy_flat_into(flat, tensors)

    # ------------------------------- the model and sp axes, differentiable
    def gather_model(self, t: Tensor) -> Tensor:
        """The model axis' column shards of ``t`` gathered on its last
        axis (the backward keeps this rank's columns of the gradient)."""
        run, group, n = self._axis("model")
        if not run:
            return t
        return _GatherDim.apply(t, t.dim() - 1, group, n, self.model_index,
                                "model")

    def copy_to(self, t: Tensor, axis: str) -> Tensor:
        """``t`` as it is; its gradient all-reduced over ``axis``."""
        run, group, _ = self._axis(axis)
        return _CopyToGroup.apply(t, group, axis) if run else t

    def sum_value(self, t: Tensor, axis: str) -> Tensor:
        """``t`` summed over ``axis``, its gradient passed through: a
        value every rank of the axis goes on with as a replicated one."""
        run, group, _ = self._axis(axis)
        return _SumForward.apply(t, group, axis) if run else t

    def copy_to_model(self, t: Tensor) -> Tensor:
        """``t`` as it is; its gradient all-reduced over the model axis."""
        return self.copy_to(t, "model")

    def model_sum_value(self, t: Tensor) -> Tensor:
        """``t`` summed over the model axis, its gradient passed through."""
        return self.sum_value(t, "model")

    def gather_seq(self, t: Tensor, dim: int = 1) -> Tensor:
        """The sp axis' time shards of ``t`` gathered on ``dim`` (the
        backward reduce-scatters the gradient)."""
        run, group, n = self._axis("sp")
        if not run:
            return t
        return _GatherReduceScatter.apply(t, dim, group, n, "sp")

    def take_seq(self, t: Tensor, dim: int = 1) -> Tensor:
        """This rank's time steps of a whole sequence on ``dim``."""
        return t.narrow(dim, self.seq_index * (t.shape[dim] // self.n_seq),
                        t.shape[dim] // self.n_seq)

    def ring_shift(self, t: Tensor) -> Tensor:
        """``t`` from the previous rank of the sp ring (this rank's goes
        to the next), differentiable. A gloo group over CUDA tensors
        stages the send through host buffers: gloo refuses point-to-point
        sends of device memory."""
        run, group, n = self._axis("sp")
        if not run:
            return t
        ring = axis_ranks((self.n_data, self.n_model, self.n_seq), "sp",
                          self.coords)
        if self.group is not None:     # ranks of the mesh's own group
            ring = [dist.get_global_rank(self.group, r) for r in ring]
        s = self.seq_index
        stage = t.is_cuda and self.backend == "gloo"
        return _RingShift.apply(t, group, ring[(s + 1) % n],
                                ring[(s - 1) % n], stage)

    # ------------------------------------------ the pp axis, point to point
    def stage_peer(self, stage: int) -> int:
        """The global rank of pipeline stage ``stage`` at this rank's data
        index."""
        r = self.data_index * self.n_pipe + stage
        return dist.get_global_rank(self.group, r) if self.group is not None \
            else r

    def _stages_via_host(self, device) -> bool:
        return device.type == "cuda" and self.backend == "gloo"

    def _post(self, t: Tensor, peer: int, tag: int) -> None:
        """``t`` sent to the global rank ``peer`` under ``tag``, not waited
        for: the work and its buffer are kept until :meth:`wait_sends`."""
        host = self._stages_via_host(t.device)
        src = _staged(t, host)
        work = _collective(dist.isend, src, peer, group=self.group, tag=tag,
                           axis="pp", staged=host)
        self._sends.append((work, src))

    def _take(self, shape, dtype, device, peer: int, tag: int) -> Tensor:
        """What the global rank ``peer`` sent under ``tag`` (waits)."""
        host = self._stages_via_host(torch.device(device))
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host else device)
        _collective(dist.recv, buf, peer, group=self.group, tag=tag,
                    axis="pp", staged=host)
        return buf.to(device) if host else buf

    def wait_sends(self) -> None:
        """Wait for every send posted since the last call."""
        sends, self._sends = self._sends, []
        for work, _buf in sends:
            work.wait()

    def send_stage(self, t: Tensor, stage: int, tag: int) -> Tensor:
        """``t`` sent to pipeline stage ``stage`` under ``tag``,
        differentiably: returns a zero scalar token whose backward
        receives the gradient of ``t`` from that stage."""
        return _SendStage.apply(t, self, self.stage_peer(stage), tag)

    def recv_stage(self, shape, dtype, stage: int, tag: int) -> Tensor:
        """What pipeline stage ``stage`` sent under ``tag`` (a tensor of
        ``shape`` and ``dtype`` on this rank's device), differentiably:
        its backward sends the gradient back to that stage."""
        anchor = torch.zeros((), device=self.device, requires_grad=True)
        return _RecvStage.apply(anchor, self, self.stage_peer(stage), tag,
                                tuple(shape), dtype)


class GlobalBatch:
    """The global batch of a data-parallel step, as the layers that take
    statistics over it see it (``netcommon.global_batch_stats``). Called,
    it is the differentiable sum over the data x sp ranks through which a
    training batch norm takes its per-channel statistics. Its ``token_*``
    methods are the data axis over which an MoE layer takes its capacity,
    its tokens' positions and its balancing loss
    (``parallel/expert.moe_dispatch``): an MoE layer mixes no time steps
    but is not ``sequence_local``, so on an sp axis it sees the whole
    sequences of its replica's rows, the sp ranks of a replica hold the
    same tokens, and the data ranks' runs of tokens follow one another in
    the global ``[B, T]`` order."""

    def __init__(self, mesh: MeshContext):
        self.mesh = mesh

    def __call__(self, t: Tensor) -> Tensor:
        return self.mesh.sum_over_replicas(t)

    def n_tokens(self, n: int) -> int:
        """The global token count of a step whose data ranks each hold
        ``n`` (the trainer cuts every microbatch into equal parts)."""
        return n * self.mesh.n_data

    def token_counts(self, counts: Tensor) -> Tuple[Tensor, Tensor]:
        """(the sum of ``counts`` over the data ranks before this one,
        their sum over every data rank): one all-gather, no gradient."""
        mesh = self.mesh
        rows = mesh.all_gather(counts.detach().to(torch.float64).reshape(-1),
                               "data").view(mesh.n_data, -1)
        return rows[:mesh.data_index].sum(dim=0), rows.sum(dim=0)

    def token_sum(self, t: Tensor) -> Tensor:
        """``t`` summed over the data axis, differentiably."""
        return self.mesh.sum_over_ranks(t, "data")


# ---------------------------------------------------------------------------
# the active step's sharded axes (the seam the layers read)
# ---------------------------------------------------------------------------

_ACTIVE_SEQ_CTX: list = []


class sequence_parallel_scope:
    """While active, a training forward runs on the mesh's model and sp
    axes: ``SelfAttentionLayer.apply`` routes attention through
    ``ring_attention_sharded`` over 'sp' (when ``seq_split``: this step's
    batch is split on T), and model-sharded leaves are consumed on this
    rank's columns. A no-op for meshes without either axis.
    ``ParallelTrainer`` enters it around its step, so single-device
    paths (parity references, inference) stay unrouted."""

    def __init__(self, ctx: "MeshContext", seq_split: bool = True):
        sharded = ctx is not None and (
            getattr(ctx, "seq_axis", None) or getattr(ctx, "model_axis",
                                                      None))
        self._entry = (ctx, bool(seq_split)) if sharded else None

    def __enter__(self):
        if self._entry is not None:
            _ACTIVE_SEQ_CTX.append(self._entry)
        return self

    def __exit__(self, *exc):
        if self._entry is not None:
            _ACTIVE_SEQ_CTX.pop()
        return False


def active_sequence_context() -> Optional["MeshContext"]:
    """The MeshContext of the innermost scope when its batch is split on T
    over 'sp' (its ``seq_axis`` is set), else None."""
    if not _ACTIVE_SEQ_CTX:
        return None
    ctx, split = _ACTIVE_SEQ_CTX[-1]
    return ctx if split and ctx.seq_axis is not None else None


def active_model_context() -> Optional["MeshContext"]:
    """The MeshContext of the innermost scope when it has a model axis."""
    if not _ACTIVE_SEQ_CTX:
        return None
    ctx = _ACTIVE_SEQ_CTX[-1][0]
    return ctx if ctx.model_axis is not None else None


def active_mesh() -> Optional["MeshContext"]:
    """The MeshContext of the innermost scope (None outside any)."""
    return _ACTIVE_SEQ_CTX[-1][0] if _ACTIVE_SEQ_CTX else None


def copy_flat_into(flat: Tensor, tensors: Sequence[Tensor]) -> None:
    """Write consecutive slices of ``flat`` into ``tensors`` in place (each
    cast to its own dtype)."""
    parts = flat.split([t.numel() for t in tensors])
    with torch.no_grad():
        for p, t in zip(parts, tensors):
            t.copy_(p.view(t.shape))


def _map_batch(batch, features, labels, masks):
    """A DataSet or MultiDataSet with ``features`` / ``labels`` / ``masks``
    applied to its arrays (None passes through)."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, MultiDataSet,
    )

    def opt(fn, a):
        return None if a is None else fn(a)

    if isinstance(batch, DataSet):
        return DataSet(opt(features, batch.features),
                       opt(labels, batch.labels),
                       opt(masks, batch.features_mask),
                       opt(masks, batch.labels_mask))
    if isinstance(batch, MultiDataSet):
        fm, lm = (None if m is None else [opt(masks, a) for a in m]
                  for m in (batch.features_masks, batch.labels_masks))
        return MultiDataSet([opt(features, a) for a in batch.features],
                            [opt(labels, a) for a in batch.labels], fm, lm)
    raise TypeError(f"cannot cut a {type(batch).__name__}")


def take_rows(batch, rows):
    """A DataSet's or MultiDataSet's rows ``rows``, a slice or an index
    array (masks too)."""
    def cut(a):
        return a[rows]
    return _map_batch(batch, cut, cut, cut)


def take_steps(batch, T: int, steps: slice):
    """A batch's time steps ``steps`` of its length-``T`` series: the
    rank-3 features and labels of that T and its ``[B, T]`` masks; every
    other array whole."""
    def series(a):
        return a[:, steps] if len(a.shape) == 3 and a.shape[1] == T else a

    def mask(a):
        return a[:, steps] if len(a.shape) == 2 and a.shape[1] == T else a
    return _map_batch(batch, series, series, mask)
