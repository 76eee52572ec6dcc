"""The data-parallel mesh over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``), and the collectives the parallel trainers issue.

The JAX package names a device mesh with ``data`` and ``model`` axes and
lets XLA insert the collectives. The port runs one process per rank: a
``MeshContext``'s ``data`` axis is the world of a ``torch.distributed``
process group, and this module is the one place that issues its
collectives (``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``broadcast``). With no process group
initialized the mesh is world 1 and issues no collective at all; a group
of world 1 (NCCL on one card) issues them, and each is an identity.

Tensor and sequence parallelism (``n_model > 1``, ``n_seq > 1``) are not
ported (ROADMAP A6.2).

Each rank trains on its ``local_batch_slice`` of the global batch (the
JAX package's multi-process contract): ``shard_batch`` and
``local_rows`` take this rank's rows, ``shard_params`` keeps a full
replica on the rank. A batch whose rows do not divide by the world is
refused: each rank's mean over its B/dp rows, averaged over the ranks,
is the global mean only because the ranks hold equal rows.

The weight-update layout (``WeightUpdateSharding``) and its per-leaf
helpers (``zero1_chunk`` / ``zero1_shard_leaf`` / ``zero1_unshard_leaf``)
are the JAX package's: each leaf flattened, padded to a multiple of dp
and viewed as ``(dp, chunk)``, row ``r`` owned by rank ``r``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

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
    """(world, rank, a group is initialized)."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0, False
    return dist.get_world_size(group), dist.get_rank(group), True


@dataclass
class MeshContext:
    """The data axis over a ``torch.distributed`` group, and the device
    this rank trains on. ``group=None`` is the default group."""

    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    distributed: bool = False
    data_axis: str = "data"

    @staticmethod
    def create(n_data: Optional[int] = None, n_model: int = 1,
               n_seq: int = 1, device=None, group=None) -> "MeshContext":
        """The data axis over ``group`` (the default process group), on
        ``device`` (``None``: the CUDA card, raising without one;
        ``"cpu"`` for the CPU): one rank, one device. ``n_data`` must be
        the group's world when given. ``n_model > 1`` / ``n_seq > 1``
        raise: tensor and sequence parallelism are not ported (ROADMAP
        A6.2)."""
        if n_model > 1 or n_seq > 1:
            raise NotImplementedError(
                f"n_model={n_model}, n_seq={n_seq}: tensor and sequence "
                "parallelism are not ported yet (ROADMAP A6.2)")
        device = resolve_device(device)
        world, rank, distributed = _group_world(group)
        if n_data is not None and n_data != world:
            raise ValueError(
                f"n_data={n_data}, but the process group has world "
                f"{world}: one rank is one data replica")
        if distributed and device.type == "cpu" and \
                dist.get_backend(group) == "nccl":
            raise ValueError("an nccl process group cannot reduce CPU "
                             "tensors; initialize a gloo group for "
                             "device='cpu'")
        return MeshContext(world=world, rank=rank, device=device,
                           group=group, distributed=distributed)

    @property
    def n_data(self) -> int:
        return self.world

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.distributed else None

    def zero1_shards(self, axis: Optional[str] = None) -> int:
        """Number of weight-update shards = the data axis' size."""
        return self.world

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
        if self.world < 2:
            raise ValueError(
                f"{wus.mode} weight-update sharding needs at least 2 "
                f"replicas on axis {wus.axis!r} (mesh has {self.world}) "
                "— with dp=1 there is nothing to shard; use mode='off'")

    # -------------------------------------------------------------- placement
    def shard_params(self, params):
        """Replicate on the rank: every tensor on this rank's device (a
        tensor already there is kept as it is, in place)."""
        from deeplearning4j_tpu_torch.nn.updater import tree_map
        return tree_map(lambda t: t.to(self.device), params)

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch`` rows."""
        if global_batch % self.world:
            raise ValueError(
                f"global batch {global_batch} not divisible by the "
                f"{self.world}-way data axis")
        per = global_batch // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, *arrays):
        """This rank's rows of each array (None passes through)."""
        out = []
        for a in arrays:
            out.append(None if a is None
                       else a[self.batch_slice(int(a.shape[0]))])
        return tuple(out) if len(out) > 1 else out[0]

    def local_rows(self, batch):
        """``batch`` (a DataSet or MultiDataSet) cut to this rank's rows;
        the batch itself at world 1."""
        if self.world == 1:
            return batch
        return take_rows(batch, self.batch_slice(batch.num_examples()))

    # ------------------------------------------------------------ collectives
    def all_reduce_(self, t: Tensor, op: str = "sum") -> Tensor:
        """``t`` reduced over the data axis, in place (``op``: "sum" or
        "max")."""
        if self.distributed:
            dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                                   else dist.ReduceOp.SUM),
                            group=self.group)
        return t

    def reduce_scatter(self, flat: Tensor) -> Tensor:
        """The sum over the data axis of ``flat`` (``world * n``
        elements), this rank's ``n``-element slice of it."""
        n = flat.numel() // self.world
        if not self.distributed:
            return flat.clone()
        out = torch.empty(n, dtype=flat.dtype, device=flat.device)
        _REDUCE_SCATTER(out, flat, group=self.group)
        return out

    def all_gather(self, row: Tensor) -> Tensor:
        """Every rank's ``row`` concatenated in rank order."""
        if not self.distributed:
            return row.clone()
        out = torch.empty(row.numel() * self.world, dtype=row.dtype,
                          device=row.device)
        _ALL_GATHER(out, row.contiguous(), group=self.group)
        return out

    def broadcast_(self, t: Tensor, src: int = 0) -> Tensor:
        """``t`` from rank ``src`` on every rank, in place."""
        if self.distributed:
            dist.broadcast(t, src=dist.get_global_rank(self.group, src)
                           if self.group is not None else src,
                           group=self.group)
        return t

    def any_flag(self, flag: Tensor) -> Tensor:
        """A bool flag set on any rank, on every rank (all-reduce MAX)."""
        if not self.distributed:
            return flag
        x = flag.to(torch.uint8).reshape(1)
        self.all_reduce_(x, "max")
        return x.reshape(()).bool()

    def mean_(self, tensors: Sequence[Tensor]) -> None:
        """Each tensor replaced by its mean over the data axis, in place,
        through one all-reduce of their concatenation (a no-op at world
        1)."""
        tensors = [t for t in tensors if t.is_floating_point()]
        if not self.distributed or not tensors:
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        self.all_reduce_(flat).div_(self.world)
        copy_flat_into(flat, tensors)


def copy_flat_into(flat: Tensor, tensors: Sequence[Tensor]) -> None:
    """Write consecutive slices of ``flat`` into ``tensors`` in place (each
    cast to its own dtype)."""
    parts = flat.split([t.numel() for t in tensors])
    with torch.no_grad():
        for p, t in zip(parts, tensors):
            t.copy_(p.view(t.shape))


def take_rows(batch, rows: slice):
    """A DataSet's or MultiDataSet's rows ``rows`` (masks too)."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, MultiDataSet,
    )

    def cut(a):
        return None if a is None else a[rows]

    if isinstance(batch, DataSet):
        return DataSet(cut(batch.features), cut(batch.labels),
                       cut(batch.features_mask), cut(batch.labels_mask))
    if isinstance(batch, MultiDataSet):
        lists = (None if m is None else [cut(a) for a in m]
                 for m in (batch.features_masks, batch.labels_masks))
        fm, lm = lists
        return MultiDataSet([cut(a) for a in batch.features],
                            [cut(a) for a in batch.labels], fm, lm)
    raise TypeError(f"cannot take rows of {type(batch).__name__}")
