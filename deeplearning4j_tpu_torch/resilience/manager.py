"""CheckpointManager: retention, rotation and latest-valid discovery (the
JAX package's ``resilience/manager.py``).

``save`` writes one checkpoint per training step through the crash-safe
writers (``util/serializer.py``'s zip on one process,
``parallel/checkpoint.py``'s sharded directory on a data-parallel group)
plus a *training cursor*: the small JSON record (epoch, step, data
position) that turns a weights file into a resumable run.

``latest_valid`` walks the checkpoints newest first and returns the first
that passes full verification (zip member checksums; the sharded COMMIT
marker and per-file CRCs), skipping torn or corrupt writes: a run that
died mid-write resumes from the previous intact checkpoint.

The files are the JAX package's: a sharded directory's leaves are keyed
by the JAX tree paths (the updater state by optax's,
``Updater.optax_paths``), and a cursor is the same JSON. A JAX cursor's
``rng_key`` names a JAX PRNG key, which the port cannot use; the port
keeps its generator's state in ``extra["torch_rng"]`` and writes
``rng_key`` as null. A ZeRO trainer's moments are saved as this rank's
rows (``RowShard``); restored into a net with whole moments at another
width through ``restore(..., reshard=True)``.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from deeplearning4j_tpu_torch.nn.updater import tree_map
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience.atomic import (
    CheckpointError, atomic_write_bytes,
)

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"-(\d+)(?:\.zip)?$")

#: the weight-update layouts whose updater state is saved as rows
SHARDED_WUS_MODES = ("zero1", "zero2")


@dataclass
class TrainingCursor:
    """Where training stood when the checkpoint was cut. ``step`` is the
    container's ``iteration_count``; ``data_position`` counts the batches
    of the current epoch already consumed (a resume skips them);
    ``topology`` records the mesh the checkpoint was cut on ({"dp",
    "weight_update_sharding", "process_count", "rendezvous_epoch"});
    ``extra["torch_rng"]`` the net's generator state, so a resumed run
    draws the dropout masks the uninterrupted one would have."""

    epoch: int = 0
    step: int = 0
    data_position: int = 0
    rng_key: Optional[List[int]] = None
    topology: Optional[Dict[str, Any]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"version": 1, "epoch": self.epoch,
                           "step": self.step,
                           "data_position": self.data_position,
                           "rng_key": self.rng_key,
                           "topology": self.topology, "extra": self.extra})

    @staticmethod
    def from_json(text: str) -> "TrainingCursor":
        d = json.loads(text)
        return TrainingCursor(epoch=int(d.get("epoch", 0)),
                              step=int(d.get("step", 0)),
                              data_position=int(d.get("data_position", 0)),
                              rng_key=d.get("rng_key"),
                              topology=d.get("topology"),
                              extra=d.get("extra", {}))

    @staticmethod
    def of(net, epoch: Optional[int] = None,
           data_position: int = 0) -> "TrainingCursor":
        cur = TrainingCursor(
            epoch=net.epoch_count if epoch is None else epoch,
            step=net.iteration_count, data_position=data_position)
        gen = getattr(net, "_rng", None)
        if gen is not None:
            cur.extra["torch_rng"] = gen.get_state().tolist()
        return cur

    def apply(self, net) -> None:
        net.iteration_count = self.step
        net.epoch_count = self.epoch
        state = self.extra.get("torch_rng")
        if state is not None and getattr(net, "_rng", None) is not None:
            net._rng.set_state(torch.tensor(state, dtype=torch.uint8))


@dataclass
class CheckpointInfo:
    step: int
    path: Path
    cursor: Optional[TrainingCursor]
    sharded: bool
    # set by latest_valid() after full verification; restore() skips the
    # re-verify (a full CRC pass over every file) then
    verified: bool = False


def checkpoint_tree(net, with_updater: bool = True) -> Dict[str, Any]:
    """``{"params", "opt_state", "states"}`` keyed as the JAX package's
    sharded checkpoint keys a net: the updater state as optax's tree
    (``Updater.optax_paths``; one count tensor or int under every count
    path), a ZeRO trainer's moments as this rank's rows."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import RowShard
    tree: Dict[str, Any] = {"params": net.params, "states": net.states}
    if not with_updater or net.opt_state is None:
        return tree
    zero = getattr(net, "_zero_shards", None)
    opt: Dict[str, Any] = {}
    tx = net._tx
    for entry, path in zip(tx.optax_layout(), tx.optax_paths()):
        node = opt
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if entry == "count":
            node[parts[-1]] = net.opt_state["count"]
        else:
            node[parts[-1]] = (net.opt_state[entry] if zero is None else
                               tree_map(lambda t: RowShard(t, *zero),
                                        net.opt_state[entry]))
    tree["opt_state"] = opt
    return tree


@torch.no_grad()
def _write_back(net, template: Dict[str, Any], out: Dict[str, Any]) -> None:
    """Copy a restored tree into the net's own tensors in place (a served
    net's CUDA graphs and a ZeRO trainer's row views stay valid)."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import RowShard, _paths
    got = dict(_paths(out))
    count = None
    for key, dst in _paths(template):
        src = got[key]
        if isinstance(dst, RowShard):
            dst.local.copy_(src.local)
        elif isinstance(dst, torch.Tensor):
            if key.endswith("/.count"):
                count = src
            else:
                dst.copy_(src)
        elif key.endswith("/.count"):
            count = src
    if count is not None:
        if isinstance(net.opt_state["count"], torch.Tensor):
            net.opt_state["count"].fill_(int(count))
        else:
            net.opt_state["count"] = int(count)


class CheckpointManager:
    """Rotating, self-validating checkpoint store for one training run.
    ``sharded=False``: one zip archive per checkpoint (one process).
    ``sharded=True``: one directory per checkpoint in the sharded format;
    every rank of the group calls ``save`` and ``restore`` together."""

    def __init__(self, directory: Union[str, Path], keep_last: int = 3,
                 prefix: str = "ckpt", sharded: bool = False,
                 mesh_ctx=None, save_updater: bool = True,
                 weight_update_sharding: Optional[str] = None,
                 commit_timeout: float = 120.0):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = max(1, int(keep_last))
        self.prefix = prefix
        self.sharded = sharded
        self.mesh_ctx = mesh_ctx
        self.save_updater = save_updater
        self.weight_update_sharding = str(
            getattr(weight_update_sharding, "mode",
                    weight_update_sharding or "off")).lower()
        self.commit_timeout = float(commit_timeout)
        reg = get_registry()
        self._c_saved = reg.counter("resilience_checkpoints_saved_total",
                                    help="checkpoints committed")
        self._c_invalid = reg.counter(
            "resilience_invalid_checkpoints_total",
            help="torn/corrupt checkpoints skipped by latest_valid")

    # ----------------------------------------------------------------- naming
    def _name(self, step: int) -> str:
        return f"{self.prefix}-{step:08d}"

    def _cursor_path(self, path: Path) -> Path:
        if self.sharded:
            return path / "cursor.json"
        return path.with_name(path.name[:-len(".zip")] + ".cursor.json")

    def checkpoints(self) -> List[CheckpointInfo]:
        """All on-disk checkpoints (valid or not), step-ascending."""
        out = []
        pattern = (f"{self.prefix}-*" if self.sharded
                   else f"{self.prefix}-*.zip")
        for p in sorted(self.directory.glob(pattern)):
            if self.sharded and not p.is_dir():
                continue
            m = _STEP_RE.search(p.name)
            if not m:
                continue
            out.append(CheckpointInfo(step=int(m.group(1)), path=p,
                                      cursor=self._read_cursor(p),
                                      sharded=self.sharded))
        out.sort(key=lambda i: i.step)
        return out

    def _read_cursor(self, path: Path) -> Optional[TrainingCursor]:
        try:
            return TrainingCursor.from_json(
                self._cursor_path(path).read_text())
        except (OSError, ValueError, KeyError):
            return None

    # --------------------------------------------------------------- topology
    def topology(self) -> Dict[str, Any]:
        """The mesh checkpoints cut by this manager run on: data-parallel
        width, weight-update-sharding mode, process count and the
        rendezvous epoch (0: the elastic runtime is ROADMAP A6.3)."""
        from deeplearning4j_tpu_torch.parallel import multihost
        dp = int(self.mesh_ctx.n_data) if self.mesh_ctx is not None else 1
        return {"dp": dp,
                "weight_update_sharding": self.weight_update_sharding,
                "process_count": multihost.process_count(),
                "rendezvous_epoch": 0}

    def _check_topology(self, info: CheckpointInfo, reshard: bool) -> bool:
        """True when the restore must un-pad ZeRO rows into whole-shape
        moments; raises ``CheckpointError`` when the widths differ and the
        caller did not ask for that."""
        if not self.sharded:
            return False   # a zip holds whole moments: any width
        saved = info.cursor.topology if info.cursor is not None else None
        if saved is None:
            from deeplearning4j_tpu_torch.parallel.checkpoint import (
                read_topology,
            )
            saved = read_topology(info.path)
        if not saved:
            return bool(reshard)
        saved_mode = str(saved.get("weight_update_sharding", "off"))
        if saved_mode not in SHARDED_WUS_MODES:
            return False   # replicated layouts restore at any width
        if reshard:
            return True
        cur = self.topology()
        if int(saved.get("dp", 1)) == cur["dp"]:
            return False
        raise CheckpointError(
            f"checkpoint {info.path} was cut at dp={saved.get('dp')} "
            f"(weight_update_sharding={saved_mode}, "
            f"{saved.get('process_count')} processes) but is being "
            f"restored at dp={cur['dp']} "
            f"(weight_update_sharding={cur['weight_update_sharding']}) "
            "— the sharded updater state is laid out for the old width. "
            "Restore with reshard=True into a net holding whole moments, "
            "then attach the new-width trainer.")

    # ------------------------------------------------------------------- save
    def save(self, net, step: Optional[int] = None,
             cursor: Optional[TrainingCursor] = None) -> Path:
        """Commit one checkpoint (and its cursor) and rotate old ones. A
        kill at any point leaves either no new checkpoint or a complete,
        verifiable one."""
        step = net.iteration_count if step is None else int(step)
        cursor = TrainingCursor.of(net) if cursor is None else cursor
        if cursor.topology is None:
            cursor.topology = self.topology()
        name = self._name(step)
        with get_tracer().span("checkpoint_save", step=step):
            if self.sharded:
                from deeplearning4j_tpu_torch.parallel.checkpoint import (
                    save_sharded,
                )
                path = self.directory / name
                save_sharded(path, checkpoint_tree(net, self.save_updater),
                             self.mesh_ctx,
                             commit_timeout=self.commit_timeout,
                             topology=cursor.topology)
            else:
                if getattr(net, "_zero_shards", None):
                    raise ValueError(
                        "the net holds ZeRO rows of its updater state; "
                        "call the trainer's gather_opt_state() before a "
                        "zip checkpoint, or use sharded=True")
                from deeplearning4j_tpu_torch.util.serializer import (
                    ModelSerializer,
                )
                path = self.directory / (name + ".zip")
                ModelSerializer.write_model(net, path,
                                            save_updater=self.save_updater)
            # one writer for the cursor (rank 0), after the COMMIT: a
            # cursor on disk always describes a committed checkpoint
            from deeplearning4j_tpu_torch.parallel import multihost
            if not self.sharded or \
                    multihost.process_index() == 0:
                atomic_write_bytes(self._cursor_path(path),
                                   cursor.to_json().encode())
        self._c_saved.inc()
        self._rotate(keep=path)
        return path

    def _rotate(self, keep: Path) -> None:
        from deeplearning4j_tpu_torch.parallel import multihost
        if self.sharded and multihost.process_index() != 0:
            return   # rank 0 rotates the shared directory
        for info in self.checkpoints()[:-self.keep_last]:
            if info.path == keep:
                continue
            try:
                if info.sharded:
                    shutil.rmtree(info.path, ignore_errors=True)
                else:
                    info.path.unlink(missing_ok=True)
                self._cursor_path(info.path).unlink(missing_ok=True)
            except OSError as e:   # rotation must never kill training
                logger.warning("checkpoint rotation failed for %s: %s",
                               info.path, e)

    # ----------------------------------------------------------- verification
    def validate(self, path: Union[str, Path]) -> None:
        """Raise ``CheckpointError`` (naming the bad file) unless the
        checkpoint at ``path`` is complete and checksum-clean."""
        path = Path(path)
        if self.sharded:
            from deeplearning4j_tpu_torch.parallel.checkpoint import (
                verify_sharded,
            )
            verify_sharded(path)
        else:
            from deeplearning4j_tpu_torch.util.serializer import (
                ModelSerializer,
            )
            ModelSerializer.verify(path)

    def latest_valid(self) -> Optional[CheckpointInfo]:
        """The newest checkpoint that passes verification; torn or corrupt
        ones are skipped (and counted), never returned."""
        for info in reversed(self.checkpoints()):
            try:
                self.validate(info.path)
                info.verified = True
                return info
            except CheckpointError as e:
                self._c_invalid.inc()
                get_tracer().instant("invalid_checkpoint",
                                     path=str(info.path))
                logger.warning("skipping invalid checkpoint %s: %s",
                               info.path, e)
        return None

    # ---------------------------------------------------------------- restore
    def restore(self, net, info: Optional[CheckpointInfo] = None,
                load_updater: bool = True,
                reshard: bool = False) -> Optional[TrainingCursor]:
        """Load ``info`` (default: the latest valid) into an initialized
        ``net``, in place, and apply its cursor. Returns the cursor (None
        when no valid checkpoint exists: the caller starts fresh).
        ``reshard=True`` restores a ZeRO checkpoint cut at another width
        into a net holding whole moments (not one attached to a ZeRO
        trainer); without it a width change raises up front."""
        if info is None:
            info = self.latest_valid()
            if info is None:
                return None
        needs_reshard = self._check_topology(info, reshard)
        with get_tracer().span("checkpoint_restore", step=info.step,
                               reshard=needs_reshard):
            if self.sharded:
                from deeplearning4j_tpu_torch.parallel.checkpoint import (
                    restore_sharded_into,
                )
                tpl = checkpoint_tree(net, load_updater)
                out = restore_sharded_into(info.path, tpl, self.mesh_ctx,
                                           verify=not info.verified,
                                           reshard_zero1=needs_reshard)
                _write_back(net, tpl, out)
            else:
                from deeplearning4j_tpu_torch.util.serializer import (
                    ModelSerializer,
                )
                ModelSerializer.restore_weights(info.path, net,
                                                load_updater=load_updater)
        cursor = info.cursor or TrainingCursor(step=info.step)
        cursor.apply(net)
        return cursor
