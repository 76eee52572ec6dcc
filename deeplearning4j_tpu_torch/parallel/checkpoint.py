"""Sharded checkpoints (the JAX package's ``parallel/checkpoint.py``): each
process writes only its own shards, and the directory interchanges with
the JAX package's, file for file and key for key:

    <dir>/
      manifest.json      — leaf paths, shapes, dtypes, specs, the process
                           count and the topology record
      shards_p<K>.npz    — process K's shards, keyed "<leaf>|<index>"
      manifest_p<K>.json — process K's shard metadata (multi-process)
      done_p<K>.json     — process K's commit vote: its shard file's CRC
                           (multi-process)
      COMMIT             — written last, by process 0 only, once every
                           shard file has landed; carries their CRC-32s

Every file is committed atomically (``resilience/atomic.py``) and
``restore_sharded`` refuses a directory without ``COMMIT``, so a reader
never assembles a half-written step; a bit-flipped or truncated shard
file raises ``CheckpointError`` naming it.

A leaf is a tensor, a numpy array or a number, written whole by process
0 (the replicated params, the counts); or a :class:`RowShard`, this
rank's ``[1, chunk]`` row of a ``(dp, chunk)`` ZeRO leaf, written by
every rank with the JAX package's spec ``["data", None]`` and index
``[[r, r + 1], [0, chunk]]``. Leaf keys are the JAX package's
``"/"``-joined tree paths (``_leaf_key``): list indices and dict keys;
``CheckpointManager`` keys the updater state by optax's paths
(``Updater.optax_paths``: ``opt_state/0/.mu/<layer>/<param>``,
``opt_state/1/.count``).

Restore modes:
- ``restore_sharded(dir, None)``      -> host numpy arrays, fully
  assembled, nested by the leaf paths;
- ``restore_sharded(dir, mesh_ctx)``  -> tensors on the mesh's device,
  a ``["data", ...]`` leaf as this rank's row when the widths match;
- ``restore_sharded_into(dir, template, ...)`` -> the template's
  structure, ``reshard_zero1=True`` un-padding ``(dp_old, chunk)`` views
  into whole-shape template leaves (a restore at another width).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.atomic import (
    CheckpointError, atomic_path, atomic_write_bytes, crc32_file,
)

MANIFEST = "manifest.json"
COMMIT = "COMMIT"


class RowShard:
    """Rank ``rank``'s row ``local`` (``[1, chunk]``) of an ``(n, chunk)``
    leaf laid out over the data axis."""

    def __init__(self, local: torch.Tensor, rank: int, n: int):
        self.local, self.rank, self.n = local, int(rank), int(n)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, int(self.local.shape[-1]))


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(leaf key, leaf) of a nested dict / list / tuple, the keys the JAX
    package's ``_leaf_key`` gives the same tree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += _paths(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _paths(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (bf16 as float32, exactly)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _full_index(shape) -> list:
    return [[0, int(d)] for d in shape]


def _world() -> Tuple[int, int]:
    from deeplearning4j_tpu_torch.parallel import multihost
    return (multihost.process_index(),
            multihost.process_count())


def save_sharded(ckpt_dir: Union[str, Path], pytree: Any, mesh_ctx=None,
                 commit_timeout: float = 120.0,
                 topology: Optional[dict] = None) -> None:
    """Write this process's shards and, on process 0, the manifest and —
    once every process's shards have landed — the COMMIT marker. Every
    process of the group calls it with the same tree (each holding its
    own rows of the ``RowShard`` leaves). ``topology`` (dp width,
    weight-update-sharding mode, process count) is stored in the
    manifest, so a restore at another width is detected up front."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    proc, nproc = _world()
    # a previous save's artifacts in this directory would corrupt the
    # commit protocol: every process drops its own vote, process 0 the
    # COMMIT and the votes of ranks beyond the current world
    (ckpt_dir / f"done_p{proc}.json").unlink(missing_ok=True)
    (ckpt_dir / f"manifest_p{proc}.json").unlink(missing_ok=True)
    if proc == 0:
        (ckpt_dir / COMMIT).unlink(missing_ok=True)
        for stale in list(ckpt_dir.glob("done_p*.json")) + \
                list(ckpt_dir.glob("manifest_p*.json")):
            try:
                k = int(stale.name.split("_p")[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            if k >= nproc:
                stale.unlink(missing_ok=True)

    shard_name = f"shards_p{proc}.npz"
    manifest: Dict[str, Any] = {
        "format": "deeplearning4j_tpu/sharded-checkpoint",
        "version": 2, "process_count": nproc, "treedef": None,
        "leaves": {}}
    if topology is not None:
        manifest["topology"] = dict(topology)
    arrays: Dict[str, np.ndarray] = {}
    for key, leaf in _paths(pytree):
        skey = f"{key}|0"
        if isinstance(leaf, RowShard):
            data = _host(leaf.local)
            shape = leaf.shape
            spec = ["data", None]
            index = [[leaf.rank, leaf.rank + 1], [0, shape[1]]]
        else:
            if proc != 0:
                continue   # a whole leaf is process 0's to write
            data = _host(leaf)
            shape = tuple(data.shape)
            spec = [] if mesh_ctx is not None else None
            index = _full_index(shape)
        arrays[skey] = data
        manifest["leaves"][key] = {
            "shape": list(shape), "dtype": str(data.dtype), "spec": spec,
            "shards": [{"file": shard_name, "key": skey, "index": index}]}
    with atomic_path(ckpt_dir / shard_name) as tmp:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        shard_crc = crc32_file(tmp)
    if nproc > 1:
        atomic_write_bytes(ckpt_dir / f"manifest_p{proc}.json",
                           json.dumps(manifest).encode())
        atomic_write_bytes(ckpt_dir / f"done_p{proc}.json",
                           json.dumps({"file": shard_name,
                                       "crc32": shard_crc}).encode())
    if proc != 0:
        return
    atomic_write_bytes(ckpt_dir / MANIFEST,
                       json.dumps(manifest, indent=1).encode())
    files = {shard_name: shard_crc}
    deadline = time.monotonic() + commit_timeout
    missing = set(range(1, nproc))
    while missing:
        for k in sorted(missing):
            vote_path = ckpt_dir / f"done_p{k}.json"
            if vote_path.exists():
                vote = json.loads(vote_path.read_text())
                files[vote["file"]] = vote["crc32"]
                missing.discard(k)
        if not missing:
            break
        if time.monotonic() > deadline:
            raise CheckpointError(
                f"checkpoint {ckpt_dir}: processes {sorted(missing)} never "
                f"landed their shards within {commit_timeout:.0f}s — NOT "
                "committing a partial checkpoint")
        time.sleep(0.05)
    # the transaction point: COMMIT appears only over a complete set
    atomic_write_bytes(ckpt_dir / COMMIT, json.dumps(
        {"version": 1, "process_count": nproc, "files": files}).encode())


def verify_sharded(ckpt_dir: Union[str, Path]) -> dict:
    """Integrity gate: the COMMIT marker, every committed shard file with a
    matching CRC-32, a parseable manifest. Raises ``CheckpointError``
    naming the first bad file; returns the COMMIT record. A version-1
    directory (before the COMMIT protocol) restores unverified."""
    ckpt_dir = Path(ckpt_dir)
    mpath, commit_path = ckpt_dir / MANIFEST, ckpt_dir / COMMIT
    if not commit_path.exists():
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, ValueError):
            manifest = None
        if manifest is not None and manifest.get("version", 1) < 2:
            return {"version": 0, "files": {}}
        raise CheckpointError(
            f"checkpoint {ckpt_dir}: missing {COMMIT} marker — the save "
            "never completed (torn multi-process write)")
    try:
        commit = json.loads(commit_path.read_text())
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {ckpt_dir}: {COMMIT} marker unreadable: "
            f"{e}") from e
    for fname, want in commit.get("files", {}).items():
        fp = ckpt_dir / fname
        if not fp.exists():
            raise CheckpointError(
                f"checkpoint {ckpt_dir}: committed shard file {fname!r} "
                "is missing")
        got = crc32_file(fp)
        if got != want:
            raise CheckpointError(
                f"checkpoint {ckpt_dir}: shard file {fname!r} checksum "
                f"mismatch (got {got:#010x}, COMMIT {want:#010x}) — "
                "truncated or bit-flipped write")
    if not mpath.exists():
        raise CheckpointError(f"checkpoint {ckpt_dir}: missing {MANIFEST}")
    try:
        json.loads(mpath.read_text())
    except ValueError as e:
        raise CheckpointError(
            f"checkpoint {ckpt_dir}: {MANIFEST} is corrupt: {e}") from e
    return commit


def _merge_manifests(ckpt_dir: Path, verify: bool = True) -> dict:
    if verify:
        verify_sharded(ckpt_dir)
    manifest = json.loads((ckpt_dir / MANIFEST).read_text())
    if manifest.get("process_count", 1) > 1:
        for pf in sorted(ckpt_dir.glob("manifest_p*.json")):
            part = json.loads(pf.read_text())
            for key, meta in part["leaves"].items():
                known = {(s["file"], s["key"])
                         for s in manifest["leaves"][key]["shards"]}
                for s in meta["shards"]:
                    if (s["file"], s["key"]) not in known:
                        manifest["leaves"][key]["shards"].append(s)
    return manifest


def _load_npz(ckpt_dir: Path, fname: str):
    try:
        return np.load(ckpt_dir / fname)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {ckpt_dir}: shard file {fname!r} is "
            f"unreadable: {e}") from e


def _assemble(ckpt_dir: Path, meta: dict, npz_cache: Dict[str, Any]
              ) -> np.ndarray:
    out = np.zeros(tuple(meta["shape"]), dtype=meta["dtype"])
    covered = (np.zeros(tuple(meta["shape"]), dtype=bool)
               if meta["shape"] else None)
    for s in meta["shards"]:
        if s["file"] not in npz_cache:
            npz_cache[s["file"]] = _load_npz(ckpt_dir, s["file"])
        idx = tuple(slice(a, b) for a, b in s["index"])
        out[idx] = npz_cache[s["file"]][s["key"]]
        if covered is not None:
            covered[idx] = True
    if covered is not None and not covered.all():
        raise IOError(
            f"Checkpoint shard coverage incomplete for a leaf of shape "
            f"{meta['shape']} — missing process shard files?")
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return tree


def restore_sharded(ckpt_dir: Union[str, Path], mesh_ctx=None,
                    verify: bool = True) -> Dict[str, Any]:
    """A sharded checkpoint as a nested dict (keys split at ``/``): host
    numpy arrays, or with ``mesh_ctx`` tensors on its device, a leaf
    saved over the data axis as this rank's row when the checkpoint's
    width is the mesh's. Verifies the COMMIT marker and the shard
    checksums first (``verify=False`` when the caller just did)."""
    ckpt_dir = Path(ckpt_dir)
    manifest = _merge_manifests(ckpt_dir, verify=verify)
    cache: Dict[str, Any] = {}
    flat: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        arr = _assemble(ckpt_dir, meta, cache)
        if mesh_ctx is not None:
            t = torch.from_numpy(arr).to(mesh_ctx.device)
            if ((meta.get("spec") or [None])[0] == "data"
                    and t.dim() == 2 and t.shape[0] == mesh_ctx.world):
                t = t[mesh_ctx.rank:mesh_ctx.rank + 1].clone()
            arr = t
        flat[key] = arr
    return _nest(flat)


def read_topology(ckpt_dir: Union[str, Path]) -> Optional[dict]:
    """The topology recorded at save time ({"dp", "weight_update_sharding",
    "process_count", ...}), or None for a checkpoint without one. Reads
    the manifest only."""
    try:
        return json.loads((Path(ckpt_dir) / MANIFEST).read_text()).get(
            "topology")
    except (OSError, ValueError):
        return None


def _reshard_flat_leaf(key: str, arr: np.ndarray, shape, dtype
                       ) -> np.ndarray:
    """A saved ``(dp_old, chunk)`` ZeRO view of a leaf of ``shape``, the
    padding tail dropped: the whole leaf, bit for bit, for a restore at
    another width (the new trainer re-lays it out when it attaches)."""
    size = int(np.prod(shape)) if shape else 1
    if (arr.ndim != 2 or arr.size < size
            or arr.size - size >= arr.shape[0]
            or np.dtype(arr.dtype) != np.dtype(dtype)):
        raise CheckpointError(
            f"leaf {key!r}: checkpoint shape {tuple(arr.shape)} is not a "
            f"zero1 (dp, chunk) view of template shape {tuple(shape)} — "
            "cannot reshard across this width change")
    return arr.reshape(-1)[:size].reshape(shape)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, RowShard):
        leaf = leaf.local
    if isinstance(leaf, torch.Tensor):
        return np.dtype("float32" if leaf.dtype == torch.bfloat16
                        else str(leaf.dtype).split(".")[-1])
    return np.asarray(leaf).dtype if not isinstance(leaf, int) \
        else np.dtype("int32")


def restore_sharded_into(ckpt_dir: Union[str, Path], template: Any,
                         mesh_ctx=None, verify: bool = True,
                         reshard_zero1: bool = False) -> Any:
    """Restore into the structure of ``template``, each leaf looked up by
    its path: a tensor leaf comes back as a tensor on the template's
    device and dtype, a ``RowShard`` as its rank's row, a number as a
    number. Shapes must match the checkpoint's; ``reshard_zero1=True``
    un-pads a saved ``(dp_old, chunk)`` ZeRO view into a template leaf of
    the whole shape (a restore across a data-parallel width change)."""
    ckpt_dir = Path(ckpt_dir)
    manifest = _merge_manifests(ckpt_dir, verify=verify)
    cache: Dict[str, Any] = {}
    values: Dict[str, Any] = {}
    for key, leaf in _paths(template):
        if key not in manifest["leaves"]:
            raise KeyError(f"Checkpoint has no leaf {key!r}")
        meta = manifest["leaves"][key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        arr = _assemble(ckpt_dir, meta, cache)
        if tuple(meta["shape"]) != shape:
            if not reshard_zero1 or isinstance(leaf, RowShard):
                raise ValueError(
                    f"Leaf {key!r}: checkpoint shape "
                    f"{tuple(meta['shape'])} != template shape {shape}")
            arr = _reshard_flat_leaf(key, arr, shape, _np_dtype(leaf))
        if isinstance(leaf, RowShard):
            row = torch.from_numpy(np.ascontiguousarray(
                arr[leaf.rank:leaf.rank + 1]))
            values[key] = RowShard(row.to(leaf.local.device,
                                          leaf.local.dtype),
                                   leaf.rank, leaf.n)
        elif isinstance(leaf, torch.Tensor):
            values[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                leaf.device, leaf.dtype)
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            values[key] = int(arr)
        else:
            values[key] = arr
    return _unflatten(template, values)
