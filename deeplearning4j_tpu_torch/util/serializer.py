"""Model checkpointing (the JAX package's ``util/serializer.py``): the
reference's zip (ref: util/ModelSerializer.java:79-110), member for member
the JAX package's, so an archive written by either package restores into
the other.

- ``configuration.json`` — the ``MultiLayerConfiguration`` or
  ``ComputationGraphConfiguration`` JSON (told apart by its ``format``
  tag);
- ``coefficients.bin`` — the float32 little-endian flat param vector in
  ``params_flat`` order (topological node order for a graph);
- ``layerStates.npz`` — the layers' states (batch norm's running
  ``mean`` / ``var``), keyed ``"<layer index or node name>:<name>"``;
- ``updaterState.bin`` + ``updaterState.json`` — the updater state as
  optax's flattened leaves (``Updater.optax_leaves``: int32 step counts
  and the moment trees in ``jax.tree_util`` order), each in its native
  dtype, with the v2 manifest ``{"version": 2, "leaves": [{"shape",
  "dtype"}, ...]}``; a bare-list (v1) manifest restores every leaf from
  ``<f4``;
- ``checksums.json`` — each member's CRC-32.

The archive is committed through ``atomic_path`` (tmp, fsync, rename), so
an interrupted write leaves the previous archive in place, and ``verify``
or a restore raises ``CheckpointError`` naming a torn, truncated or
bit-flipped member instead of returning garbage params.

The restore entry points build the net on the CUDA card unless the caller
passes ``device="cpu"``; with ``device=None`` and no card they raise.
Params, states and moments are written into the net's tensors in place.
"""

from __future__ import annotations

import io
import json
import zipfile
import zlib
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.convert import states_to_numpy
from deeplearning4j_tpu_torch.resilience.atomic import (
    CheckpointError, atomic_path, crc32_bytes,
)

PathLike = Union[str, Path]


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """``t``'s elements as little-endian bytes in its own dtype."""
    return (t.detach().contiguous().reshape(-1).view(torch.uint8)
            .cpu().numpy().tobytes())


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"updater leaf dtype {name!r} is unknown")
    return dt


class ModelSerializer:
    CONFIG_NAME = "configuration.json"
    COEFFICIENTS_NAME = "coefficients.bin"
    STATES_NAME = "layerStates.npz"
    UPDATER_NAME = "updaterState.bin"
    UPDATER_MANIFEST = "updaterState.json"
    CHECKSUMS_NAME = "checksums.json"

    @staticmethod
    def write_model(net, path: PathLike, save_updater: bool = True) -> None:
        """(ref: ModelSerializer.writeModel:79-110) — atomic commit: the
        previous archive at ``path`` stays intact until the new one is
        fully on disk."""
        from deeplearning4j_tpu_torch.parallel.tensor import step_mesh
        step_mesh(net)    # a net holding column shards raises
        members = {
            ModelSerializer.CONFIG_NAME: net.conf.to_json().encode(),
            ModelSerializer.COEFFICIENTS_NAME:
                net.params_flat().astype("<f4").tobytes(),
        }
        # a stack's states are a list (key: layer index), a graph's a
        # dict (key: node name)
        state_items = (net.states.items() if isinstance(net.states, dict)
                       else enumerate(net.states or []))
        state_buf = io.BytesIO()
        np.savez(state_buf, **{f"{i}:{k}": states_to_numpy(v)
                               for i, s in state_items
                               for k, v in s.items()})
        members[ModelSerializer.STATES_NAME] = state_buf.getvalue()
        if save_updater and net.opt_state is not None:
            leaves = net._tx.optax_leaves(net.opt_state)
            # a scalar count is stored with shape [1], as the JAX
            # package's writer (numpy's ascontiguousarray) stores it
            manifest = {"version": 2,
                        "leaves": [{"shape": list(t.shape) or [1],
                                    "dtype": str(t.dtype).split(".")[-1]}
                                   for t in leaves]}
            members[ModelSerializer.UPDATER_NAME] = b"".join(
                _tensor_bytes(t) for t in leaves)
            members[ModelSerializer.UPDATER_MANIFEST] = \
                json.dumps(manifest).encode()
        checksums = {name: crc32_bytes(data)
                     for name, data in members.items()}
        with atomic_path(Path(path)) as tmp:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
                for name, data in members.items():
                    z.writestr(name, data)
                z.writestr(ModelSerializer.CHECKSUMS_NAME,
                           json.dumps(checksums))

    # --------------------------------------------------------- verification
    @staticmethod
    def _read_member(z: zipfile.ZipFile, name: str, path: PathLike) -> bytes:
        """Read one member, mapping every decode failure to a
        ``CheckpointError`` that names the member."""
        try:
            return z.read(name)
        except KeyError:
            raise CheckpointError(
                f"checkpoint {path}: missing member {name!r}") from None
        except (zipfile.BadZipFile, zlib.error, OSError) as e:
            raise CheckpointError(
                f"checkpoint {path}: member {name!r} is corrupt "
                f"({e})") from e

    @staticmethod
    def _read_all(path: PathLike) -> Dict[str, bytes]:
        """Every member, each inflated once: ``zipfile`` checks a
        member's own CRC as it reads it, so this pass is the JAX
        package's ``testzip`` and its member reads in one."""
        try:
            with zipfile.ZipFile(path, "r") as z:
                return {name: ModelSerializer._read_member(z, name, path)
                        for name in z.namelist()}
        except CheckpointError:
            raise   # already names its member (and IS an OSError)
        except (zipfile.BadZipFile, OSError) as e:
            raise CheckpointError(
                f"checkpoint {path} is unreadable: {e}") from e

    @staticmethod
    def _check(members: Dict[str, bytes], path: PathLike) -> None:
        """The required members, and each member's CRC-32 against
        ``checksums.json``."""
        for req in (ModelSerializer.CONFIG_NAME,
                    ModelSerializer.COEFFICIENTS_NAME):
            if req not in members:
                raise CheckpointError(
                    f"checkpoint {path}: missing member {req!r}")
        if ModelSerializer.CHECKSUMS_NAME not in members:
            return
        sums = json.loads(members[ModelSerializer.CHECKSUMS_NAME])
        for name, want in sums.items():
            if name not in members:
                raise CheckpointError(
                    f"checkpoint {path}: missing member {name!r}")
            got = crc32_bytes(members[name])
            if got != want:
                raise CheckpointError(
                    f"checkpoint {path}: member {name!r} checksum "
                    f"mismatch (got {got:#010x}, manifest {want:#010x})")

    @staticmethod
    def verify(path: PathLike) -> None:
        """Full integrity check: the zip's structure, every member's CRC
        (the zip's own and ``checksums.json``'s) and the required
        members. Raises ``CheckpointError`` naming the first bad member;
        returns None when the archive is clean."""
        ModelSerializer._check(ModelSerializer._read_all(path), path)

    # -------------------------------------------------------------- restore
    @staticmethod
    def _updater_leaves(manifest, blob: bytes) -> List[torch.Tensor]:
        """The updater leaves on the host, by the v2 manifest (native
        dtypes) or a v1 bare list (every leaf stored as ``<f4``)."""
        if isinstance(manifest, dict):
            specs, legacy = manifest["leaves"], False
        else:
            specs, legacy = manifest, True
        raw = (torch.frombuffer(bytearray(blob), dtype=torch.uint8)
               if blob else torch.zeros(0, dtype=torch.uint8))
        leaves, pos = [], 0
        for spec in specs:
            shape = tuple(spec["shape"])
            dt = _dtype(spec["dtype"])
            stored = torch.float32 if legacy else dt
            nbytes = int(np.prod(shape, dtype=np.int64)) * stored.itemsize
            if pos + nbytes > raw.numel():
                raise CheckpointError(
                    f"member {ModelSerializer.UPDATER_NAME!r} holds "
                    f"{raw.numel()} bytes, its manifest more")
            # a fresh copy: the slice's offset need not be aligned
            leaf = raw[pos:pos + nbytes].clone().view(stored).reshape(shape)
            leaves.append(leaf.to(dt))
            pos += nbytes
        return leaves

    @staticmethod
    def _restore_into(members: Dict[str, bytes], net, load_updater: bool):
        """The params, states and updater state of both containers."""
        net.set_params_flat(np.frombuffer(
            bytearray(members[ModelSerializer.COEFFICIENTS_NAME]),
            dtype="<f4"))
        if ModelSerializer.STATES_NAME in members:
            data = np.load(io.BytesIO(members[ModelSerializer.STATES_NAME]))
            with torch.no_grad():
                for key in data.files:
                    i_s, name = key.split(":", 1)
                    idx = i_s if isinstance(net.states, dict) else int(i_s)
                    value = torch.from_numpy(data[key])
                    state = net.states[idx]
                    if (name in state
                            and state[name].shape == value.shape):
                        state[name].copy_(value)
                    else:
                        state[name] = value.to(net.device)
        if load_updater and ModelSerializer.UPDATER_NAME in members:
            manifest = json.loads(members[ModelSerializer.UPDATER_MANIFEST])
            net._tx.load_optax_leaves(
                net.opt_state, ModelSerializer._updater_leaves(
                    manifest, members[ModelSerializer.UPDATER_NAME]))
        return net

    @staticmethod
    def restore_weights(path: PathLike, net, load_updater: bool = True):
        """Restore params, states and the updater state from ``path`` into
        an existing initialized container, in place (no re-build; a
        served net's CUDA graphs stay valid). The members are read once,
        and their checksums verified first."""
        members = ModelSerializer._read_all(path)
        ModelSerializer._check(members, path)
        return ModelSerializer._restore_into(members, net, load_updater)

    @staticmethod
    def _config_json(path: PathLike) -> dict:
        try:
            with zipfile.ZipFile(Path(path), "r") as z:
                return json.loads(ModelSerializer._read_member(
                    z, ModelSerializer.CONFIG_NAME, path))
        except CheckpointError:
            raise
        except (zipfile.BadZipFile, OSError) as e:
            raise CheckpointError(
                f"checkpoint {path} is unreadable: {e}") from e

    @staticmethod
    def restore_multi_layer_network(path: PathLike, load_updater: bool = True,
                                    device=None):
        """(ref: ModelSerializer.restoreMultiLayerNetwork)"""
        from deeplearning4j_tpu_torch.nn.conf.builder import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        cfg = ModelSerializer._config_json(path)
        if "ComputationGraph" in cfg.get("format", ""):
            raise ValueError("Archive holds a ComputationGraph; use "
                             "restore_computation_graph")
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                                device=device).init()
        return ModelSerializer.restore_weights(path, net, load_updater)

    @staticmethod
    def restore_computation_graph(path: PathLike, load_updater: bool = True,
                                  device=None):
        """(ref: ModelSerializer.restoreComputationGraph)"""
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
            ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        cfg = ModelSerializer._config_json(path)
        if "ComputationGraph" not in cfg.get("format", ""):
            raise ValueError("Archive holds a MultiLayerNetwork; use "
                             "restore_multi_layer_network")
        net = ComputationGraph(ComputationGraphConfiguration.from_dict(cfg),
                               device=device).init()
        return ModelSerializer.restore_weights(path, net, load_updater)

    @staticmethod
    def restore_model(path: PathLike, load_updater: bool = True,
                      device=None):
        """Either container, by the config's ``format`` tag."""
        if "ComputationGraph" in ModelSerializer._config_json(path).get(
                "format", ""):
            return ModelSerializer.restore_computation_graph(
                path, load_updater, device)
        return ModelSerializer.restore_multi_layer_network(
            path, load_updater, device)
