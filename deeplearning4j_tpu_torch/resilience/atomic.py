"""Crash-safe file primitives: atomic write + checksums (the JAX
package's ``resilience/atomic.py``: it imports no JAX, and the port keeps
its own copy of the parts a path here uses).

``replace_bytes`` is the light form for records that are rewritten
sub-second or superseded by the next write (the elastic lease, join
requests, heartbeats): tmp + rename, so a reader never sees a prefix,
without the fsyncs and without the checkpoint fault hook.

Every durable artifact goes through the same commit protocol:

    write tmp file (same directory) -> flush -> fsync(file)
    -> os.replace(tmp, final)       -> fsync(directory)

``os.replace`` is atomic on POSIX: readers see either the old complete
file or the new complete file, never a prefix. The directory fsync makes
the rename itself durable (without it a power cut can roll the rename
back even though the data blocks landed).

Checksums are CRC-32 (``zlib.crc32``) — fast, stdlib, and strong enough
for torn-write/bit-rot *detection* (we are not defending against an
adversary; a cryptographic hash would only slow the restore path down).

``FaultInjected`` hooks: the fault-injection harness
(``resilience/faultinject.py``) can truncate the bytes of a checkpoint
mid-commit to simulate a SIGKILL between write and rename (crash mode)
or a torn final file (torn mode) — this module asks the harness at the
commit point so chaos tests exercise the real code path.
"""

from __future__ import annotations

import os
import threading
import zlib
from contextlib import contextmanager
from pathlib import Path
from typing import Union


class CheckpointError(IOError):
    """A checkpoint is unreadable, torn, or fails checksum verification.

    The message always names the offending file — "restore failed" with
    no filename is undebuggable at 3am on a pod.
    """


def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_file(path: Union[str, Path], chunk: int = 1 << 20) -> int:
    """A file's CRC-32, read in ``chunk``-byte pieces."""
    acc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            acc = zlib.crc32(buf, acc)
    return acc & 0xFFFFFFFF


def fsync_dir(path: Union[str, Path]) -> None:
    """Make a completed rename in ``path`` durable. Best-effort on
    filesystems that refuse O_RDONLY dir fds (never raises)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


@contextmanager
def atomic_path(path: Union[str, Path], unique: bool = False):
    """Stream-friendly atomic commit: yields a tmp path for the caller
    to write (e.g. a zipfile), then fsync + rename + dir-fsync on clean
    exit. The tmp name is deterministic (``<name>.tmp``): one writer per
    archive, and a stable name is what the torn-write chaos keys on.

    ``unique=True`` suffixes the tmp name with the pid and thread, so
    writers of the same final path that do not see each other (two
    processes filling one dataset cache, ``datasets/cloud_io.
    fetch_to_cache``) each commit their own complete bytes: the last
    rename wins whole, and nobody renames a rival's half-written tmp.

    On an exception inside the block the tmp file is removed and the
    final path is untouched.
    """
    path = Path(path)
    suffix = (f".{os.getpid()}-{threading.get_ident()}.tmp"
              if unique else ".tmp")
    tmp = path.with_name(path.name + suffix)
    try:
        yield tmp
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        _commit_hook(tmp, path)
        os.replace(tmp, path)
    except BaseException as e:
        # an exception ANYWHERE before the rename lands — including the
        # commit window itself (fsync ENOSPC) — must not strand the
        # tmp. EXCEPT a simulated SIGKILL: a killed process runs no
        # cleanup, so the chaos harness must see the torn stump a real
        # mid-commit death leaves behind. Lazy import — this module
        # stays importable with zero package dependencies.
        from deeplearning4j_tpu_torch.resilience.faultinject import (
            KilledByFault)
        if not isinstance(e, KilledByFault):
            tmp.unlink(missing_ok=True)
        raise
    fsync_dir(path.parent)


def atomic_write_bytes(path: Union[str, Path], data: bytes) -> int:
    """Atomically replace ``path`` with ``data``; returns the CRC-32.

    The fault-injection commit hook runs between write and rename, so a
    scheduled ``truncate_checkpoint`` fault exercises exactly the window
    a real SIGKILL would hit.
    """
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    _commit_hook(tmp, path)
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return crc32_bytes(data)


def replace_bytes(path: Union[str, Path], data: bytes) -> None:
    """Write ``data`` to ``<path>.tmp`` and rename it over ``path``:
    atomic for readers, not durable (no fsync). A torn or lost write
    reads as the previous record."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _commit_hook(tmp: Path, final: Path) -> None:
    """Ask the fault-injection harness whether to tear this commit.

    Lazy import: faultinject pulls in the metrics registry; this module
    must stay importable with zero package dependencies (the serializer
    imports it at module top).
    """
    from deeplearning4j_tpu_torch.resilience import faultinject
    faultinject.on_checkpoint_commit(tmp, final)
