"""Build and load the host-side C++ libraries of ``native/`` (the JAX
package's ``native_loader.py``, with a build directory of its own).

``native/<source>.cc`` is compiled once, at first use, with ``g++ -O2
-shared -fPIC`` (the flags of ``native/build.sh``) into
``deeplearning4j_tpu_torch/_build/`` under a name that hashes the source
and the flags, so an edited source is rebuilt, and loaded with
``ctypes``. A build that runs is reported to the compile watchers
(``profiling/watchers.report_compile``, kind ``"gxx"``), as the kernels'
``nvcc`` builds are. The ``native/`` tree is read, never written: the
JAX package's own ``native_lib/`` is not touched. A library is named as
the JAX package names it; ``SOURCES`` maps each name to its source file
where the two differ (``statscodec`` is built from ``stats_codec.cc``, as
``native/build.sh`` builds it).

Where there is no compiler, or the compile fails, ``load_native`` returns
None and the caller takes its documented Python path (``datasets/
native_io``'s parsers return None, and their callers parse in Python,
byte for byte the same).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

#: library name -> source stem under ``native/`` where they differ
SOURCES = {"statscodec": "stats_codec"}

logger = logging.getLogger(__name__)
_cache: Dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()


def source_path(name: str) -> Path:
    """The source ``lib<name>`` is built from."""
    return NATIVE_DIR / f"{SOURCES.get(name, name)}.cc"


def library_path(name: str) -> Path:
    """Where the library built from ``source_path(name)`` lives."""
    src = source_path(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_native(name: str) -> Optional[Path]:
    """Compile ``source_path(name)`` unless its library is built; the
    library's path, or None when there is no source or ``g++``, or the
    compile fails (its output is kept beside the library as ``.log``)."""
    if not source_path(name).exists():
        return None
    path = library_path(name)
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    from deeplearning4j_tpu_torch.profiling.watchers import report_compile
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, str(source_path(name)), "-o", str(tmp)],
            capture_output=True, text=True, timeout=120, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("g++ %s.cc did not run: %s", name, e)
        return None
    Path(f"{path}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        logger.warning("g++ %s.cc failed (rc %d): %s", name, proc.returncode,
                       proc.stderr[-2000:])
        return None
    os.replace(tmp, path)
    report_compile("gxx", time.perf_counter() - t0, name)
    return path


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """``lib<name>`` loaded (built first if need be), or None; the first
    outcome is kept for the process. The build runs outside the lock, so
    a caller of a library already loaded never waits for another's
    ``g++``; two threads that build one name at once each build it into
    a file of their own, and the one renamed last stays."""
    if name in _cache:
        return _cache[name]
    path = build_native(name)
    lib = None
    if path is not None:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("cannot load %s: %s", path, e)
    with _lock:
        return _cache.setdefault(name, lib)
