"""Native host-side IO (the JAX package's ``datasets/native_io.py``):
``ctypes`` bindings for ``native/dataloader.cc``'s IDX and numeric-CSV
parsers, built by the port's own ``native_loader``.

Role parity: the reference's ingestion hot path runs in native code
(ref: deeplearning4j-core/.../datasets/fetchers/MnistDataFetcher.java:65-83
IDX parsing; DataVec CSV record readers). These are host parsers, not
device kernels. ``idx_read`` / ``csv_read`` return None when the library
is unavailable or refuses the file, and the callers then parse in Python:
the two paths give byte-identical results.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.native_loader import load_native

_lib = None
_checked = False


def _load():
    global _lib, _checked
    if not _checked:
        _checked = True
        lib = load_native("dataloader")
        if lib is not None:
            lib.idx_read.restype = ctypes.c_int
            lib.idx_read.argtypes = [
                ctypes.c_char_p, ctypes.c_double,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            lib.csv_read.restype = ctypes.c_int64
            lib.csv_read.argtypes = [
                ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def idx_read(path: Union[str, Path],
             scale: float = 1.0) -> Optional[np.ndarray]:
    """An IDX (MNIST-format, u8 payload) file as float32 scaled by
    ``scale`` (1/255 for images): ``(float)(byte * scale)`` in double.
    None when the library is unavailable or the file is not plain IDX
    (gzip: the caller parses in Python)."""
    lib = _load()
    path = Path(path)
    if lib is None or path.suffix == ".gz":
        return None
    # the output sized from the file's length (a u8 payload, a tiny header)
    capacity = max(path.stat().st_size, 16)
    out = np.empty(capacity, dtype=np.float32)
    dims = (ctypes.c_int64 * 8)()
    nd = lib.idx_read(str(path).encode(), float(scale), dims, 8,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      capacity)
    if nd <= 0:
        return None
    shape = tuple(int(dims[i]) for i in range(nd))
    n = int(np.prod(shape))
    return out[:n].reshape(shape)


def csv_read(path: Union[str, Path], delimiter: str = ",",
             skip_rows: int = 0) -> Optional[Tuple[np.ndarray, int]]:
    """A numeric CSV as a row-major float64 ``[rows, cols]`` matrix and
    its column count (double: ``strtod`` and Python's ``float()`` agree
    exactly). None when unavailable or unparseable: ragged or
    non-numeric rows go to the Python reader, which handles strings."""
    lib = _load()
    path = Path(path)
    if lib is None or not path.exists():
        return None
    # an upper bound: every byte a one-character number, plus slack
    capacity = max(path.stat().st_size, 64)
    out = np.empty(capacity, dtype=np.float64)
    ncols = ctypes.c_int32(0)
    rows = lib.csv_read(str(path).encode(), delimiter.encode()[:1],
                        int(skip_rows),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        capacity, ctypes.byref(ncols))
    if rows < 0 or ncols.value <= 0:
        return None
    return (out[:rows * ncols.value].reshape(int(rows), ncols.value),
            ncols.value)
