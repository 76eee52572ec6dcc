"""Binary codec for StatsReport records (the JAX package's
``ui/codec.py``: the same wire, byte for byte).

The reference serializes stats with generated Simple Binary Encoding codecs
(ref: deeplearning4j-ui-model/.../stats/sbe/{UpdateEncoder,UpdateDecoder}.java,
~8.2k generated LoC). Here the wire format is implemented once in C++
(``native/stats_codec.cc``), built and loaded through the port's own
``native_loader`` as ``statscodec``. A byte-identical Python encoder and
decoder (``struct``) is the documented path where the library cannot be
built (no ``g++``); ``native_available()`` says which one runs. A loaded
library is never left for the Python path: a record it refuses raises.

Wire layout (little-endian, version 1):
  u32 magic "STAT"  u16 version  u16 flags
  i64 iteration  i64 timestamp_ms  f64 score
  f64 samples_per_sec  f64 batches_per_sec
  u32 n_series; per series: u16 name_len, name, u32 count, f32 values[count]
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Tuple

import numpy as np

from deeplearning4j_tpu_torch.native_loader import load_native

_MAGIC = 0x53544154
_VERSION = 1
_HEADER = struct.Struct("<IHHqqddd")  # magic, ver, flags, iter, ts, score, sps, bps


def _native():
    lib = load_native("statscodec")
    if lib is None:
        return None
    lib.stats_encode.restype = ctypes.c_int64
    lib.stats_decode_header.restype = ctypes.c_int
    lib.stats_decode_series.restype = ctypes.c_int32
    return lib


def native_available() -> bool:
    """True where the native codec is built and loaded (the path
    ``encode_report`` / ``decode_report`` take)."""
    return _native() is not None


def encode_report(iteration: int, timestamp_ms: int, score: float,
                  samples_per_sec: float, batches_per_sec: float,
                  series: Dict[str, np.ndarray]) -> bytes:
    """Encode one stats record. ``series`` maps name -> float32 vector
    (1-element vectors carry scalars like norms; longer ones carry
    histogram counts / edges)."""
    names = list(series.keys())
    arrays = [np.ascontiguousarray(np.asarray(series[n], np.float32).ravel())
              for n in names]
    lib = _native()
    if lib is None:
        return _encode_python(iteration, timestamp_ms, score,
                              samples_per_sec, batches_per_sec, names, arrays)
    name_bufs = [n.encode() for n in names]
    cap = _HEADER.size + 4 + sum(2 + len(nb) + 4 + 4 * a.size
                                 for nb, a in zip(name_bufs, arrays))
    out = (ctypes.c_uint8 * cap)()
    k = max(len(names), 1)
    c_names = (ctypes.c_char_p * k)(*name_bufs)
    c_vals = (ctypes.POINTER(ctypes.c_float) * k)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrays])
    c_lens = (ctypes.c_int32 * k)(*[a.size for a in arrays])
    n = lib.stats_encode(
        ctypes.c_int64(iteration), ctypes.c_int64(timestamp_ms),
        ctypes.c_double(score), ctypes.c_double(samples_per_sec),
        ctypes.c_double(batches_per_sec), c_names, c_vals, c_lens,
        ctypes.c_int32(len(names)), out, ctypes.c_int64(cap))
    if n <= 0:
        raise ValueError(f"stats_encode refused the record (rc {n})")
    return bytes(out[:n])


def _encode_python(iteration, timestamp_ms, score, samples_per_sec,
                   batches_per_sec, names, arrays) -> bytes:
    parts = [_HEADER.pack(_MAGIC, _VERSION, 0, iteration, timestamp_ms,
                          score, samples_per_sec, batches_per_sec),
             struct.pack("<I", len(names))]
    for n, a in zip(names, arrays):
        nb = n.encode()
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<I", a.size))
        parts.append(a.tobytes())
    return b"".join(parts)


def decode_report(buf: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Decode one record -> (header dict, series dict)."""
    lib = _native()
    if lib is None:
        return _decode_python(buf)
    it, ts = ctypes.c_int64(), ctypes.c_int64()
    sc, sps, bps = ctypes.c_double(), ctypes.c_double(), ctypes.c_double()
    ns = ctypes.c_int32()
    raw = (ctypes.c_uint8 * max(len(buf), 1)).from_buffer_copy(
        buf or b"\0")
    rc = lib.stats_decode_header(
        raw, ctypes.c_int64(len(buf)), ctypes.byref(it), ctypes.byref(ts),
        ctypes.byref(sc), ctypes.byref(sps), ctypes.byref(bps),
        ctypes.byref(ns))
    if rc != 0:
        raise ValueError("bad stats record")
    series: Dict[str, np.ndarray] = {}
    name_buf = ctypes.create_string_buffer(4096)
    val_cap = max(1, (len(buf) // 4) + 1)
    val_buf = (ctypes.c_float * val_cap)()
    for i in range(ns.value):
        cnt = lib.stats_decode_series(
            raw, ctypes.c_int64(len(buf)), ctypes.c_int32(i), name_buf,
            ctypes.c_int32(4096), val_buf, ctypes.c_int32(val_cap))
        if cnt < 0:
            raise ValueError(f"bad stats record: series {i} (rc {cnt})")
        series[name_buf.value.decode()] = np.frombuffer(
            val_buf, np.float32, cnt).copy()
    header = {"iteration": it.value, "timestamp_ms": ts.value,
              "score": sc.value, "samples_per_sec": sps.value,
              "batches_per_sec": bps.value}
    return header, series


def _decode_python(buf: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    magic, ver, _flags, iteration, ts_ms, score, sps_v, bps_v = \
        _HEADER.unpack_from(buf, 0)
    if magic != _MAGIC or ver != _VERSION:
        raise ValueError("bad stats record")
    (n_series,) = struct.unpack_from("<I", buf, _HEADER.size)
    off = _HEADER.size + 4
    series = {}
    for _ in range(n_series):
        (nl,) = struct.unpack_from("<H", buf, off)
        off += 2
        name = buf[off:off + nl].decode()
        off += nl
        (cnt,) = struct.unpack_from("<I", buf, off)
        off += 4
        series[name] = np.frombuffer(buf, np.float32, cnt, off).copy()
        off += 4 * cnt
    header = {"iteration": iteration, "timestamp_ms": ts_ms, "score": score,
              "samples_per_sec": sps_v, "batches_per_sec": bps_v}
    return header, series
