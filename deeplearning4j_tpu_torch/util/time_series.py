"""Time-series shape/mask utilities (the JAX package's
``util/time_series.py``, host numpy; ref:
deeplearning4j-nn/.../util/TimeSeriesUtils.java).

Array layout note: the reference stores time series as [B, F, T]
(channels-middle); this framework's convention is [B, T, F] throughout, so
the 3d<->2d reshapes here flatten (B, T) rather than the reference's
permute-then-reshape dance."""

from __future__ import annotations

import numpy as np


def moving_average(to_avg: np.ndarray, n: int) -> np.ndarray:
    """Trailing n-point moving average along the last axis
    (TimeSeriesUtils.java:44 — cumsum formulation, output length T-n+1)."""
    a = np.asarray(to_avg, np.float64)
    csum = np.cumsum(a, axis=-1)
    out = csum[..., n - 1:].copy()
    out[..., 1:] -= csum[..., :-n]
    return out / n


def reshape_3d_to_2d(x: np.ndarray) -> np.ndarray:
    """[B, T, F] -> [B*T, F] (TimeSeriesUtils.java:93)."""
    B, T, F = x.shape
    return x.reshape(B * T, F)


def reshape_2d_to_3d(x: np.ndarray, minibatch_size: int) -> np.ndarray:
    """[B*T, F] -> [B, T, F] (TimeSeriesUtils.java:105)."""
    BT, F = x.shape
    return x.reshape(minibatch_size, BT // minibatch_size, F)


def reshape_time_series_mask_to_vector(mask: np.ndarray) -> np.ndarray:
    """[B, T] mask -> [B*T] (TimeSeriesUtils.java:58)."""
    return np.asarray(mask).reshape(-1)


def reshape_vector_to_time_series_mask(vec: np.ndarray,
                                       minibatch_size: int) -> np.ndarray:
    """[B*T] -> [B, T] (TimeSeriesUtils.java:74)."""
    v = np.asarray(vec).reshape(minibatch_size, -1)
    return v
