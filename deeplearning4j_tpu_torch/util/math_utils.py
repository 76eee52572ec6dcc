"""Math utilities (the JAX package's ``util/math_utils.py``; ref:
deeplearning4j-nn/.../util/MathUtils.java — the statistics and
feature-weighting helpers the NLP and evaluation stacks use, and
``next_pow_of_2``, which the serving engine's buckets share). Host numpy,
vectorized instead of the reference's scalar-loop Java."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def normalize(val: float, minimum: float, maximum: float) -> float:
    """Squash to [0,1] given an observed range (MathUtils.java:54)."""
    if maximum == minimum:
        return 0.0
    return (val - minimum) / (maximum - minimum)


def clamp(value: int, minimum: int, maximum: int) -> int:
    return max(minimum, min(value, maximum))


def discretize(value: float, minimum: float, maximum: float,
               bin_count: int) -> int:
    """Map a continuous value to a bin index (MathUtils.java:84:
    ``int(binCount * normalize)`` clamped to [0, binCount - 1])."""
    return clamp(int(bin_count * normalize(value, minimum, maximum)),
                 0, bin_count - 1)


def next_pow_of_2(v: int) -> int:
    """Smallest power of two >= v (MathUtils.java:95)."""
    if v <= 0:
        return 1
    return 1 << (int(v - 1).bit_length())


def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def log2(a: float) -> float:
    return math.log(a) / math.log(2)


def entropy(probabilities: Sequence[float]) -> float:
    """Shannon entropy in bits."""
    p = np.asarray(probabilities, np.float64)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def correlation(residuals: Sequence[float],
                target: Sequence[float]) -> float:
    """Pearson correlation (MathUtils.java:149)."""
    r = np.asarray(residuals, np.float64)
    t = np.asarray(target, np.float64)
    rc, tc = r - r.mean(), t - t.mean()
    denom = math.sqrt((rc ** 2).sum() * (tc ** 2).sum())
    return float((rc * tc).sum() / denom) if denom else 0.0


def ss_reg(residuals: Sequence[float], target: Sequence[float]) -> float:
    """Regression sum of squares (MathUtils.java:175)."""
    r = np.asarray(residuals, np.float64)
    t = np.asarray(target, np.float64)
    return float(((r - t.mean()) ** 2).sum())


def ss_error(predicted: Sequence[float], target: Sequence[float]) -> float:
    """Error sum of squares (MathUtils.java:190)."""
    p = np.asarray(predicted, np.float64)
    t = np.asarray(target, np.float64)
    return float(((t - p) ** 2).sum())


def ss_total(residuals: Sequence[float], target: Sequence[float]) -> float:
    t = np.asarray(target, np.float64)
    return float(((t - t.mean()) ** 2).sum())


def determination_coefficient(y1: Sequence[float], y2: Sequence[float],
                              n: int) -> float:
    """R^2 (MathUtils.java:722)."""
    return correlation(y1[:n], y2[:n]) ** 2


def vector_length(vector: Sequence[float]) -> float:
    v = np.asarray(vector, np.float64)
    return float(np.sqrt((v ** 2).sum()))


def sum_of_squares(vector: Sequence[float]) -> float:
    v = np.asarray(vector, np.float64)
    return float((v ** 2).sum())


def variance(vector: Sequence[float]) -> float:
    """Sample variance over n-1 (MathUtils.java:504 semantics)."""
    v = np.asarray(vector, np.float64)
    if len(v) < 2:
        return 0.0
    return float(((v - v.mean()) ** 2).sum() / (len(v) - 1))


def root_means_squared_error(real: Sequence[float],
                             predicted: Sequence[float]) -> float:
    r = np.asarray(real, np.float64)
    p = np.asarray(predicted, np.float64)
    return float(np.sqrt(((r - p) ** 2).mean()))


def euclidean_distance(a: Sequence[float], b: Sequence[float]) -> float:
    return vector_length(np.asarray(a, np.float64) - np.asarray(b, np.float64))


def manhattan_distance(a: Sequence[float], b: Sequence[float]) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum())


# -- tf-idf (used by the bag-of-words vectorizers, MathUtils.java:258-283) --

def idf(total_docs: float, docs_containing: float) -> float:
    """(MathUtils.java idf: log10, not natural log)"""
    if docs_containing == 0 or total_docs == 0:
        return 0.0
    return math.log10(total_docs / docs_containing)


def tf(count: int, document_length: int) -> float:
    return count / document_length if document_length else 0.0


def tfidf(tf_value: float, idf_value: float) -> float:
    return tf_value * idf_value
