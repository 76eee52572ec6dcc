"""The port's host utilities (``util/math_utils``, ``util/time_series``,
``util/viterbi``) against the JAX package's, on the CPU.

Each case mirrors one of ``tests/test_util.py``'s util cases on the
port's module and holds every value it computes to the JAX package's on
the same inputs: host numpy code, so equal exactly. The port's
``math_utils`` has every public function of the JAX file.
"""

import inspect

import numpy as np
import pytest

from deeplearning4j_tpu.util import math_utils as jmu
from deeplearning4j_tpu.util import time_series as jts
from deeplearning4j_tpu.util import viterbi as jvit

import deeplearning4j_tpu_torch.util as U
from deeplearning4j_tpu_torch.util import math_utils as mu
from deeplearning4j_tpu_torch.util import time_series as ts
from deeplearning4j_tpu_torch.util.viterbi import Viterbi, viterbi_decode


def _same(name, *args, mod=mu, jmod=jmu):
    """The port's ``mod.name(*args)``, held exactly to the JAX one's."""
    got = getattr(mod, name)(*args)
    want = getattr(jmod, name)(*args)
    assert type(got) is type(want), (name, got, want)
    np.testing.assert_array_equal(got, want)
    return got


def test_math_utils_has_every_public_function():
    names = sorted(n for n, f in vars(jmu).items()
                   if inspect.isfunction(f) and f.__module__ == jmu.__name__)
    assert len(names) == 21
    assert [n for n in names if not callable(getattr(mu, n, None))] == []
    assert U.Viterbi is Viterbi and U.viterbi_decode is viterbi_decode
    assert U.math_utils is mu and U.time_series is ts


def test_math_basics():
    assert _same("normalize", 5, 0, 10) == 0.5
    assert _same("normalize", 3, 2, 2) == 0.0
    assert _same("clamp", 15, 0, 10) == 10
    assert _same("discretize", 0.5, 0, 1, 11) == 5
    assert _same("next_pow_of_2", 17) == 32
    assert _same("next_pow_of_2", 16) == 16
    assert _same("next_pow_of_2", 0) == 1
    assert abs(_same("sigmoid", 0.0) - 0.5) < 1e-12
    assert abs(_same("log2", 8) - 3) < 1e-12
    assert abs(_same("entropy", [0.5, 0.5]) - 1.0) < 1e-12
    _same("entropy", [0.2, 0.0, 0.8])


def test_math_regression_stats():
    y = [1.0, 2.0, 3.0, 4.0]
    pred = [1.1, 1.9, 3.2, 3.8]
    assert _same("correlation", y, y) == pytest.approx(1.0)
    _same("correlation", pred, y)
    _same("correlation", [1.0, 1.0], y[:2])          # zero denominator
    assert _same("ss_error", pred, y) == pytest.approx(
        sum((a - b) ** 2 for a, b in zip(pred, y)))
    assert _same("ss_total", y, y) == pytest.approx(5.0)
    _same("ss_reg", pred, y)
    assert _same("determination_coefficient", y, y, 4) == pytest.approx(1.0)
    _same("determination_coefficient", pred, y, 3)
    assert _same("root_means_squared_error", y, y) == 0.0
    _same("root_means_squared_error", pred, y)
    assert _same("variance", [1.0, 2.0, 3.0]) == pytest.approx(1.0)
    assert _same("variance", [4.0]) == 0.0
    _same("sum_of_squares", pred)
    _same("vector_length", pred)


def test_math_distances_tfidf():
    assert _same("euclidean_distance", [0, 0], [3, 4]) == pytest.approx(5.0)
    assert _same("manhattan_distance", [0, 0], [3, 4]) == pytest.approx(7.0)
    assert _same("idf", 100, 10) == pytest.approx(np.log10(10))
    assert _same("idf", 100, 0) == 0.0
    assert _same("tf", 3, 12) == pytest.approx(0.25)
    assert _same("tf", 3, 0) == 0.0
    assert _same("tfidf", 0.25, np.log10(10)) == pytest.approx(
        0.25 * np.log10(10))
    assert _same("discretize", 0.5, 0.0, 1.0, 4) == 2
    assert _same("discretize", 1.0, 0.0, 1.0, 4) == 3   # clamped top edge
    assert _same("discretize", -9.0, 0.0, 1.0, 4) == 0  # clamped below


def test_moving_average():
    x = np.random.default_rng(0).normal(size=(3, 17))
    out = _same("moving_average", np.array([1.0, 2, 3, 4, 5]), 2,
                mod=ts, jmod=jts)
    np.testing.assert_allclose(out, [1.5, 2.5, 3.5, 4.5])
    out2 = _same("moving_average", np.array([[1.0, 2, 3], [4.0, 5, 6]]), 3,
                 mod=ts, jmod=jts)
    np.testing.assert_allclose(out2, [[2.0], [5.0]])
    _same("moving_average", x, 5, mod=ts, jmod=jts)


def test_reshapes_roundtrip():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    two_d = _same("reshape_3d_to_2d", x, mod=ts, jmod=jts)
    assert two_d.shape == (6, 4)
    np.testing.assert_array_equal(
        _same("reshape_2d_to_3d", two_d, 2, mod=ts, jmod=jts), x)
    m = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    v = _same("reshape_time_series_mask_to_vector", m, mod=ts, jmod=jts)
    assert v.shape == (6,)
    np.testing.assert_array_equal(
        _same("reshape_vector_to_time_series_mask", v, 2, mod=ts, jmod=jts),
        m)


def test_viterbi_decode_lattice():
    em = np.log(np.array([[0.9, 0.1], [0.8, 0.2], [0.1, 0.9]]))
    tr = np.log(np.array([[0.7, 0.3], [0.3, 0.7]]))
    logp, path = viterbi_decode(em, tr)
    jlogp, jpath = jvit.viterbi_decode(em, tr)
    np.testing.assert_array_equal(path, [0, 0, 1])
    assert logp == jlogp and np.array_equal(path, jpath)
    g = np.random.default_rng(1)
    em = np.log(g.dirichlet(np.ones(5), size=40))
    tr = np.log(g.dirichlet(np.ones(5), size=5))
    init = np.log(g.dirichlet(np.ones(5)))
    for args in ((em, tr), (em, tr, init)):
        (a, pa), (b, pb) = viterbi_decode(*args), jvit.viterbi_decode(*args)
        assert a == b and np.array_equal(pa, pb)


def test_viterbi_smoother_fixes_blip():
    """A single contradictory observation inside a stable run is smoothed
    away; a sustained change survives (both packages, equal)."""
    v = Viterbi([0, 1], meta_stability=0.95, p_correct=0.9)
    jv = jvit.Viterbi([0, 1], meta_stability=0.95, p_correct=0.9)
    for obs, want in ((np.array([0, 0, 1, 0, 0]), [0, 0, 0, 0, 0]),
                      (np.eye(2)[[0, 0, 1, 0, 0]], [0, 0, 0, 0, 0]),
                      (np.array([0, 0, 1, 1, 1, 1]), [0, 0, 1, 1, 1, 1])):
        (lp, out), (jlp, jout) = v.decode(obs), jv.decode(obs)
        np.testing.assert_array_equal(out, want)
        assert lp == jlp and np.array_equal(out, jout)


def test_viterbi_noncontiguous_labels():
    """possible_labels need not be 0..S-1; values map through a lookup."""
    v = Viterbi([1, 2], meta_stability=0.95, p_correct=0.9)
    jv = jvit.Viterbi([1, 2], meta_stability=0.95, p_correct=0.9)
    obs = np.array([1, 1, 2, 1, 1])
    (lp, out), (jlp, jout) = v.decode(obs), jv.decode(obs)
    np.testing.assert_array_equal(out, [1, 1, 1, 1, 1])
    assert lp == jlp and np.array_equal(out, jout)
    with pytest.raises(ValueError, match="not in possible_labels"):
        v.decode(np.array([1, 3]))
