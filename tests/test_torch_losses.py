"""The port's loss table (deeplearning4j_tpu_torch.ops.losses) against the
JAX package's (ops/losses.py): every entry, fused and unfused activation
paths, on [B, F] and [B, T, F] inputs, with and without a mask. The same
numpy inputs go to both; tolerance 1e-6 (relative and absolute: the two
sides differ only in f32 rounding order)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import losses as jl
from deeplearning4j_tpu_torch.ops import losses as tl

TOL = 1e-6

#: (loss, activation, label kind): every table entry, plus the unfused
#: paths of the two fused losses
CASES = [(name, act, kind) for name, act, kind in [
    ("mse", "identity", "real"), ("l2", "tanh", "real"),
    ("mae", "identity", "real"), ("l1", "sigmoid", "real"),
    ("mcxent", "softmax", "onehot"), ("mcxent", "sigmoid", "onehot"),
    ("negativeloglikelihood", "softmax", "onehot"),
    ("nll", "softmax", "onehot"), ("xent", "sigmoid", "binary"),
    ("xent", "softmax", "binary"), ("hinge", "identity", "binary"),
    ("squared_hinge", "tanh", "binary"),
    ("kl_divergence", "softmax", "prob"),
    ("reconstruction_crossentropy", "sigmoid", "binary"),
    ("poisson", "softplus", "real"),
    ("cosine_proximity", "identity", "real"),
    ("msle", "relu", "real"), ("mape", "identity", "real")]]


def _inputs(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    preout = rng.normal(size=shape).astype(np.float32) * 2.0
    if kind == "onehot":
        labels = np.eye(shape[-1], dtype=np.float32)[
            rng.integers(0, shape[-1], shape[:-1])]
    elif kind == "binary":
        labels = (rng.random(shape) > 0.5).astype(np.float32)
    elif kind == "prob":
        e = np.exp(rng.normal(size=shape))
        labels = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    else:
        labels = rng.uniform(0.1, 1.5, shape).astype(np.float32)
    return labels, preout


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("name,act,kind", CASES,
                         ids=[f"{n}-{a}" for n, a, _ in CASES])
def test_loss_matches_jax(name, act, kind, rank, masked):
    shape = (5, 7) if rank == 2 else (3, 4, 7)
    labels, preout = _inputs(kind, shape)
    mask = None
    if masked:
        mask = np.ones(shape[:-1], np.float32)
        mask.reshape(-1)[::3] = 0.0
    ref = np.asarray(jl.get_loss(name)(
        jnp.asarray(labels), jnp.asarray(preout), act,
        None if mask is None else jnp.asarray(mask)))
    got = tl.get_loss(name)(
        torch.from_numpy(labels), torch.from_numpy(preout), act,
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (shape[0],)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_loss_table_has_every_jax_entry():
    assert set(tl.LOSSES) == set(jl.LOSSES)
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss("nope")


def test_promote_loss_dtype_promotes_and_keeps_f64():
    p, l = tl.promote_loss_dtype(torch.zeros(2, dtype=torch.bfloat16),
                                 torch.zeros(2, dtype=torch.bfloat16))
    assert p.dtype == l.dtype == torch.float32
    p, _ = tl.promote_loss_dtype(torch.zeros(2, dtype=torch.float64),
                                 torch.zeros(2))
    assert p.dtype == torch.float64
