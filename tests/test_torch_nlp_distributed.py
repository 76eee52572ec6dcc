"""The port's data-parallel embedding trainer (``nlp/distributed.py``:
``SparkSequenceVectors`` / ``SparkWord2Vec`` over a ``torch.distributed``
group) against the JAX package's ``SparkWord2Vec`` on a device mesh, on
the CPU.

The JAX trainer shards each batch over a ``data`` mesh axis and GSPMD
runs the single-device step on the whole batch (trimmed to a multiple of
the device count). The port's, in one group of four gloo processes for
the module (``torch_parallel_worker.run_group``), gives each rank its
chunk of every batch and combines the touched rows' sums and counts
across the ranks before the 1/count**0.5 scale. Held here:

- whole fits at world 4 (skip-gram NS, skip-gram HS, CBOW-NS) against
  JAX ``SparkWord2Vec(devices=jax.devices()[:4])``: the tables within
  1e-4 of their largest |x|, the four ranks' tables bit for bit equal;
- one step of each kind at world 2 (a sub-group of ranks 0 and 1) on a
  batch whose rows repeat across the two chunks: within 1e-6 of
  max(1, max |x|) of the single-process step on the whole batch and
  within 1e-5 of the JAX step, while the per-rank alternative (each rank
  scales its own chunk's rows by its own counts, the deltas summed)
  misses the single-process step by far more: the counts are global.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu.nlp import sequencevectors as jsv
from deeplearning4j_tpu.nlp.distributed import SparkWord2Vec as JSpark

from deeplearning4j_tpu_torch.nlp import sequencevectors as psv

STEP_SINGLE, STEP_JAX, FIT = 1e-6, 1e-5, 1e-4

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the quick red fox runs past the sleepy cat",
    "a lazy dog and a sleepy cat nap all day",
    "day after day the quick animals play",
] * 6

KW = dict(layer_size=16, window=3, min_word_frequency=1, epochs=3,
          negative=4, batch_size=64, seed=9)
MODES = {"sgns": {}, "hs": dict(negative=0, use_hierarchic_softmax=True),
         "cbow": dict(elements_algo="cbow")}
WORLD = 4


def _step_case(step, seed=0, V=12, D=8, B=10, K=3, L=4, W_=4):
    """(tables, batch) of one step on a small vocabulary: every row is
    touched by both halves of the batch."""
    g = np.random.default_rng(seed)
    tables = [(g.normal(size=(V, D)) * 0.3).astype(np.float32)
              for _ in range(2)]

    def idx(*shape):
        return g.integers(0, V, shape).astype(np.int32)
    if step == "sgns":
        batch = [idx(B), idx(B), idx(B, K)]
    elif step == "hs":
        mask = (np.arange(L)[None, :] < g.integers(1, L + 1, (B, 1))
                ).astype(np.float32)
        codes = (g.random((B, L)) < 0.5).astype(np.float32) * mask
        batch = [idx(B), (idx(B, L) * (mask > 0)).astype(np.int32), codes,
                 mask]
    else:
        mask = (np.arange(W_)[None, :] < g.integers(1, W_ + 1, (B, 1))
                ).astype(np.float32)
        batch = [(idx(B, W_) * (mask > 0)).astype(np.int32), mask, idx(B),
                 idx(B, K)]
    batch[0][0] = batch[0][B // 2] = 3       # one row, in both chunks
    return tables, batch


STEPS = {"sgns": (psv._sgns_step, jsv._sgns_step),
         "hs": (psv._hs_step, jsv._hs_step),
         "cbow": (psv._cbow_ns_step, jsv._cbow_ns_step)}
LR = 0.05


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nlp_distributed")
    cases = [dict(name=f"fit_{m}", fn="spark_w2v",
                  args=dict(kw={**KW, **extra}, sentences=CORPUS))
             for m, extra in MODES.items()]
    for step in STEPS:
        tables, batch = _step_case(step)
        cases.append(dict(name=f"step_{step}", fn="spark_step",
                          args=dict(step=step, tables=tables, batch=batch,
                                    lr=LR)))
    return W.run_group(cases, tmp, world=WORLD)


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


@pytest.mark.parametrize("mode", list(MODES))
def test_spark_word2vec_matches_jax_on_four_devices(group, mode):
    """World 4 against the JAX 4-device mesh: the tables within 1e-4 of
    their largest |x|; every rank's tables bit for bit rank 0's."""
    kw = {**KW, **MODES[mode]}
    jw = JSpark(**kw, devices=jax.devices()[:WORLD])
    jw.fit(list(CORPUS))
    assert jw._n_dev == WORLD
    ranks = [W.result(group, f"fit_{mode}", r) for r in range(WORLD)]
    assert all(r["n_dev"] == WORLD for r in ranks)
    for name in ("syn0", "syn1", "syn1neg"):
        want = np.asarray(getattr(jw.lookup_table, name), np.float64)
        got = ranks[0][name]
        if not want.any():
            assert not got.any(), name      # a table the mode never uses
            continue
        err = float(np.abs(got - want).max())
        assert err <= FIT * float(np.abs(want).max()), (name, err)
        for r in ranks[1:]:
            assert np.array_equal(r[name], got), name


@pytest.mark.parametrize("step", list(STEPS))
def test_two_ranks_combine_with_global_counts(group, step):
    """One step at world 2 on a batch that touches rows in both chunks:
    the single-process step's on the whole batch (1e-6), the JAX step's
    (1e-5); the two ranks equal; a per-rank scatter-mean misses."""
    pstep, jstep = STEPS[step]
    tables, batch = _step_case(step)
    single = [t.numpy() for t in pstep(*[torch.tensor(a) for a in tables],
                                       *[torch.as_tensor(a) for a in batch],
                                       LR)]
    jax_out = [np.asarray(t) for t in jstep(
        *[jnp.asarray(a) for a in tables], *[jnp.asarray(a) for a in batch],
        LR)]
    ranks = [W.result(group, f"step_{step}", r) for r in range(2)]
    assert ranks[0]["n_dev"] == 2
    assert W.result(group, f"step_{step}", 2) is None
    half = len(batch[0]) // 2
    naive = [a.copy() for a in tables]
    for part in (slice(0, half), slice(half, None)):
        out = pstep(*[torch.tensor(a) for a in tables],
                    *[torch.as_tensor(a[part]) for a in batch], LR)
        for n, o, t in zip(naive, out, tables):
            n += o.numpy() - t
    worst_naive = 0.0
    for j, (got, want) in enumerate(zip(ranks[0]["tables"], single)):
        tol = STEP_SINGLE * _scale(want)
        assert float(np.abs(got - want).max()) <= tol
        assert float(np.abs(got - jax_out[j]).max()) <= \
            STEP_JAX * _scale(jax_out[j])
        assert np.array_equal(got, ranks[1]["tables"][j])
        worst_naive = max(worst_naive, float(np.abs(naive[j] - want).max()))
    assert worst_naive > 1e3 * STEP_SINGLE, worst_naive
