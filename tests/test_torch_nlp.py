"""The port's NLP trainers against the JAX package's, on the CPU.

State crosses with ``convert.lookup_table_from_jax``, never by seed. Held
here:
- each step function (``_sgns_step`` at the three ``dup_power`` values,
  ``_hs_step`` over padded Huffman paths, ``_cbow_ns_step`` over padded
  windows with and without the input update, ``_glove_step``, and the
  port's ``_dm_step`` against the JAX ``_cbow_ns_step`` over the
  concatenated ``[dv_d; syn0]``) on seeded batches with many repeated
  indices: the state after three chained steps within 1e-5 of the
  largest |x| (at least 1);
- whole ``fit``s of two epochs (skip-gram NS, skip-gram HS, CBOW,
  skip-gram with subsampling, GloVe, PV-DBOW, PV-DM) and
  ``infer_vector``: every batch the host hands a step (pairs, windows,
  Huffman paths, negatives, GloVe's entries: so the permutations too)
  equal, and the tables within 1e-4 of the largest |x|; ``lt.syn0`` /
  ``lt.syn1neg`` bit for bit unchanged after ``infer_vector`` and PV-DM;
- the vocab: order, Huffman codes and points and ``huffman_arrays``
  element for element on a vocab with many equal counts;
- the lookup table's negatives and queries; the vectorizers;
- the serializer: the word2vec text and binary files byte for byte both
  ways, a ``.gz`` file's payload (gzip's header holds the file's name
  and time), the full-model zip's members (a zip entry holds its time)
  and each package reading the other's files; the committed
  ``tests/fixtures/sample_w2v.bin``;
- the JAX gates mirrored on the port: ``tests/test_nlp.py`` and the
  ``dup_power`` comparison of ``tests/test_convergence.py``;
- no fallback: ``device=None`` raises without a card.
"""

import ast
import gzip
import io
import os
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import sequencevectors as jsv
from deeplearning4j_tpu.nlp.vocab import huffman_arrays as j_huffman_arrays

from deeplearning4j_tpu_torch.convert import lookup_table_from_jax
from deeplearning4j_tpu_torch.nlp import (
    BagOfWordsVectorizer, BasicLineIterator, CollectionSentenceIterator,
    CommonPreprocessor, DefaultTokenizerFactory, Glove, LabelsSource,
    NGramTokenizerFactory, ParagraphVectors, SequenceVectors,
    TfidfVectorizer, TreeVectorizer, VocabCache, VocabConstructor, Word2Vec,
    WordVectorSerializer, build_huffman,
)
from deeplearning4j_tpu_torch.nlp import glove as pglove
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as ppv
from deeplearning4j_tpu_torch.nlp import sequencevectors as psv
from deeplearning4j_tpu_torch.nlp.vocab import VocabWord, huffman_arrays

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
STEP = 1e-5
FIT = 1e-4


def _close(got, want, tol, floor=1.0):
    """max |got - want| <= tol x max(floor, max |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _topics(n=120, seed=0):
    """Three topics of eight words plus three shared words."""
    rng = np.random.default_rng(seed)
    topics = [[f"{p}{i}" for i in range(8)] for p in "abc"]
    common = ["the", "of", "and"]
    sents = []
    for _ in range(n):
        words = (list(rng.choice(topics[rng.integers(3)], size=7))
                 + list(rng.choice(common, size=3)))
        sents.append(" ".join(str(w) for w in rng.permutation(words)))
    return sents


def _jax_table(seed=0, V_sents=80, D=16):
    """A JAX lookup table with nonzero weights in all three matrices."""
    w2v = J.Word2Vec(layer_size=D, seed=seed)
    w2v.build_vocab(_topics(V_sents, seed))
    lt = w2v.lookup_table
    rng = np.random.default_rng(seed + 1)
    lt.syn1 = (rng.normal(size=lt.syn1.shape) * 0.3).astype(np.float32)
    lt.syn1neg = (rng.normal(size=lt.syn1neg.shape) * 0.3).astype(np.float32)
    lt.syn0 = (rng.normal(size=lt.syn0.shape) * 0.3).astype(np.float32)
    return lt


# ---------------------------------------------------------------------------
# carrying a table across
# ---------------------------------------------------------------------------

def test_lookup_table_from_jax_copies_everything():
    jlt = _jax_table()
    lt = lookup_table_from_jax(jlt)
    assert [(w.word, w.count, w.index, w.codes, w.points)
            for w in lt.vocab.vocab_words()] == [
        (w.word, w.count, w.index, w.codes, w.points)
        for w in jlt.vocab.vocab_words()]
    assert lt.vocab.total_word_count == jlt.vocab.total_word_count
    assert (lt.vector_length, lt.use_hs, lt.negative) == (
        jlt.vector_length, jlt.use_hs, jlt.negative)
    for name in ("syn0", "syn1", "syn1neg", "_neg_cdf"):
        a, b = getattr(lt, name), getattr(jlt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert not np.shares_memory(a, b), name


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------

def _sg_batches(V, B=96, K=5, n=3, seed=3):
    """Skip-gram batches drawn from few rows: most indices repeat."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, B).astype(np.int32),
             rng.integers(0, V, B).astype(np.int32),
             rng.integers(0, V, (B, K)).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("power", [0.0, 0.5, 1.0])
def test_sgns_step_matches_jax(power):
    lt = lookup_table_from_jax(_jax_table())
    V = len(lt.vocab)
    j0, j1 = jnp.asarray(lt.syn0), jnp.asarray(lt.syn1neg)
    p0, p1 = _t(lt.syn0), _t(lt.syn1neg)
    for c, o, n in _sg_batches(V):
        j0, j1 = jsv._sgns_step(j0, j1, jnp.asarray(c), jnp.asarray(o),
                                jnp.asarray(n), 0.05, dup_power=power)
        p0, p1 = psv._sgns_step(p0, p1, _t(c), _t(o), _t(n), 0.05,
                                dup_power=power)
    _close(_np(p0), np.asarray(j0), STEP)
    _close(_np(p1), np.asarray(j1), STEP)


def test_scatter_mean_add_matches_jax():
    rng = np.random.default_rng(1)
    mat = rng.normal(size=(9, 4)).astype(np.float32)
    idx = rng.integers(0, 4, 40).astype(np.int32)    # rows 4..8 untouched
    upd = rng.normal(size=(40, 4)).astype(np.float32)
    for power in (0.0, 0.5, 1.0):
        want = np.asarray(jsv._scatter_mean_add(
            jnp.asarray(mat), jnp.asarray(idx), jnp.asarray(upd), power))
        got = _np(psv._scatter_mean_add(_t(mat), _t(idx), _t(upd), power))
        _close(got, want, STEP)
        assert np.array_equal(got[4:], mat[4:])


def test_hs_step_matches_jax_on_padded_paths():
    lt = lookup_table_from_jax(_jax_table())
    codes, points, mask = huffman_arrays(lt.vocab)
    assert (mask == 0).any()          # paths of unequal lengths: padding
    V = len(lt.vocab)
    j0, j1 = jnp.asarray(lt.syn0), jnp.asarray(lt.syn1)
    p0, p1 = _t(lt.syn0), _t(lt.syn1)
    for c, o, _ in _sg_batches(V):
        args = (c, points[o], codes[o], mask[o])
        j0, j1 = jsv._hs_step(j0, j1, *map(jnp.asarray, args), 0.05)
        p0, p1 = psv._hs_step(p0, p1, *map(_t, args), 0.05)
    _close(_np(p0), np.asarray(j0), STEP)
    _close(_np(p1), np.asarray(j1), STEP)


def _cbow_batches(V, window=3, n=3, seed=4):
    """CBOW windows of short sequences (padded slots) from few rows."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, V, int(rng.integers(2, 9))).astype(np.int32)
            for _ in range(40)]
    ctx, mask, cents = psv._cbow_windows(seqs, window)
    assert (mask == 0).any()
    out = []
    for _ in range(n):
        sel = rng.permutation(len(cents))[:80]
        out.append((ctx[sel], mask[sel], cents[sel],
                    rng.integers(0, V, (len(sel), 5)).astype(np.int32)))
    return out


@pytest.mark.parametrize("update_inputs", [True, False])
def test_cbow_ns_step_matches_jax_on_padded_windows(update_inputs):
    lt = lookup_table_from_jax(_jax_table())
    j0, j1 = jnp.asarray(lt.syn0), jnp.asarray(lt.syn1neg)
    p0, p1 = _t(lt.syn0), _t(lt.syn1neg)
    for batch in _cbow_batches(len(lt.vocab)):
        j0, j1 = jsv._cbow_ns_step(j0, j1, *map(jnp.asarray, batch), 0.05,
                                   update_inputs=update_inputs)
        p0, p1 = psv._cbow_ns_step(p0, p1, *map(_t, batch), 0.05,
                                   update_inputs=update_inputs)
    _close(_np(p0), np.asarray(j0), STEP)
    _close(_np(p1), np.asarray(j1), STEP)
    if not update_inputs:
        assert np.array_equal(_np(p0), lt.syn0)


def test_dm_step_matches_jax_cbow_over_the_concatenated_table():
    lt = lookup_table_from_jax(_jax_table())
    rng = np.random.default_rng(5)
    dv = (rng.normal(size=(4, lt.vector_length)) * 0.3).astype(np.float32)
    jdv, j1 = jnp.asarray(dv), jnp.asarray(lt.syn1neg)
    pdv, p1, p0 = _t(dv), _t(lt.syn1neg), _t(lt.syn0)
    for d, (ctx, mask, cents, negs) in zip(
            (2, 0, 2), _cbow_batches(len(lt.vocab), seed=6)):
        aug0 = jnp.concatenate([jdv[d:d + 1], jnp.asarray(lt.syn0)], 0)
        aug_ctx = np.concatenate([np.zeros((len(cents), 1), np.int32),
                                  ctx + 1], 1)
        aug_mask = np.concatenate([np.ones((len(cents), 1), np.float32),
                                   mask], 1)
        aug0, j1 = jsv._cbow_ns_step(aug0, j1, jnp.asarray(aug_ctx),
                                     jnp.asarray(aug_mask),
                                     jnp.asarray(cents), jnp.asarray(negs),
                                     0.05)
        jdv = jdv.at[d].set(aug0[0])
        pdv, p1 = ppv._dm_step(pdv, d, p0, p1, _t(ctx), _t(mask),
                               _t(cents), _t(negs), 0.05)
    _close(_np(pdv), np.asarray(jdv), STEP)
    _close(_np(p1), np.asarray(j1), STEP)
    assert np.array_equal(_np(p0), lt.syn0)     # the word rows: read only


def test_glove_step_matches_jax():
    rng = np.random.default_rng(7)
    V, D, B = 12, 8, 200
    state = [(rng.normal(size=(V, D)) * 0.1).astype(np.float32),
             (rng.normal(size=(V, D)) * 0.1).astype(np.float32),
             np.zeros(V, np.float32), np.zeros(V, np.float32),
             np.ones((V, D), np.float32), np.ones((V, D), np.float32),
             np.ones(V, np.float32), np.ones(V, np.float32)]
    js = tuple(jnp.asarray(a) for a in state)
    ps = tuple(_t(a) for a in state)
    for _ in range(3):
        ii = rng.integers(0, V, B).astype(np.int32)
        jj = rng.integers(0, V, B).astype(np.int32)
        x = rng.uniform(0.2, 30.0, B).astype(np.float32)
        logx = np.log(x)
        fx = np.minimum(1.0, (x / 10.0) ** 0.75).astype(np.float32)
        batch = (ii, jj, logx, fx)
        js = jglove._glove_step(*js, *map(jnp.asarray, batch), 0.05)
        ps = pglove._glove_step(*ps, *map(_t, batch), 0.05)
    for got, want in zip(ps, js):
        _close(_np(got), np.asarray(want), STEP)


def test_host_pair_builders_equal_jax():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 50, n).astype(np.int32)
            for n in (0, 1, 2, 3, 7, 30, 200)]
    for window in (1, 3, 8):
        for a, b in zip(jsv._cbow_windows(seqs, window),
                        psv._cbow_windows(seqs, window)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        ra, rb = np.random.default_rng(9), np.random.default_rng(9)
        for a, b in zip(jsv._skipgram_pairs(seqs, window, ra),
                        psv._skipgram_pairs(seqs, window, rb)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ra.random() == rb.random()      # the same draws taken
    for a, b in zip(jsv._cbow_windows([], 4), psv._cbow_windows([], 4)):
        assert a.shape == b.shape and a.dtype == b.dtype


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------

#: step -> the positions of its batch arguments and of its lr
BATCH_ARGS = {"_sgns_step": (2, 5), "_hs_step": (2, 6),
              "_cbow_ns_step": (2, 6), "_glove_step": (8, 12),
              "_dm_step": (4, 8)}


def _spy_steps(monkeypatch, modules):
    """Record every step call's batch arrays and lr, in call order."""
    calls = []
    for mod in modules:
        for name, (lo, hi) in BATCH_ARGS.items():
            real = getattr(mod, name, None)
            if real is None:
                continue

            def spy(*args, _real=real, _name=name, _lo=lo, _hi=hi, **kw):
                calls.append((_name, [np.array(a) for a in args[_lo:_hi]],
                              float(args[_hi])))
                return _real(*args, **kw)
            monkeypatch.setattr(mod, name, spy)
    return calls


def _same_batches(jcalls, pcalls):
    assert len(jcalls) == len(pcalls) > 0
    for (jn, jb, jlr), (pn, pb, plr) in zip(jcalls, pcalls):
        if jn == "_cbow_ns_step" and pn == "_dm_step":
            # PV-DM: the JAX windows over [dv_d; syn0] have the doc in
            # slot 0 and the words shifted by one
            ctx, mask, cents, negs = jb
            assert (ctx[:, 0] == 0).all() and (mask[:, 0] == 1).all()
            jb = [ctx[:, 1:] - 1, mask[:, 1:], cents, negs]
        else:
            assert jn == pn
        assert jlr == plr
        for a, b in zip(jb, pb):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_tables(jlt, plt, names=("syn0", "syn1", "syn1neg")):
    for name in names:
        _close(getattr(plt, name), getattr(jlt, name), FIT, floor=0.0)


@pytest.mark.parametrize("kwargs", [
    dict(negative=5),
    dict(negative=0, use_hierarchic_softmax=True),
    dict(elements_algo="cbow", negative=5),
    dict(negative=5, sampling=1e-3),
], ids=["sg_ns", "sg_hs", "cbow", "sg_ns_subsampled"])
def test_word2vec_fit_matches_jax(monkeypatch, kwargs):
    sents = _topics()
    jw = J.Word2Vec(layer_size=16, window=3, epochs=2, seed=1,
                    learning_rate=0.05, batch_size=64, **kwargs)
    pw = Word2Vec(layer_size=16, window=3, epochs=2, seed=1,
                  learning_rate=0.05, batch_size=64, device="cpu", **kwargs)
    jcalls = _spy_steps(monkeypatch, [jsv])
    jw.fit(sents)
    pcalls = _spy_steps(monkeypatch, [psv])
    held = pw.lookup_table          # None until fit builds the vocab
    pw.fit(sents)
    assert held is None
    _same_batches(jcalls, pcalls)
    _same_tables(jw.lookup_table, pw.lookup_table)
    assert [w.word for w in pw.vocab.vocab_words()] == [
        w.word for w in jw.vocab.vocab_words()]


def test_fit_never_writes_through_to_the_host_arrays():
    """``_put_table`` copies: on the CPU a tensor made by
    ``torch.from_numpy`` would share the lookup table's arrays, and the
    in-place steps would write into them."""
    pw = Word2Vec(layer_size=8, window=2, epochs=1, seed=2, device="cpu")
    sents = _topics(30)
    pw.build_vocab(sents)
    lt = pw.lookup_table
    before = {n: getattr(lt, n) for n in ("syn0", "syn1", "syn1neg")}
    snap = {n: a.copy() for n, a in before.items()}
    pw.fit(sents)
    for n, a in before.items():
        assert np.array_equal(a, snap[n]), n
    assert not np.array_equal(lt.syn0, snap["syn0"])


def test_glove_fit_matches_jax(monkeypatch):
    sents = _topics(60, seed=3)
    jg = J.Glove(layer_size=8, window=3, epochs=3, seed=2, batch_size=256,
                 x_max=10.0)
    pg = Glove(layer_size=8, window=3, epochs=3, seed=2, batch_size=256,
               x_max=10.0, device="cpu")
    # the co-occurrence entries in the dict's insertion order, float64 sums
    seqs = [np.array([i % 7 for i in range(n)], np.int32) for n in (5, 12)]
    for a, b in zip(jg._cooccurrences(seqs), pg._cooccurrences(seqs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jcalls = _spy_steps(monkeypatch, [jglove])
    jg.fit(sents)
    pcalls = _spy_steps(monkeypatch, [pglove])
    pg.fit(sents)
    _same_batches(jcalls, pcalls)
    _same_tables(jg.lookup_table, pg.lookup_table, ("syn0",))


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors_fit_and_infer_match_jax(monkeypatch, algo):
    docs = _topics(40, seed=5)
    kw = dict(layer_size=12, epochs=2, seed=4, window=3, batch_size=64,
              sequence_algo=algo)
    jp = J.ParagraphVectors(**kw)
    pp = ParagraphVectors(device="cpu", **kw)
    jcalls = _spy_steps(monkeypatch, [jsv, jpv])
    jp.fit_documents(docs)
    pcalls = _spy_steps(monkeypatch, [psv, ppv])
    pp.fit_documents(docs)
    _same_batches(jcalls, pcalls)
    _close(pp.doc_vectors, jp.doc_vectors, FIT, floor=0.0)
    _same_tables(jp.lookup_table, pp.lookup_table)
    lt = pp.lookup_table
    syn0, syn1neg = lt.syn0.copy(), lt.syn1neg.copy()
    jcalls = _spy_steps(monkeypatch, [jpv])
    jv = jp.infer_vector(docs[3])
    pcalls = _spy_steps(monkeypatch, [ppv])
    pv = pp.infer_vector(docs[3])
    _same_batches(jcalls, pcalls)
    assert len(pcalls) == 50
    _close(pv, jv, FIT, floor=0.0)
    assert np.array_equal(lt.syn1neg, syn1neg)
    assert np.array_equal(lt.syn0, syn0)
    assert pp.infer_vector("zzz qqq").shape == (12,)   # no known word
    assert pp.similarity_to_label(docs[3], "DOC_3") == pytest.approx(
        jp.similarity_to_label(docs[3], "DOC_3"), abs=1e-4)


def test_pv_dm_leaves_the_word_rows_alone():
    """PV-DM over a prebuilt table (no word training): ``lt.syn0`` bit
    for bit as it was, the doc vectors those of the JAX package."""
    docs = _topics(30, seed=6)
    kw = dict(layer_size=8, epochs=2, seed=8, window=2,
              sequence_algo="dm", train_words=False)
    jp = J.ParagraphVectors(**kw)
    jp.build_vocab([d.split() for d in docs])
    jlt = jp.lookup_table
    rng = np.random.default_rng(3)
    jlt.syn1neg = (rng.normal(size=jlt.syn1neg.shape) * 0.2).astype(
        np.float32)
    pp = ParagraphVectors(device="cpu", **kw)
    pp.lookup_table = lookup_table_from_jax(jlt)
    pp.vocab = pp.lookup_table.vocab
    syn0 = pp.lookup_table.syn0.copy()
    jp.fit_documents(docs)
    pp.fit_documents(docs)
    assert np.array_equal(pp.lookup_table.syn0, syn0)
    _close(pp.doc_vectors, jp.doc_vectors, FIT, floor=0.0)
    _close(pp.lookup_table.syn1neg, jp.lookup_table.syn1neg, FIT,
           floor=0.0)


# ---------------------------------------------------------------------------
# vocab, Huffman, lookup
# ---------------------------------------------------------------------------

def test_vocab_and_huffman_equal_jax_with_many_ties():
    rng = np.random.default_rng(2)
    words = [f"w{i:02d}" for i in range(41)]
    # counts 1..4, ten words each, so the heap breaks many ties by id
    seqs = [[w] * (1 + i % 4) for i, w in enumerate(words)]
    seqs = [list(rng.permutation(sum(seqs, [])))]
    jc = J.VocabConstructor(1).build_vocab(seqs)
    pc = VocabConstructor(1).build_vocab(seqs)
    assert [(w.word, w.count, w.index) for w in pc.vocab_words()] == [
        (w.word, w.count, w.index) for w in jc.vocab_words()]
    assert pc.total_word_count == jc.total_word_count
    for a, b in zip(pc.vocab_words(), jc.vocab_words()):
        assert (a.codes, a.points) == (b.codes, b.points), a.word
    for a, b in zip(huffman_arrays(pc), j_huffman_arrays(jc)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the same through build_huffman on a hand-built cache
    jh, ph = J.VocabCache(), VocabCache()
    for i in range(30):
        jh.add(J.VocabWord(f"x{i}", float(1 + i // 10)))
        ph.add(VocabWord(f"x{i}", float(1 + i // 10)))
    J.build_huffman(jh)
    build_huffman(ph)
    assert [(w.codes, w.points) for w in ph.vocab_words()] == [
        (w.codes, w.points) for w in jh.vocab_words()]


def test_lookup_negatives_and_queries_equal_jax():
    jlt = _jax_table(seed=4)
    lt = lookup_table_from_jax(jlt)
    a = jlt.sample_negatives(np.random.default_rng(1), (50, 7))
    b = lt.sample_negatives(np.random.default_rng(1), (50, 7))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for w in ("a1", "b2", "the"):
        assert lt.words_nearest(w, 5) == jlt.words_nearest(w, 5)
        assert lt.similarity(w, "c3") == jlt.similarity(w, "c3")
        assert np.array_equal(lt.get_word_vector(w), jlt.get_word_vector(w))
    vec = jlt.syn0[3] + 0.5
    assert lt.words_nearest(vec, 4) == jlt.words_nearest(vec, 4)
    assert lt.get_word_vector("zzz") is None and not lt.has_word("zzz")
    assert lt.word_vectors_matrix() is lt.syn0


def test_vectorizers_equal_jax():
    docs = _topics(20, seed=7) + ["the a1 a1 zzz", "of"]
    for jcls, pcls in ((J.BagOfWordsVectorizer, BagOfWordsVectorizer),
                       (J.TfidfVectorizer, TfidfVectorizer)):
        kw = dict(min_word_frequency=2, stop_words=("and",))
        a = jcls(**kw).fit_transform(docs)
        b = pcls(**kw).fit_transform(docs)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# serializer
# ---------------------------------------------------------------------------

def _payload(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _zip_members(path):
    with zipfile.ZipFile(path) as zf:
        out = {n: zf.read(n) for n in zf.namelist()}
    with zipfile.ZipFile(io.BytesIO(out.pop("weights.npz"))) as npz:
        out.update({f"weights.npz/{n}": npz.read(n)
                    for n in npz.namelist()})
    return out


@pytest.mark.parametrize("name", ["v.txt", "v.bin", "v.txt.gz", "v.bin.gz"])
def test_word2vec_files_byte_for_byte_both_ways(tmp_path, name):
    jlt = _jax_table(seed=5)
    lt = lookup_table_from_jax(jlt)
    jpath, ppath = tmp_path / f"j_{name}", tmp_path / f"p_{name}"
    J.WordVectorSerializer.write_word2vec_format(jlt, jpath)
    WordVectorSerializer.write_word2vec_format(lt, ppath)
    assert _payload(ppath) == _payload(jpath)
    # each package reads the other's file into the same table
    got = WordVectorSerializer.read_word2vec_format(jpath)
    want = J.WordVectorSerializer.read_word2vec_format(ppath)
    assert [w.word for w in got.vocab.vocab_words()] == [
        w.word for w in want.vocab.vocab_words()]
    assert np.array_equal(got.syn0, want.syn0)
    for a, b in zip(got.vocab.vocab_words(), want.vocab.vocab_words()):
        assert (a.codes, a.points) == (b.codes, b.points)
    if ".bin" in name:
        assert np.array_equal(got.syn0, lt.syn0)
    # and the port writes back what it read, byte for byte
    again = tmp_path / f"again_{name}"
    WordVectorSerializer.write_word2vec_format(got, again)
    assert _payload(again) == _payload(jpath)


def test_full_model_zip_both_ways(tmp_path):
    jlt = _jax_table(seed=6)
    lt = lookup_table_from_jax(jlt)
    J.WordVectorSerializer.write_full_model(jlt, tmp_path / "j.zip")
    WordVectorSerializer.write_full_model(lt, tmp_path / "p.zip")
    assert _zip_members(tmp_path / "p.zip") == _zip_members(
        tmp_path / "j.zip")
    got = WordVectorSerializer.read_full_model(tmp_path / "j.zip")
    want = J.WordVectorSerializer.read_full_model(tmp_path / "p.zip")
    for n in ("syn0", "syn1", "syn1neg"):
        assert np.array_equal(getattr(got, n), getattr(want, n))
        assert np.array_equal(getattr(got, n), getattr(lt, n))
    assert [(w.word, w.count, w.codes, w.points)
            for w in got.vocab.vocab_words()] == [
        (w.word, w.count, w.codes, w.points)
        for w in want.vocab.vocab_words()]


def test_sample_w2v_fixture_reads_as_jax():
    p = FIXTURES / "sample_w2v.bin"
    got = WordVectorSerializer.read_word2vec_format(p)
    want = J.WordVectorSerializer.read_word2vec_format(p)
    assert [w.word for w in got.vocab.vocab_words()] == [
        w.word for w in want.vocab.vocab_words()]
    assert np.array_equal(got.syn0, want.syn0)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="device=None trains on the card there")
def test_device_none_raises_without_a_card():
    for make in (SequenceVectors, Word2Vec, ParagraphVectors, Glove,
                 lambda: TreeVectorizer(lambda t: None, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_trainers_hold_no_fallback():
    """No ``try`` and no environment switch in the device modules: a run
    the caller put on the card stays there or raises."""
    for name in ("sequencevectors", "word2vec", "paragraph_vectors",
                 "glove", "treeparser"):
        src = (ROOT / "deeplearning4j_tpu_torch" / "nlp"
               / f"{name}.py").read_text()
        tree = ast.parse(src)
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert "environ" not in src and "getenv" not in src


# ---------------------------------------------------------------------------
# the JAX package's gates (tests/test_nlp.py), mirrored on the port
# ---------------------------------------------------------------------------

def _corpus(n=300, seed=0):
    """Two topics; words within a topic co-occur, across topics never."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "mouse", "horse", "cow"]
    foods = ["apple", "bread", "cheese", "rice", "soup"]
    sents = []
    for _ in range(n):
        pool = animals if rng.random() < 0.5 else foods
        sents.append(" ".join(rng.choice(pool, size=6)))
    return sents, animals, foods


def test_default_tokenizer_and_preprocessor():
    tf = DefaultTokenizerFactory(CommonPreprocessor())
    toks = tf.create("Hello, World! 123 foo.bar").get_tokens()
    assert toks == ["hello", "world", "foobar"]


def test_ngram_tokenizer():
    tf = NGramTokenizerFactory(min_n=1, max_n=2)
    toks = tf.create("a b c").get_tokens()
    assert "a b" in toks and "b c" in toks and "a" in toks


def test_sentence_iterators(tmp_path):
    it = CollectionSentenceIterator(["s one", "s two"])
    assert list(it) == ["s one", "s two"]
    assert list(it) == ["s one", "s two"]  # reset works
    p = tmp_path / "corpus.txt"
    p.write_text("line1\n\nline2\n")
    assert list(BasicLineIterator(p)) == ["line1", "line2"]


def test_labels_source():
    ls = LabelsSource()
    assert ls.next_label() == "DOC_0"
    assert ls.next_label() == "DOC_1"
    assert ls.get_labels() == ["DOC_0", "DOC_1"]


def test_vocab_construction_orders_by_frequency():
    seqs = [["a", "a", "a", "b", "b", "c"]]
    cache = VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    assert len(cache) == 2  # c filtered
    assert cache.word_at(0) == "a" and cache.word_at(1) == "b"
    assert cache.word_frequency("a") == 3


def test_huffman_codes_are_prefix_free():
    cache = VocabCache()
    for w, c in [("a", 40), ("b", 30), ("c", 20), ("d", 10)]:
        cache.add(VocabWord(w, c))
    build_huffman(cache)
    codes = ["".join(map(str, w.codes)) for w in cache.vocab_words()]
    assert len(set(codes)) == 4
    for i, a in enumerate(codes):
        for j, b in enumerate(codes):
            if i != j:
                assert not a.startswith(b)
    assert len(codes[0]) <= len(codes[-1])
    cds, pts, msk = huffman_arrays(cache)
    assert cds.shape == pts.shape == msk.shape
    assert pts.max() < len(cache) - 1


@pytest.mark.parametrize("kwargs", [
    dict(negative=5),                                 # skip-gram + NS
    dict(negative=0, use_hierarchic_softmax=True),    # skip-gram + HS
    dict(elements_algo="cbow", negative=5),           # CBOW + NS
])
def test_word2vec_separates_topics(kwargs):
    sents, animals, foods = _corpus()
    w2v = Word2Vec(layer_size=32, window=3, epochs=8, seed=1,
                   learning_rate=0.05, device="cpu", **kwargs)
    w2v.fit(sents)
    within = w2v.similarity("cat", "dog")
    across = w2v.similarity("cat", "bread")
    assert within > across, (within, across)
    nearest = w2v.words_nearest("cat", top_n=4)
    assert sum(w in animals for w in nearest) >= 3, nearest


def test_word2vec_vector_shape_and_unknown():
    sents, _, _ = _corpus(50)
    w2v = Word2Vec(layer_size=16, epochs=1, device="cpu")
    w2v.fit(sents)
    assert w2v.get_word_vector("cat").shape == (16,)
    assert w2v.get_word_vector("zzz") is None
    assert np.isnan(w2v.similarity("cat", "zzz"))


def test_subsampling_runs():
    sents, _, _ = _corpus(50)
    w2v = Word2Vec(layer_size=8, epochs=2, sampling=1e-3, device="cpu")
    w2v.fit(sents)
    assert w2v.get_word_vector("cat") is not None


def test_word2vec_text_roundtrip(tmp_path):
    sents, _, _ = _corpus(50)
    w2v = Word2Vec(layer_size=8, epochs=1, device="cpu")
    w2v.fit(sents)
    p = tmp_path / "vecs.txt"
    WordVectorSerializer.write_word2vec_format(w2v.lookup_table, p)
    table = WordVectorSerializer.read_word2vec_format(p)
    np.testing.assert_allclose(
        table.get_word_vector("cat"), w2v.get_word_vector("cat"), atol=1e-5)
    assert len(table.vocab) == len(w2v.vocab)


def test_full_model_roundtrip(tmp_path):
    sents, _, _ = _corpus(50)
    w2v = Word2Vec(layer_size=8, epochs=1, device="cpu")
    w2v.fit(sents)
    p = tmp_path / "model.zip"
    WordVectorSerializer.write_full_model(w2v.lookup_table, p)
    table = WordVectorSerializer.read_full_model(p)
    np.testing.assert_allclose(table.syn0, w2v.lookup_table.syn0)
    np.testing.assert_allclose(table.syn1neg, w2v.lookup_table.syn1neg)
    vw = table.vocab.word_for("cat")
    assert vw.codes == w2v.vocab.word_for("cat").codes


def test_glove_separates_topics():
    sents, animals, _ = _corpus(200, seed=3)
    glove = Glove(layer_size=16, window=3, epochs=30, seed=2, device="cpu")
    glove.fit(sents)
    assert glove.similarity("cat", "dog") > glove.similarity("cat", "bread")


def test_paragraph_vectors_dbow_groups_docs():
    sents, _, _ = _corpus(60, seed=5)
    pv = ParagraphVectors(layer_size=16, epochs=6, seed=4,
                          sequence_algo="dbow", device="cpu")
    labels = [f"DOC_{i}" for i in range(len(sents))]
    pv.fit_documents(sents, labels)
    assert pv.get_doc_vector("DOC_0").shape == (16,)
    iv = pv.infer_vector(sents[0])
    assert iv.shape == (16,) and np.isfinite(iv).all()


def test_paragraph_vectors_dm_runs():
    sents, _, _ = _corpus(20, seed=6)
    pv = ParagraphVectors(layer_size=8, epochs=2, seed=4, sequence_algo="dm",
                          device="cpu")
    pv.fit_documents(sents[:10])
    assert pv.doc_vectors.shape == (10, 8)
    assert np.isfinite(pv.doc_vectors).all()


def test_bag_of_words():
    docs = ["cat dog cat", "dog bird"]
    v = BagOfWordsVectorizer()
    m = v.fit_transform(docs)
    assert m.shape == (2, 3)
    i_cat = v.vocab.index_of("cat")
    assert m[0, i_cat] == 2.0 and m[1, i_cat] == 0.0


def test_tfidf_downweights_common_terms():
    docs = ["cat dog", "cat bird", "cat fish"]
    v = TfidfVectorizer()
    m = v.fit_transform(docs)
    i_cat, i_dog = v.vocab.index_of("cat"), v.vocab.index_of("dog")
    assert m[0, i_cat] == pytest.approx(0.0)
    assert m[0, i_dog] > 0.0


def test_word2vec_binary_roundtrip(tmp_path):
    sents, _, _ = _corpus(50)
    w2v = Word2Vec(layer_size=8, epochs=1, device="cpu")
    w2v.fit(sents)
    for name in ("vecs.bin", "vecs.bin.gz"):
        p = tmp_path / name
        WordVectorSerializer.write_word2vec_format(w2v.lookup_table, p)
        table = WordVectorSerializer.read_word2vec_format(p)
        np.testing.assert_array_equal(
            table.get_word_vector("cat"),
            np.asarray(w2v.get_word_vector("cat"), np.float32))
        assert len(table.vocab) == len(w2v.vocab)
    p = tmp_path / "vecs.txt.gz"
    WordVectorSerializer.write_word2vec_format(w2v.lookup_table, p)
    table = WordVectorSerializer.read_word2vec_format(p)
    np.testing.assert_allclose(
        table.get_word_vector("cat"), w2v.get_word_vector("cat"), atol=1e-5)


def test_load_google_model_bin_fixture():
    p = os.path.join(FIXTURES, "sample_w2v.bin")
    table = WordVectorSerializer.read_word2vec_format(p)
    assert len(table.vocab) == 8
    assert table.vector_length == 5
    np.testing.assert_allclose(
        table.get_word_vector("the"),
        [-1.6038368, 0.06409992, 0.7408913, 0.1526192, 0.8637439],
        rtol=1e-6)
    assert table.get_word_vector("日本") is not None
    t2 = WordVectorSerializer.read_word2vec_format(p, binary=True)
    np.testing.assert_array_equal(t2.syn0, table.syn0)


# ---------------------------------------------------------------------------
# tests/test_convergence.py's dup_power comparison, on the port
# ---------------------------------------------------------------------------

def test_sgns_sqrt_scaling_beats_sum_and_mean():
    V, D, B, K = 8, 16, 512, 4
    rng = np.random.default_rng(5)
    init0 = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
    init1 = np.zeros((V, D), np.float32)
    groups = [np.arange(0, 4), np.arange(4, 8)]

    def pairs():
        g = groups[rng.integers(0, 2)]
        centers = rng.choice(g, B)
        contexts = rng.choice(g, B)
        negs = rng.choice(groups[1] if g[0] == 0 else groups[0], (B, K))
        return _t(centers), _t(contexts), _t(negs)

    batches = [pairs() for _ in range(6)]

    def run(power):
        s0, s1 = _t(init0), _t(init1)
        for c, o, n in batches:
            s0, s1 = psv._sgns_step(s0, s1, c, o, n, 0.1, dup_power=power)
        return _np(s0)

    def separation(emb):
        e = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                             1e-9)
        sims = e @ e.T
        within = np.mean([sims[i, j] for g in groups
                          for i in g for j in g if i != j])
        cross = np.mean([sims[i, j] for i in groups[0] for j in groups[1]])
        return within - cross

    emb_sqrt, emb_sum, emb_mean = run(0.5), run(0.0), run(1.0)
    sep_sqrt = separation(emb_sqrt)
    assert sep_sqrt > 1.0, f"sqrt scaling failed to separate: {sep_sqrt}"
    assert separation(emb_mean) < 0.5, (
        f"mean unexpectedly converged: {separation(emb_mean)}")
    norm_ratio = (np.linalg.norm(emb_sum) / np.linalg.norm(emb_sqrt))
    assert norm_ratio > 10.0, f"sum did not blow up: ratio {norm_ratio}"


def test_segment_sums_cpu_path_adds_as_segment_reduce_does():
    """The CPU's ``index_add_`` into the runs gives ``segment_reduce``'s
    sums bit for bit (each run added row after row, in order), so the
    CPU and the card sum a row's updates alike."""
    rng = np.random.default_rng(11)
    idx = _t(rng.zipf(1.3, 5000) % 400)
    vals = _t(rng.normal(size=(5000, 7)).astype(np.float32))
    order = torch.argsort(idx, stable=True)
    _, lengths = torch.unique_consecutive(idx[order], return_counts=True)
    for v in (vals[order], vals[order][:, 0]):
        want = torch.segment_reduce(v, "sum", lengths=lengths)
        assert torch.equal(psv._segment_sums(v, lengths), want)
