"""SequenceVectors: the generic embedding trainer.

Ref: deeplearning4j-nlp models/sequencevectors/SequenceVectors.java
(:103-110 buildVocab, :187-330 fit loop) and the element learning
algorithms models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java.

The reference's ``workers`` threads do per-pair hogwild updates on a
shared table (SequenceVectors.java:276-305). Here the host vectorizes
each epoch's training pairs into integer arrays (centers, contexts,
negatives | Huffman codes / points), and one step function applies a
whole batch of SGNS / CBOW / HS updates on the net's device: a gather, a
batched product, and a scatter of each touched row's summed update.

The scatter is deterministic on every device: the updates are sorted by
row (a stable sort, so each row's updates keep their batch order),
summed a row at a time in that order (``_segment_sums``) and written
once a row. ``index_add_`` straight into the table would sum with
atomics on CUDA, in an order that changes from run to run. The step
functions update their tables in place and return them (the JAX
package's steps donate theirs); the trainers copy the lookup table's
numpy arrays onto the device first (``_put_table``), so a step never
writes through to the host arrays.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import (VocabCache, VocabConstructor,
                                                huffman_arrays)


def _segment_sums(vals, lengths):
    """The sum of each run of ``vals`` rows (``lengths`` rows a run), row
    after row in order. On CUDA ``segment_reduce`` (``index_add_`` there
    sums with atomics); on the CPU ``index_add_`` into the runs, which
    adds in index order too, the same sums, in a sixth of the time."""
    if vals.is_cuda:
        return torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)
    run = torch.repeat_interleave(torch.arange(len(lengths)), lengths)
    return torch.zeros((len(lengths),) + vals.shape[1:],
                       dtype=vals.dtype).index_add_(0, run, vals)


def _row_sums(idx, upd, weight=None):
    """(rows, sums, counts): the distinct rows of ``idx`` in ascending
    order, the sum of the ``upd`` rows pointed at each (in batch order)
    and their count, or the sum of ``weight`` over them."""
    idx = idx.reshape(-1)
    order = torch.argsort(idx, stable=True)
    rows, lengths = torch.unique_consecutive(idx[order], return_counts=True)
    sums = _segment_sums(upd[order], lengths)
    if weight is None:
        cnt = lengths.to(upd.dtype)
    else:
        cnt = _segment_sums(weight.reshape(-1)[order], lengths)
    return rows, sums, cnt


def _add_rows(mat, rows, delta):
    """mat[rows] += delta for distinct ``rows``, in place."""
    mat.index_put_((rows,), mat[rows] + delta)
    return mat


def _scatter_mean_add(mat, idx, upd, power: float = 0.5, combine=None):
    """mat[idx] += sum of upd rows, scaled 1/count**power per index.

    The reference's hogwild threads apply each pair's update sequentially
    at the then-current weights, which self-limits as sigmoids saturate.
    A batched scatter-SUM (power=0) computes every duplicate-index update
    at the same stale point, multiplying the effective LR by the
    duplicate count (divergence for small vocabs); a scatter-MEAN
    (power=1) starves progress to one effective update per batch. The
    default 1/sqrt(count) is the stable compromise (tests compare it
    with both alternatives) and approaches the plain sum when indices
    are unique (large vocabs). In place; returns ``mat``.

    ``combine(rows, sums, counts, n_rows)``, where given, turns this
    process's (rows, sums, counts) into those of the whole batch before
    the scale (``nlp/distributed.py``: the ranks' chunks of one batch);
    None is the identity."""
    rows, sums, cnt = _row_sums(idx, upd)
    if combine is not None:
        rows, sums, cnt = combine(rows, sums, cnt, mat.shape[0])
    return _add_rows(mat, rows, sums / cnt.clamp(min=1.0)[:, None] ** power)


def _sgns_step(syn0, syn1neg, centers, contexts, negs, lr,
               dup_power: float = 0.5, combine=None):
    """One batched skip-gram negative-sampling update.

    For each pair (c, o) with K negatives n_k: standard SGNS gradients
    (ref: SkipGram.java iterateSample — per-pair scalar loop there).
    ``dup_power`` exposes the duplicate-index scaling for the convergence
    comparison test; production callers use the 0.5 default. ``combine``
    as ``_scatter_mean_add``'s, for both tables.
    """
    v = syn0[centers]                                   # [B, D]
    targets = torch.cat([contexts[:, None], negs], dim=1)    # [B, 1+K]
    labels = torch.cat([torch.ones_like(contexts[:, None], dtype=syn0.dtype),
                        torch.zeros(negs.shape, dtype=syn0.dtype,
                                    device=syn0.device)], dim=1)
    u = syn1neg[targets]                                # [B, 1+K, D]
    score = torch.sigmoid(torch.einsum("bd,bkd->bk", v, u))
    g = (labels - score) * lr                           # [B, 1+K]
    dv = torch.einsum("bk,bkd->bd", g, u)
    du = g[..., None] * v[:, None, :]                   # [B, 1+K, D]
    syn0 = _scatter_mean_add(syn0, centers, dv, dup_power, combine)
    syn1neg = _scatter_mean_add(syn1neg, targets.reshape(-1),
                                du.reshape(-1, du.shape[-1]), dup_power,
                                combine)
    return syn0, syn1neg


def _hs_step(syn0, syn1, centers, points, codes, mask, lr, combine=None):
    """One batched hierarchical-softmax update. points/codes/mask are the
    context word's padded Huffman path ([B, L]); label = 1 - code
    (word2vec convention, ref: SkipGram.java / Huffman path usage)."""
    v = syn0[centers]                                   # [B, D]
    u = syn1[points]                                    # [B, L, D]
    score = torch.sigmoid(torch.einsum("bd,bld->bl", v, u))
    g = ((1.0 - codes) - score) * lr * mask             # [B, L]
    dv = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * v[:, None, :]
    syn0 = _scatter_mean_add(syn0, centers, dv, combine=combine)
    # Padded path slots (index 0, mask 0) must not inflate the count
    # normalizer for syn1 row 0 — weight counts by the mask.
    rows, sums, cnt = _row_sums(points, du.reshape(-1, du.shape[-1]), mask)
    if combine is not None:
        rows, sums, cnt = combine(rows, sums, cnt, syn1.shape[0])
    syn1 = _add_rows(syn1, rows,
                     sums / torch.sqrt(cnt.clamp(min=1.0))[:, None])
    return syn0, syn1


def _cbow_ns_core(cvecs, ctx_mask, syn1neg, centers, negs, lr,
                  combine=None):
    """CBOW-NS over gathered context vectors ``cvecs`` [B, W, D]: h = the
    masked mean of the context predicts the center word. Updates
    ``syn1neg`` in place; returns (dh [B, D], syn1neg)."""
    cnt = ctx_mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    h = (cvecs * ctx_mask[..., None]).sum(dim=1) / cnt       # [B, D]
    targets = torch.cat([centers[:, None], negs], dim=1)
    labels = torch.cat([torch.ones_like(centers[:, None], dtype=h.dtype),
                        torch.zeros(negs.shape, dtype=h.dtype,
                                    device=h.device)], dim=1)
    u = syn1neg[targets]
    score = torch.sigmoid(torch.einsum("bd,bkd->bk", h, u))
    g = (labels - score) * lr
    dh = torch.einsum("bk,bkd->bd", g, u)                    # [B, D]
    du = g[..., None] * h[:, None, :]
    syn1neg = _scatter_mean_add(syn1neg, targets.reshape(-1),
                                du.reshape(-1, du.shape[-1]),
                                combine=combine)
    return dh, syn1neg


def _cbow_ns_step(syn0, syn1neg, ctx, ctx_mask, centers, negs, lr,
                  update_inputs=True, combine=None):
    """Batched CBOW with negative sampling: h = mean of context vectors
    predicts the center word (ref: CBOW.java). The input-side gradient is
    applied to every real context word (word2vec cbow_mean semantics)."""
    dh, syn1neg = _cbow_ns_core(syn0[ctx], ctx_mask, syn1neg, centers, negs,
                                lr, combine)
    if update_inputs:
        dctx = dh[:, None, :] * ctx_mask[..., None]     # [B, W, D]
        # Padded ctx slots point at word 0 but carry zero updates; the
        # count normalizer must not count them, so weight it by the mask.
        rows, sums, cnt = _row_sums(ctx, dctx.reshape(-1, dctx.shape[-1]),
                                    ctx_mask)
        if combine is not None:
            rows, sums, cnt = combine(rows, sums, cnt, syn0.shape[0])
        syn0 = _add_rows(syn0, rows,
                         sums / torch.sqrt(cnt.clamp(min=1.0))[:, None])
    return syn0, syn1neg


def _skipgram_pairs(seqs: List[np.ndarray], window: int,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """All (center, context) pairs with per-center random reduced window
    (word2vec's `b = random % window`), built vectorized on the host."""
    cs, os_ = [], []
    for s in seqs:
        n = len(s)
        if n < 2:
            continue
        b = rng.integers(1, window + 1, size=n)  # actual half-window per pos
        for off in range(1, window + 1):
            sel = b >= off
            idx = np.arange(n)
            left = idx - off
            ok = sel & (left >= 0)
            cs.append(s[idx[ok]]); os_.append(s[left[ok]])
            right = idx + off
            ok = sel & (right < n)
            cs.append(s[idx[ok]]); os_.append(s[right[ok]])
    if not cs:
        return (np.zeros(0, np.int32),) * 2
    return (np.concatenate(cs).astype(np.int32),
            np.concatenate(os_).astype(np.int32))


def _cbow_windows(seqs: List[np.ndarray], window: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(context [N, 2*window], mask, center [N]) arrays for CBOW: a row a
    position of every sequence of two or more words, its context words
    in sequence order packed to the left, the rest zeros with mask 0.
    Built a sequence at a time with numpy."""
    ctxs, masks, cents = [], [], []
    W = 2 * window
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    for s in seqs:
        n = len(s)
        if n < 2:
            continue
        j = np.arange(n)[:, None] + offs[None, :]            # [n, W]
        ok = (j >= 0) & (j < n)
        # a stable sort of the invalid flags packs the valid slots left,
        # each row's in sequence order
        pick = np.argsort(~ok, axis=1, kind="stable")
        j = np.take_along_axis(j, pick, axis=1)
        ok = np.take_along_axis(ok, pick, axis=1)
        ctxs.append(np.where(ok, s[np.clip(j, 0, n - 1)], 0).astype(np.int32))
        masks.append(ok.astype(np.float32))
        cents.append(np.asarray(s, np.int32))
    if not cents:
        return np.zeros((0, W), np.int32), np.zeros((0, W), np.float32), \
            np.zeros(0, np.int32)
    return np.concatenate(ctxs), np.concatenate(masks), np.concatenate(cents)


class SequenceVectors:
    """Generic embedding trainer over element sequences.

    elements_algo: 'skipgram' | 'cbow' (ref: learning/impl/elements/).
    use_hierarchic_softmax / negative mirror the reference's knobs.
    ``device=None`` trains on the CUDA card and raises without one;
    ``device="cpu"`` runs the same steps on the CPU.
    """

    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, epochs: int = 1,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 negative: int = 5, use_hierarchic_softmax: bool = False,
                 sampling: float = 0.0, elements_algo: str = "skipgram",
                 batch_size: int = 512, seed: int = 123,
                 stop_words: Sequence[str] = (), device=None):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax or negative <= 0
        self.sampling = sampling
        self.elements_algo = elements_algo.lower()
        self.batch_size = batch_size
        self.seed = seed
        self.stop_words = stop_words
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None

    # -- vocab --------------------------------------------------------
    def build_vocab(self, token_sequences: Iterable[Sequence[str]]) -> None:
        self.vocab = VocabConstructor(
            self.min_word_frequency, self.stop_words).build_vocab(
                token_sequences)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, self.seed,
            use_hs=self.use_hs, negative=self.negative)

    def _index_sequences(self, token_sequences: Iterable[Sequence[str]]
                         ) -> List[np.ndarray]:
        assert self.vocab is not None
        out = []
        for seq in token_sequences:
            idx = [self.vocab.index_of(t) for t in seq]
            out.append(np.array([i for i in idx if i >= 0], dtype=np.int32))
        return out

    def _subsample(self, seqs: List[np.ndarray],
                   rng: np.random.Generator) -> List[np.ndarray]:
        """Frequent-word subsampling (word2vec `sample` knob; ref
        SkipGram.java pre-filtering)."""
        if self.sampling <= 0 or self.vocab is None:
            return seqs
        counts = np.array([w.count for w in self.vocab.vocab_words()])
        freq = counts / max(self.vocab.total_word_count, 1.0)
        keep = np.minimum(
            1.0, (np.sqrt(freq / self.sampling) + 1) * self.sampling / np.maximum(freq, 1e-12))
        return [s[rng.random(len(s)) < keep[s]] for s in seqs]

    # -- device placement hooks (overridden by a sharded trainer) ------
    def _put_table(self, arr) -> torch.Tensor:
        """An embedding table on the trainer's device: always a copy, so
        the in-place steps never write through to the host array."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def _put_batch(self, arr) -> torch.Tensor:
        """A training batch on the trainer's device."""
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _adjust_selection(self, sel: np.ndarray) -> np.ndarray:
        """Hook to align batch size with the device count."""
        return sel

    def _step_kwargs(self) -> dict:
        """Keyword arguments every step call gets: a sharded trainer's
        cross-rank ``combine``; none in one process."""
        return {}

    # -- training -----------------------------------------------------
    def fit(self, token_sequences: Sequence[Sequence[str]]) -> None:
        if self.vocab is None:
            self.build_vocab(token_sequences)
        lt = self.lookup_table
        assert lt is not None
        rng = np.random.default_rng(self.seed)
        seqs0 = self._index_sequences(token_sequences)
        syn0 = self._put_table(lt.syn0)
        syn1 = self._put_table(lt.syn1)
        syn1neg = self._put_table(lt.syn1neg)
        if self.use_hs:
            w_codes, w_points, w_mask = huffman_arrays(self.vocab)
        step_kw = self._step_kwargs()

        total_steps = max(1, self.epochs)
        for epoch in range(self.epochs):
            # Linear LR decay across epochs (SequenceVectors decays per
            # processed word; per-epoch is the batched equivalent).
            frac = epoch / total_steps
            lr = max(self.min_learning_rate,
                     self.learning_rate * (1.0 - frac))
            seqs = self._subsample(seqs0, rng)
            if self.elements_algo == "cbow":
                ctx, mask, cents = _cbow_windows(seqs, self.window)
                order = rng.permutation(len(cents))
                for s in range(0, len(order), self.batch_size):
                    sel = self._adjust_selection(order[s:s + self.batch_size])
                    if not len(sel):
                        continue
                    negs = lt.sample_negatives(
                        rng, (len(sel), max(1, self.negative)))
                    syn0, syn1neg = _cbow_ns_step(
                        syn0, syn1neg, self._put_batch(ctx[sel]),
                        self._put_batch(mask[sel]), self._put_batch(cents[sel]),
                        self._put_batch(negs), lr, **step_kw)
            else:
                cs, os_ = _skipgram_pairs(seqs, self.window, rng)
                order = rng.permutation(len(cs))
                for s in range(0, len(order), self.batch_size):
                    sel = self._adjust_selection(order[s:s + self.batch_size])
                    if not len(sel):
                        continue
                    if self.use_hs:
                        pts = w_points[os_[sel]]
                        cds = w_codes[os_[sel]]
                        msk = w_mask[os_[sel]]
                        syn0, syn1 = _hs_step(
                            syn0, syn1, self._put_batch(cs[sel]),
                            self._put_batch(pts), self._put_batch(cds),
                            self._put_batch(msk), lr, **step_kw)
                    else:
                        negs = lt.sample_negatives(
                            rng, (len(sel), max(1, self.negative)))
                        syn0, syn1neg = _sgns_step(
                            syn0, syn1neg, self._put_batch(cs[sel]),
                            self._put_batch(os_[sel]), self._put_batch(negs), lr,
                            **step_kw)
        lt.syn0 = syn0.cpu().numpy()
        lt.syn1 = syn1.cpu().numpy()
        lt.syn1neg = syn1neg.cpu().numpy()

    # -- queries delegate to the lookup table -------------------------
    def similarity(self, a: str, b: str) -> float:
        return self.lookup_table.similarity(a, b)

    def words_nearest(self, word, top_n: int = 10) -> List[str]:
        return self.lookup_table.words_nearest(word, top_n)

    def get_word_vector(self, word: str):
        return self.lookup_table.get_word_vector(word)
