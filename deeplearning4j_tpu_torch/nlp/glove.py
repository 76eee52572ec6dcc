"""GloVe: co-occurrence counting + weighted least-squares factorization.

Ref: deeplearning4j-nlp models/glove/{Glove,AbstractCoOccurrences}.java and
models/embeddings/learning/impl/elements/GloVe.java (AdaGrad per-element
updates, xMax=100, alpha=0.75).

The co-occurrence table is built on the host into COO arrays; one AdaGrad
step on the trainer's device factorizes a whole minibatch of entries
(the reference's per-pair scalar loop becomes a batched gather / scatter,
each touched row written once, in a deterministic order:
``sequencevectors._row_sums``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequencevectors import _add_rows, _row_sums
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


def _scatter_add(mat, idx, upd):
    """mat.at[idx].add(upd): duplicates summed, in place."""
    rows, sums, _ = _row_sums(idx, upd)
    return _add_rows(mat, rows, sums)


def _glove_step(w, wt, b, bt, gw, gwt, gb, gbt, ii, jj, logx, fx, lr):
    """AdaGrad on J = f(x) (w_i·wt_j + b_i + bt_j - log x)^2. The
    accumulators take the whole batch's squared gradients before any row
    steps, and each entry's step reads its row's updated accumulator.
    Every table is updated in place; returns the eight."""
    wi, wj = w[ii], wt[jj]                       # [B, D]
    diff = (torch.einsum("bd,bd->b", wi, wj) + b[ii] + bt[jj] - logx)
    g = fx * diff                                # [B]
    dwi = g[:, None] * wj
    dwj = g[:, None] * wi
    # AdaGrad accumulators (scatter-add of squared grads, then scaled step)
    gw = _scatter_add(gw, ii, dwi * dwi)
    gwt = _scatter_add(gwt, jj, dwj * dwj)
    gb = _scatter_add(gb, ii, g * g)
    gbt = _scatter_add(gbt, jj, g * g)
    w = _scatter_add(w, ii, -lr * dwi / torch.sqrt(gw[ii] + 1e-8))
    wt = _scatter_add(wt, jj, -lr * dwj / torch.sqrt(gwt[jj] + 1e-8))
    b = _scatter_add(b, ii, -lr * g / torch.sqrt(gb[ii] + 1e-8))
    bt = _scatter_add(bt, jj, -lr * g / torch.sqrt(gbt[jj] + 1e-8))
    return w, wt, b, bt, gw, gwt, gb, gbt


class Glove:
    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, epochs: int = 25,
                 learning_rate: float = 0.05, x_max: float = 100.0,
                 alpha: float = 0.75, symmetric: bool = True,
                 batch_size: int = 8192, seed: int = 123,
                 tokenizer_factory: Optional[DefaultTokenizerFactory] = None,
                 device=None):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.batch_size = batch_size
        self.seed = seed
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None

    def _cooccurrences(self, seqs: List[np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Distance-weighted co-occurrence counts (1/d), symmetric window
        (ref: AbstractCoOccurrences)."""
        table: Dict[Tuple[int, int], float] = {}
        for s in seqs:
            n = len(s)
            for i in range(n):
                for off in range(1, self.window + 1):
                    j = i + off
                    if j >= n:
                        break
                    wgt = 1.0 / off
                    a, bb = int(s[i]), int(s[j])
                    table[(a, bb)] = table.get((a, bb), 0.0) + wgt
                    if self.symmetric:
                        table[(bb, a)] = table.get((bb, a), 0.0) + wgt
        if not table:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        keys = np.array(list(table.keys()), dtype=np.int32)
        vals = np.array(list(table.values()), dtype=np.float32)
        return keys[:, 0], keys[:, 1], vals

    def fit(self, sentences: Iterable) -> None:
        token_seqs = [self.tokenizer_factory.create(s).get_tokens()
                      if isinstance(s, str) else list(s) for s in sentences]
        self.vocab = VocabConstructor(
            self.min_word_frequency).build_vocab(token_seqs)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, self.seed)
        idx_seqs = []
        for seq in token_seqs:
            ids = [self.vocab.index_of(t) for t in seq]
            idx_seqs.append(np.array([i for i in ids if i >= 0], np.int32))
        ii, jj, x = self._cooccurrences(idx_seqs)
        if len(x) == 0:
            return
        logx = np.log(x)
        fx = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(np.float32)

        V, D = len(self.vocab), self.layer_size
        rng = np.random.default_rng(self.seed)
        scale = 0.5 / D

        def put(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        w = put((rng.random((V, D)) - 0.5) * 2 * scale)
        wt = put((rng.random((V, D)) - 0.5) * 2 * scale)
        b, bt = put(np.zeros(V)), put(np.zeros(V))
        gw, gwt = put(np.ones((V, D))), put(np.ones((V, D)))
        gb, gbt = put(np.ones(V)), put(np.ones(V))
        state = (w, wt, b, bt, gw, gwt, gb, gbt)

        def batch(a):
            return torch.as_tensor(a, device=self.device)

        for _ in range(self.epochs):
            order = rng.permutation(len(x))
            for s in range(0, len(order), self.batch_size):
                sel = order[s:s + self.batch_size]
                state = _glove_step(
                    *state, batch(ii[sel]), batch(jj[sel]),
                    batch(logx[sel]), batch(fx[sel]), self.learning_rate)
        w, wt = state[0], state[1]
        # Final embedding = w + wt (standard GloVe practice).
        self.lookup_table.syn0 = (w + wt).cpu().numpy()

    def similarity(self, a: str, b: str) -> float:
        return self.lookup_table.similarity(a, b)

    def words_nearest(self, word, top_n: int = 10) -> List[str]:
        return self.lookup_table.words_nearest(word, top_n)

    def get_word_vector(self, word: str):
        return self.lookup_table.get_word_vector(word)
