"""Embedding lookup table + WordVectors query API.

Ref: deeplearning4j-nlp models/embeddings/inmemory/InMemoryLookupTable.java
(syn0/syn1/syn1neg weight matrices, negative-sampling table) and
models/embeddings/wordvectors/WordVectorsImpl.java (similarity,
wordsNearest, getWordVectorMatrix).

The reference stores weights as INDArrays updated in place by racing
threads; here they are numpy arrays on the host, which a trainer copies
onto its device, trains there and copies back (see sequencevectors.py). The unigram^0.75 negative-sampling table
(InMemoryLookupTable.makeTable) becomes a cumulative-distribution array
sampled by binary search — no 100M-entry table materialization.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InMemoryLookupTable:
    def __init__(self, vocab: VocabCache, vector_length: int = 100,
                 seed: int = 123, use_hs: bool = True, negative: float = 5.0):
        self.vocab = vocab
        self.vector_length = vector_length
        self.use_hs = use_hs
        self.negative = negative
        V, D = len(vocab), vector_length
        rng = np.random.default_rng(seed)
        # word2vec-style init: uniform in +-0.5/D for syn0, zeros for syn1*.
        self.syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        self.syn1 = np.zeros((V, D), dtype=np.float32)      # HS inner nodes
        self.syn1neg = np.zeros((V, D), dtype=np.float32)   # NS outputs
        # Cumulative unigram^0.75 distribution for negative sampling.
        counts = np.array([w.count for w in vocab.vocab_words()],
                          dtype=np.float64)
        if counts.size:
            p = counts ** 0.75
            self._neg_cdf = np.cumsum(p / p.sum())
        else:
            self._neg_cdf = np.array([1.0])

    def sample_negatives(self, rng: np.random.Generator,
                         shape: Tuple[int, ...]) -> np.ndarray:
        u = rng.random(shape)
        return np.searchsorted(self._neg_cdf, u).astype(np.int32)

    # --- WordVectors query API (ref: WordVectorsImpl.java) ---

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

    def has_word(self, word: str) -> bool:
        return word in self.vocab

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = (np.linalg.norm(va) * np.linalg.norm(vb)) or 1e-12
        return float(np.dot(va, vb) / denom)

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = list(exclude) + [word_or_vec]
            if vec is None:
                return []
        else:
            vec = np.asarray(word_or_vec, dtype=np.float32)
        norms = np.linalg.norm(self.syn0, axis=1)
        norms[norms == 0] = 1e-12
        sims = self.syn0 @ vec / (norms * (np.linalg.norm(vec) or 1e-12))
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out

    def word_vectors_matrix(self) -> np.ndarray:
        return self.syn0
