"""Bag-of-words and TF-IDF text vectorizers.

Ref: deeplearning4j-nlp bagofwords/vectorizer/{BagOfWordsVectorizer,
TfidfVectorizer}.java (fit a vocab over documents, transform a document
into a counts / tf-idf row vector).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[DefaultTokenizerFactory] = None,
                 stop_words: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = stop_words
        self.vocab: Optional[VocabCache] = None

    def _tokenize(self, docs: Iterable[str]) -> List[List[str]]:
        return [self.tokenizer_factory.create(d).get_tokens() for d in docs]

    def fit(self, documents: Sequence[str]) -> "BagOfWordsVectorizer":
        self.vocab = VocabConstructor(
            self.min_word_frequency, self.stop_words).build_vocab(
                self._tokenize(documents))
        return self

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        assert self.vocab is not None, "call fit() first"
        out = np.zeros((len(documents), len(self.vocab)), dtype=np.float32)
        for r, toks in enumerate(self._tokenize(documents)):
            for t in toks:
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[r, i] += 1.0
        return out

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        return self.fit(documents).transform(documents)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf with idf = log(N / df) (ref: TfidfVectorizer.java)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._idf: Optional[np.ndarray] = None

    def fit(self, documents: Sequence[str]) -> "TfidfVectorizer":
        super().fit(documents)
        df = np.zeros(len(self.vocab), dtype=np.float64)
        for toks in self._tokenize(documents):
            for i in {self.vocab.index_of(t) for t in toks}:
                if i >= 0:
                    df[i] += 1.0
        n = max(1, len(documents))
        self._idf = np.log(n / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        counts = super().transform(documents)
        totals = np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return (counts / totals) * self._idf[None, :]
