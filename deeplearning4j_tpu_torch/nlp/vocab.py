"""Vocabulary construction + Huffman coding for hierarchical softmax.

Ref: deeplearning4j-nlp models/word2vec/wordstore/VocabConstructor.java,
models/word2vec/VocabWord.java, models/embeddings/loader (vocab cache),
and the Huffman tree in models/word2vec/Huffman.java (codes/points per
word, max code length 40).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAX_CODE_LENGTH = 40


@dataclass
class VocabWord:
    word: str
    count: float = 1.0
    index: int = -1
    # Hierarchical-softmax metadata (ref: VocabWord.java codes/points).
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)

    def increment(self, by: float = 1.0) -> None:
        self.count += by


class VocabCache:
    """In-memory vocab: word <-> index <-> VocabWord (ref:
    models/word2vec/wordstore/inmemory/InMemoryLookupCache.java)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0.0

    def __contains__(self, word: str) -> bool:
        return word in self._words

    def __len__(self) -> int:
        return len(self._by_index)

    def num_words(self) -> int:
        return len(self._by_index)

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def add(self, vw: VocabWord) -> None:
        vw.index = len(self._by_index)
        self._words[vw.word] = vw
        self._by_index.append(vw)

    def word_at(self, index: int) -> str:
        return self._by_index[index].word

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return 0.0 if vw is None else vw.count


class VocabConstructor:
    """Scans token sequences, counts words, filters by min frequency,
    sorts by descending count, assigns indices, attaches Huffman codes.

    Ref: VocabConstructor.java buildJointVocabulary / SequenceVectors
    buildVocab (SequenceVectors.java:103-110).
    """

    def __init__(self, min_word_frequency: int = 1,
                 stop_words: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words)

    def build_vocab(self, sequences: Iterable[Sequence[str]]) -> VocabCache:
        counts: Dict[str, float] = {}
        total = 0
        for seq in sequences:
            for tok in seq:
                if tok in self.stop_words:
                    continue
                counts[tok] = counts.get(tok, 0.0) + 1.0
                total += 1
        cache = VocabCache()
        # Descending frequency, ties broken lexically for determinism.
        for word in sorted(counts, key=lambda w: (-counts[w], w)):
            if counts[word] >= self.min_word_frequency:
                cache.add(VocabWord(word, counts[word]))
        cache.total_word_count = float(
            sum(vw.count for vw in cache.vocab_words()))
        build_huffman(cache)
        return cache


def build_huffman(cache: VocabCache) -> None:
    """Huffman-code every vocab word in place (ref: Huffman.java:  build
    binary tree over counts; each word gets its root-to-leaf path as
    `codes` (branch bits) and `points` (inner-node ids))."""
    words = cache.vocab_words()
    n = len(words)
    if n == 0:
        return
    # Heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2.
    heap: List[Tuple[float, int, int]] = [
        (w.count, i, i) for i, w in enumerate(words)]
    heapq.heapify(heap)
    parent = np.zeros(2 * n, dtype=np.int64)
    binary = np.zeros(2 * n, dtype=np.int8)
    next_id = n
    while len(heap) > 1:
        c1, _, i1 = heapq.heappop(heap)
        c2, _, i2 = heapq.heappop(heap)
        parent[i1] = parent[i2] = next_id
        binary[i2] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = next_id - 1
    for i, w in enumerate(words):
        codes: List[int] = []
        points: List[int] = []
        node = i
        while node != root:
            codes.append(int(binary[node]))
            node = int(parent[node])
            points.append(node - n)  # inner-node index into syn1
        codes.reverse()
        points.reverse()
        w.codes = codes[:MAX_CODE_LENGTH]
        w.points = points[:MAX_CODE_LENGTH]


def huffman_arrays(cache: VocabCache) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-word codes/points into padded [V, L] arrays + mask for the
    vectorized HS training step."""
    words = cache.vocab_words()
    L = max((len(w.codes) for w in words), default=1) or 1
    V = len(words)
    codes = np.zeros((V, L), dtype=np.float32)
    points = np.zeros((V, L), dtype=np.int32)
    mask = np.zeros((V, L), dtype=np.float32)
    for i, w in enumerate(words):
        k = len(w.codes)
        codes[i, :k] = w.codes
        points[i, :k] = w.points
        mask[i, :k] = 1.0
    return codes, points, mask
