"""DeepWalk: random walks + hierarchical-softmax skip-gram over vertices
(the JAX package's ``graph/deepwalk.py``).

Ref: deeplearning4j-graph/.../models/deepwalk/DeepWalk.java:95 (fit spreads
walk iterators over threads, per-pair GraphHuffman HS updates),
GraphHuffman.java (Huffman tree over vertex degrees, bit-packed codes),
InMemoryGraphLookupTable.java (vertex + inner-node vectors).

Walks are generated batched on the host (walks.py), converted to
(center, context) index pairs, and trained with the same batched HS step
as Word2Vec (``nlp.sequencevectors._hs_step``) on the trainer's device:
one code path for word and vertex embeddings. The step updates its
tables in place, so ``fit`` copies ``vertex_vectors`` onto the device
(``torch.tensor``: on the CPU ``torch.as_tensor`` would share the host
array, and the steps would write into it mid-fit).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walks import (RandomWalkIterator,
                                                  WeightedRandomWalkIterator)
from deeplearning4j_tpu_torch.nlp.sequencevectors import (_hs_step,
                                                          _skipgram_pairs)
from deeplearning4j_tpu_torch.nlp.vocab import (VocabCache, VocabWord,
                                                build_huffman, huffman_arrays)


class GraphHuffman:
    """Huffman codes over vertex degree (ref: GraphHuffman.java — the
    'frequency' of a vertex is its degree). Thin adapter onto the shared
    Huffman coding so codes/points layout matches the NLP trainer."""

    def __init__(self, graph: Graph):
        cache = VocabCache()
        for v in range(graph.num_vertices()):
            cache.add(VocabWord(str(v), max(1, graph.get_vertex_degree(v))))
        build_huffman(cache)
        self._set_cache(cache)

    @classmethod
    def from_cache(cls, cache: VocabCache) -> "GraphHuffman":
        """The codes of a vertex cache built already (one word a vertex,
        named by its id, with its codes and points)."""
        gh = cls.__new__(cls)
        gh._set_cache(cache)
        return gh

    def _set_cache(self, cache: VocabCache) -> None:
        self.cache = cache
        # the vertex -> cache row map (insertion order: the identity)
        self._row = {int(w.word): w.index for w in cache.vocab_words()}

    def row_of(self, vertex: int) -> int:
        return self._row[vertex]

    def codes_points_mask(self):
        codes, points, mask = huffman_arrays(self.cache)
        return codes, points, mask

    def get_code_length(self, vertex: int) -> int:
        return len(self.cache.vocab_words()[self._row[vertex]].codes)

    def get_code(self, vertex: int) -> List[int]:
        return list(self.cache.vocab_words()[self._row[vertex]].codes)

    def get_path_inner_nodes(self, vertex: int) -> List[int]:
        return list(self.cache.vocab_words()[self._row[vertex]].points)


class DeepWalk:
    """The reference DeepWalk's options (vectorSize, windowSize,
    learningRate); fit(graph, walkLength). ``device=None`` trains on the
    CUDA card and raises without one; ``device="cpu"`` on the CPU."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.01, epochs: int = 1,
                 walks_per_vertex: int = 1, batch_size: int = 512,
                 seed: int = 123, weighted_walks: bool = False, device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.walks_per_vertex = walks_per_vertex
        self.batch_size = batch_size
        self.seed = seed
        self.weighted_walks = weighted_walks
        self.device = resolve_device(device)
        self.huffman: Optional[GraphHuffman] = None
        self.vertex_vectors: Optional[np.ndarray] = None
        self._graph: Optional[Graph] = None

    def initialize(self, graph: Graph) -> None:
        self._graph = graph
        self.huffman = GraphHuffman(graph)
        V, D = graph.num_vertices(), self.vector_size
        rng = np.random.default_rng(self.seed)
        self.vertex_vectors = ((rng.random((V, D)) - 0.5) / D).astype(
            np.float32)
        self._syn1 = np.zeros((V, D), dtype=np.float32)

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def fit(self, graph: Optional[Graph] = None,
            walk_length: int = 40) -> "DeepWalk":
        if graph is not None and self._graph is not graph:
            self.initialize(graph)
        g = self._graph
        if g is None:
            raise ValueError("call initialize(graph) or fit(graph)")
        it_cls = (WeightedRandomWalkIterator if self.weighted_walks
                  else RandomWalkIterator)
        walker = it_cls(g, walk_length, seed=self.seed)
        codes, points, mask = self.huffman.codes_points_mask()
        rng = np.random.default_rng(self.seed + 1)
        # rows in syn0 are ordered by huffman cache rows; map walks there
        row_of = np.array([self.huffman.row_of(v)
                           for v in range(g.num_vertices())], dtype=np.int64)
        syn0 = torch.tensor(self.vertex_vectors, device=self.device)
        syn1 = torch.tensor(self._syn1, device=self.device)
        for epoch in range(self.epochs):
            lr = self.learning_rate * (1 - epoch / max(1, self.epochs))
            lr = max(lr, 1e-4)
            for _ in range(self.walks_per_vertex):
                walks = row_of[walker.walks()]  # [V, L] in huffman rows
                cs, os_ = _skipgram_pairs(list(walks), self.window_size, rng)
                order = rng.permutation(len(cs))
                for s in range(0, len(order), self.batch_size):
                    sel = order[s:s + self.batch_size]
                    syn0, syn1 = _hs_step(
                        syn0, syn1, self._put(cs[sel]),
                        self._put(points[os_[sel]]),
                        self._put(codes[os_[sel]]),
                        self._put(mask[os_[sel]]), lr)
        self.vertex_vectors = syn0.cpu().numpy()
        self._syn1 = syn1.cpu().numpy()
        return self

    # -- queries ------------------------------------------------------
    def get_vertex_vector(self, vertex: int) -> np.ndarray:
        return self.vertex_vectors[self.huffman.row_of(vertex)]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.get_vertex_vector(a), self.get_vertex_vector(b)
        denom = (np.linalg.norm(va) * np.linalg.norm(vb)) or 1e-12
        return float(np.dot(va, vb) / denom)

    def verticesNearest(self, vertex: int, top_n: int = 5) -> List[int]:
        v = self.get_vertex_vector(vertex)
        sims = np.array([self.similarity(vertex, u)
                         for u in range(self._graph.num_vertices())])
        sims[vertex] = -np.inf
        return list(np.argsort(-sims)[:top_n])
