"""node2vec: biased second-order random walks + skip-gram negative sampling
(the JAX package's ``graph/node2vec.py``).

Ref: the reference ships node2vec as part of its NLP/graph lineage
(deeplearning4j-nlp `models/node2vec` appears in later snapshots; this
snapshot's DeepWalk — deeplearning4j-graph/.../models/deepwalk/DeepWalk.java
— is the 1st-order special case). Grover & Leskovec (2016) semantics:
return parameter ``p`` and in-out parameter ``q`` bias each hop by
1/p (back to previous), 1 (neighbor of previous), 1/q (outward).

Walk generation is host numpy, every walker advancing one hop per step
with the JAX package's draws in its order (one draw per walker on a
vertex with edges, in walker order), and training is the batched SGNS
step of ``nlp/sequencevectors.py`` on the trainer's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walks import _build_csr
from deeplearning4j_tpu_torch.nlp.sequencevectors import (_sgns_step,
                                                          _skipgram_pairs)


def node2vec_walks(graph: Graph, walk_length: int, p: float = 1.0,
                   q: float = 1.0, starts: Optional[np.ndarray] = None,
                   seed: int = 123) -> np.ndarray:
    """Generate biased walks [n_starts, walk_length]. All walkers advance
    together; per-step the transition weights are reweighted by the
    previous vertex (2nd-order Markov).

    The JAX package draws a walker at a time (``rng.integers`` on the
    first hop, ``rng.random`` then a search of the weights' cumulative
    sum on the later ones); here each hop draws the same numbers in one
    call (numpy's generator gives a vector draw the values of the scalar
    draws in order), and the walkers' neighbourhoods are padded to the
    widest, so each row's ``cumsum`` adds in the same order. A hop holds
    an [n_walkers, max degree] array."""
    offsets, neigh, _, _ = _build_csr(graph, weighted=False)
    rng = np.random.default_rng(seed)
    V = graph.num_vertices()
    if starts is None:
        starts = np.arange(V)
    n = len(starts)
    deg = offsets[1:] - offsets[:-1]
    # "w is a neighbour of u" for every (u, w) at once: a search of the
    # sorted edge keys u * V + w
    keys = np.sort(np.repeat(np.arange(V), deg) * V + neigh)
    walks = np.zeros((n, walk_length), np.int64)
    walks[:, 0] = starts
    cur = np.asarray(starts, np.int64).copy()
    prev = np.full(n, -1)
    for t in range(1, walk_length):
        nxt = cur.copy()  # self-loop on disconnected (walks.py policy)
        live = np.flatnonzero(deg[cur] > 0)
        if len(live) and t == 1:
            # the first hop (no previous vertex): uniform
            v = cur[live]
            nxt[live] = neigh[offsets[v] + rng.integers(0, deg[v])]
        elif len(live):
            v, u, d = cur[live], prev[live], deg[cur[live]]
            slot = np.arange(d.max())
            valid = slot[None, :] < d[:, None]
            nbrs = neigh[np.where(valid, offsets[v][:, None] + slot, 0)]
            key = u[:, None] * V + nbrs
            dist1 = keys[np.minimum(np.searchsorted(keys, key),
                                    len(keys) - 1)] == key
            w = np.where(nbrs == u[:, None], 1.0 / p,
                         np.where(dist1, 1.0, 1.0 / q))
            cdf = np.cumsum(np.where(valid, w, 0.0), axis=1)
            rows = np.arange(len(live))
            target = rng.random(len(live)) * cdf[rows, d - 1]
            # searchsorted(cdf, target, side="right") on each row
            pick = (np.where(valid, cdf, np.inf)
                    <= target[:, None]).sum(axis=1)
            nxt[live] = nbrs[rows, pick]
        prev, cur = cur, nxt
        walks[:, t] = cur
    return walks


class Node2Vec:
    """node2vec embedding trainer (SGNS over biased walks). ``device=None``
    trains on the CUDA card and raises without one; ``device="cpu"`` on
    the CPU."""

    def __init__(self, vector_size: int = 64, window_size: int = 5,
                 p: float = 1.0, q: float = 1.0, walk_length: int = 40,
                 walks_per_vertex: int = 2, epochs: int = 1,
                 learning_rate: float = 0.025, negative: int = 5,
                 batch_size: int = 1024, seed: int = 123, device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.p, self.q = p, q
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.negative = negative
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.vertex_vectors: Optional[np.ndarray] = None

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def fit(self, graph: Graph) -> "Node2Vec":
        V, D = graph.num_vertices(), self.vector_size
        rng = np.random.default_rng(self.seed)
        # copies: the steps update their tables in place
        syn0 = torch.tensor(((rng.random((V, D)) - 0.5) / D).astype(
            np.float32), device=self.device)
        syn1neg = torch.zeros((V, D), dtype=torch.float32, device=self.device)
        for epoch in range(self.epochs):
            lr = max(self.learning_rate * (1 - epoch / max(1, self.epochs)),
                     1e-4)
            for w in range(self.walks_per_vertex):
                walks = node2vec_walks(
                    graph, self.walk_length, self.p, self.q,
                    seed=self.seed + epoch * 1000 + w)
                cs, os_ = _skipgram_pairs(list(walks), self.window_size, rng)
                order = rng.permutation(len(cs))
                for s in range(0, len(order), self.batch_size):
                    sel = order[s:s + self.batch_size]
                    negs = rng.integers(0, V, size=(len(sel),
                                                    max(1, self.negative)))
                    syn0, syn1neg = _sgns_step(
                        syn0, syn1neg, self._put(cs[sel]),
                        self._put(os_[sel]), self._put(negs), lr)
        self.vertex_vectors = syn0.cpu().numpy()
        return self

    def get_vertex_vector(self, vertex: int) -> np.ndarray:
        if self.vertex_vectors is None:
            raise ValueError("fit first")
        return self.vertex_vectors[vertex]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.get_vertex_vector(a), self.get_vertex_vector(b)
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0
