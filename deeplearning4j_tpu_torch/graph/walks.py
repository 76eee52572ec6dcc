"""Random walk generation (the JAX package's ``graph/walks.py``: host
numpy, draw for draw the same walks from the same seed).

Ref: deeplearning4j-graph/.../iterator/RandomWalkIterator.java (uniform
next-hop, NoEdgeHandling SELF_LOOP_ON_DISCONNECTED / EXCEPTION_ON_DISCONNECTED)
and WeightedRandomWalkIterator.java (weight-proportional next-hop).

Walks are generated *batched* on the host with numpy (all walkers
advance one step per vectorized draw) instead of one walk at a time; the
output feeds the batched skip-gram trainer.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


class NoEdges(Exception):
    """Raised for a disconnected vertex under 'exception' handling (ref:
    NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)."""


def _build_csr(graph: Graph, weighted: bool):
    offsets, neigh, wgt = graph.adjacency_arrays()
    cumw = None
    if weighted:
        # Globally increasing cumulative weights: segment v's cumsum is
        # normalized to (0, 1] then shifted by +v, so one vectorized
        # searchsorted(cumw, u + v) inverts every vertex's CDF at once.
        cumw = wgt.astype(np.float64)
        for v in range(graph.num_vertices()):
            lo, hi = offsets[v], offsets[v + 1]
            if hi > lo:
                c = np.cumsum(wgt[lo:hi])
                if c[-1] <= 0:
                    # all-zero weights: uniform CDF, never NaN (a NaN
                    # segment would corrupt the global searchsorted for
                    # every later vertex)
                    c = np.arange(1, hi - lo + 1, dtype=np.float64)
                    c /= c[-1]
                else:
                    c = c / c[-1]
                cumw[lo:hi] = c + v
    return offsets, neigh, wgt, cumw


def _batched_walks(csr, walk_length: int, starts: np.ndarray,
                   rng: np.random.Generator, weighted: bool,
                   no_edge_handling: str) -> np.ndarray:
    offsets, neigh, wgt, cumw = csr
    degrees = (offsets[1:] - offsets[:-1])
    walks = np.zeros((len(starts), walk_length), dtype=np.int64)
    walks[:, 0] = starts
    cur = starts.copy()
    for step in range(1, walk_length):
        deg = degrees[cur]
        connected = deg > 0
        if no_edge_handling == "exception" and not connected.all():
            # ref: NoEdgeHandling.EXCEPTION_ON_DISCONNECTED throws for any
            # visited disconnected vertex, not just the start
            raise NoEdges("walk reached a vertex with no outgoing edges")
        nxt = cur.copy()  # self-loop for disconnected vertices
        if connected.any():
            c = cur[connected]
            if weighted:
                u = rng.random(len(c))
                # side='right' so u=0 lands past segment c-1's terminal
                # value (exactly c); clamp into [offsets[c], offsets[c+1])
                pick = np.searchsorted(cumw, u + c, side="right")
                pick = np.clip(pick, offsets[c], offsets[c + 1] - 1)
                nxt[connected] = neigh[pick]
            else:
                off = rng.integers(0, deg[connected])
                nxt[connected] = neigh[offsets[c] + off]
        walks[:, step] = nxt
        cur = nxt
    return walks


class RandomWalkIterator:
    """Yields one uniform random walk (list of vertex ids) per start
    vertex, all vertices once per epoch in shuffled order."""

    weighted = False

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 no_edge_handling: str = "self_loop"):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self._epoch = 0
        # the graph is fixed for this iterator's lifetime: build the CSR
        # adjacency (and weighted cumsums) once, not per walks() call
        self._csr = _build_csr(graph, self.weighted)

    def walks(self, batch: Optional[np.ndarray] = None) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        starts = (rng.permutation(self.graph.num_vertices())
                  if batch is None else batch)
        return _batched_walks(self._csr, self.walk_length, starts, rng,
                              self.weighted, self.no_edge_handling)

    def __iter__(self) -> Iterator[List[int]]:
        for row in self.walks():
            yield list(row)


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Next hop chosen proportionally to edge weight (ref:
    WeightedRandomWalkIterator.java)."""

    weighted = True
