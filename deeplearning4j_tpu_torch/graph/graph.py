"""In-memory directed/undirected graph with optional edge weights (the
JAX package's ``graph/graph.py``: host Python and numpy).

Ref: deeplearning4j-graph/.../graph/Graph.java (adjacency-list graph over
Vertex<V> with typed values), api/Edge.java, api/Vertex.java.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


@dataclass
class Vertex(Generic[T]):
    idx: int
    value: Optional[T] = None


@dataclass
class Edge:
    frm: int
    to: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """Adjacency-list graph. Vertices are dense ints [0, n). Undirected
    edges are stored in both adjacency lists (ref: Graph.java addEdge)."""

    def __init__(self, num_vertices: int,
                 values: Optional[Sequence[Any]] = None):
        self._vertices = [
            Vertex(i, values[i] if values is not None and len(values) > i
                   else None)
            for i in range(num_vertices)]
        self._adj: List[List[Tuple[int, float]]] = [
            [] for _ in range(num_vertices)]

    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def add_edge(self, frm: int, to: int, weight: float = 1.0,
                 directed: bool = False) -> None:
        self._adj[frm].append((to, weight))
        if not directed and frm != to:
            self._adj[to].append((frm, weight))

    def get_connected_vertices(self, idx: int) -> List[int]:
        return [t for t, _ in self._adj[idx]]

    def get_connected_vertex_weights(self, idx: int) -> List[Tuple[int, float]]:
        return list(self._adj[idx])

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def adjacency_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR-ish (offsets, neighbors, weights) for vectorized walks."""
        offsets = np.zeros(self.num_vertices() + 1, dtype=np.int64)
        for i, adj in enumerate(self._adj):
            offsets[i + 1] = offsets[i] + len(adj)
        neigh = np.zeros(offsets[-1], dtype=np.int64)
        wgt = np.zeros(offsets[-1], dtype=np.float64)
        for i, adj in enumerate(self._adj):
            for j, (t, w) in enumerate(adj):
                neigh[offsets[i] + j] = t
                wgt[offsets[i] + j] = w
        return offsets, neigh, wgt
