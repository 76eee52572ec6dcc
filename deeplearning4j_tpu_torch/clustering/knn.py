"""Nearest-neighbor search (the JAX package's ``clustering/knn.py``):
VPTree (a brute-force product on the device) + KDTree (a host-side
spatial tree).

Ref: deeplearning4j-core/.../clustering/vptree/VPTree.java and
kdtree/KDTree.java.

Two deliberately different designs:
- ``VPTree``: one [Q, N] distance matrix from a matmul, then each row
  sorted with a stable sort and its first k taken: the k nearest in
  ascending distance, the lower index first among equal distances (the
  order ``jax.lax.top_k`` gives; ``torch.topk`` promises none). The
  [Q, N] matrix must fit in device memory (Q·N·4 bytes in float32, and
  the sort's values and int64 indices beside it: chunk Q for larger
  corpora).
- ``KDTree``: a real k-d tree on the host (median build, pruned
  branch-and-bound search with an explicit stack, incremental insert)
  for low-dimensional lookups where tree pruning beats the matmul
  (d <~ 20, huge N, tiny Q). Host numpy, as in the JAX package.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.distance import (cosine_dist,
                                                          pairwise_sq_dist)
from deeplearning4j_tpu_torch.device import resolve_device


def _topk_neighbors(q, pts, k: int, cosine: bool = False):
    """(distances [Q, k], indices [Q, k]) of each query's k nearest
    points: Euclidean distances (the square root of the clamped squared
    ones) or cosine distances."""
    dist = cosine_dist(q, pts) if cosine else pairwise_sq_dist(q, pts)
    d, idx = torch.sort(dist, dim=1, stable=True)
    d, idx = d[:, :k], idx[:, :k]
    return (d.sqrt() if not cosine else d), idx


class VPTree:
    """search(target, k) -> (indices, distances), Euclidean or cosine.
    The items go onto the device once; ``device=None`` is the CUDA card
    (raises without one), ``device="cpu"`` the CPU."""

    def __init__(self, items: np.ndarray, distance: str = "euclidean",
                 device=None):
        self.items = np.asarray(items, dtype=np.float32)
        self.distance = distance.lower()
        if self.distance not in ("euclidean", "cosine"):
            raise ValueError(f"Unknown distance {distance!r}")
        self.device = resolve_device(device)
        self._pts = torch.tensor(self.items, device=self.device)

    def search(self, target: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(target, dtype=np.float32))
        d, idx = _topk_neighbors(torch.as_tensor(q, device=self.device),
                                 self._pts, min(k, len(self.items)),
                                 self.distance == "cosine")
        d, idx = d.cpu().numpy(), idx.cpu().numpy()
        if np.asarray(target).ndim == 1:
            return idx[0], d[0]
        return idx, d


class KDTree:
    """k-d tree with median build, branch-and-bound search, and insert
    (ref: clustering/kdtree/KDTree.java — Euclidean only, like the
    reference's HyperRect pruning)."""

    __slots__ = ("points", "_axis", "_left", "_right", "_root", "_dims")

    def __init__(self, items: Optional[np.ndarray] = None,
                 dims: Optional[int] = None):
        if items is None and dims is None:
            raise ValueError("pass initial items or dims")
        self.points: List[np.ndarray] = []
        self._axis: List[int] = []
        self._left: List[int] = []
        self._right: List[int] = []
        self._root = -1
        if items is not None:
            items = np.asarray(items, dtype=np.float32)
            self._dims = items.shape[1]
            self.points = [items[i] for i in range(len(items))]
            self._axis = [0] * len(items)
            self._left = [-1] * len(items)
            self._right = [-1] * len(items)
            self._root = self._build(list(range(len(items))), 0)
        else:
            self._dims = int(dims)

    def __len__(self) -> int:
        return len(self.points)

    @property
    def items(self) -> np.ndarray:
        return np.stack(self.points) if self.points else \
            np.zeros((0, self._dims), np.float32)

    def _build(self, idxs: List[int], depth: int) -> int:
        if not idxs:
            return -1
        axis = depth % self._dims
        idxs.sort(key=lambda i: self.points[i][axis])
        mid = len(idxs) // 2
        node = idxs[mid]
        self._axis[node] = axis
        self._left[node] = self._build(idxs[:mid], depth + 1)
        self._right[node] = self._build(idxs[mid + 1:], depth + 1)
        return node

    def insert(self, point: np.ndarray) -> int:
        """(ref: KDTree.insert) — walks to a leaf; no rebalancing."""
        point = np.asarray(point, dtype=np.float32)
        idx = len(self.points)
        self.points.append(point)
        self._axis.append(0)
        self._left.append(-1)
        self._right.append(-1)
        if self._root < 0:
            self._root = idx
            return idx
        node, depth = self._root, 0
        while True:
            axis = depth % self._dims
            side = self._left if point[axis] < self.points[node][axis] \
                else self._right
            if side[node] < 0:
                side[node] = idx
                self._axis[idx] = (depth + 1) % self._dims
                return idx
            node = side[node]
            depth += 1

    def _knn_search(self, root: int, q: np.ndarray, k: int,
                    heap: List[Tuple[float, int]]) -> None:
        # iterative with an explicit stack: insert-built trees can be
        # chains (no rebalancing), so recursion would overflow on
        # sorted-order inserts
        stack = [root]
        while stack:
            node = stack.pop()
            if node < 0:
                continue
            p = self.points[node]
            d2 = float(np.sum((q - p) ** 2))
            if len(heap) < k:
                heapq.heappush(heap, (-d2, node))
            elif d2 < -heap[0][0]:
                heapq.heapreplace(heap, (-d2, node))
            axis = self._axis[node]
            diff = float(q[axis] - p[axis])
            near, far = (self._left[node], self._right[node]) if diff < 0 \
                else (self._right[node], self._left[node])
            # prune: the far half-space can only help if the splitting
            # plane is closer than the current k-th best. Pushed FIRST so
            # the near side is explored first (tightens the bound before
            # far is re-checked at pop — conservative: the check also
            # reruns below via the heap state at pop time)
            if len(heap) < k or diff * diff < -heap[0][0]:
                stack.append(far)
            stack.append(near)

    def search(self, target: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, distances) of the k nearest, sorted ascending."""
        q = np.asarray(target, dtype=np.float32)
        if q.ndim != 1:
            raise ValueError("KDTree.search takes a single query point; "
                             "use VPTree for batched queries")
        heap: List[Tuple[float, int]] = []
        self._knn_search(self._root, q, min(k, len(self.points)), heap)
        out = sorted(((-negd, i) for negd, i in heap))
        idx = np.array([i for _, i in out], dtype=np.int64)
        dist = np.sqrt(np.array([d for d, _ in out], dtype=np.float32))
        return idx, dist

    def nn(self, target: np.ndarray) -> Tuple[int, float]:
        """(ref: KDTree.nn)"""
        idx, d = self.search(target, 1)
        return int(idx[0]), float(d[0])
