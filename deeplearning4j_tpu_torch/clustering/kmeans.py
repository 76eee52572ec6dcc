"""K-means clustering (the JAX package's ``clustering/kmeans.py``).

Ref: deeplearning4j-core/.../clustering/kmeans/KMeansClustering.java and
cluster/{Cluster,ClusterSet,Point,ClusterUtils}.java. The reference loops
points and clusters in Java threads; here each Lloyd iteration is one
step on the device: an [N, K] distance matrix from a matmul, ``argmin``
(the first of equal minima, as ``jnp.argmin``), and the centroid sums as
the one-hot product ``one_hot.T @ x`` (a matmul, where ``index_add_``
would sum with atomics on CUDA, in an order that changes from run to
run). The k-means++ seeding runs on the host in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.clustering.distance import (cosine_dist,
                                                          pairwise_sq_dist)
from deeplearning4j_tpu_torch.device import resolve_device


@dataclass
class Point:
    idx: int
    array: np.ndarray
    label: Optional[str] = None


@dataclass
class Cluster:
    idx: int
    center: np.ndarray
    points: List[Point] = field(default_factory=list)


@dataclass
class ClusterSet:
    clusters: List[Cluster]

    def get_clusters(self) -> List[Cluster]:
        return self.clusters

    def get_cluster_count(self) -> int:
        return len(self.clusters)

    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])


def _lloyd_step(x, centers, k: int, cosine: bool = False):
    """(new centers, assignments, inertia) of one Lloyd iteration: a
    cluster that no point chose keeps its center."""
    dist = cosine_dist(x, centers) if cosine else pairwise_sq_dist(x, centers)
    assign = torch.argmin(dist, dim=1)
    one_hot = F.one_hot(assign, k).to(x.dtype)              # [N, K]
    counts = one_hot.sum(dim=0)                              # [K]
    sums = one_hot.T @ x                                     # [K, D]
    new_centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp(min=1.0)[:, None],
                              centers)
    inertia = dist.min(dim=1).values.sum()
    return new_centers, assign, inertia


class KMeansClustering:
    """setup(k, maxIterations, distanceFunction) then apply_to(points)
    (ref: KMeansClustering.setup / applyTo). ``device=None`` runs the
    steps on the CUDA card and raises without one; ``device="cpu"`` on
    the CPU."""

    def __init__(self, k: int, max_iterations: int = 100,
                 distance: str = "euclidean", tol: float = 1e-6,
                 seed: int = 123, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.distance = distance.lower()
        if self.distance not in ("euclidean", "cosine"):
            raise ValueError(f"Unknown distance {distance!r}")
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.inertia_: Optional[float] = None
        self.n_iter_: int = 0

    @staticmethod
    def setup(k: int, max_iterations: int = 100,
              distance: str = "euclidean", **kw) -> "KMeansClustering":
        return KMeansClustering(k, max_iterations, distance, **kw)

    def _init_centers(self, x: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        """k-means++ seeding (better than the reference's random pick)."""
        n = len(x)
        centers = [x[rng.integers(n)]]
        # running min squared distance to the nearest chosen center — O(NKD)
        d2 = ((x - centers[0]) ** 2).sum(-1)
        for _ in range(1, self.k):
            total = d2.sum()
            if total <= 1e-12:
                # all remaining points coincide with chosen centers;
                # degenerate but valid — pick uniformly
                idx = rng.integers(n)
            else:
                idx = rng.choice(n, p=d2 / total)
            centers.append(x[idx])
            d2 = np.minimum(d2, ((x - centers[-1]) ** 2).sum(-1))
        return np.stack(centers)

    def _step(self, x, centers):
        return _lloyd_step(x, centers, self.k, self.distance == "cosine")

    def fit(self, x: np.ndarray) -> "KMeansClustering":
        x = np.asarray(x, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        centers = torch.as_tensor(self._init_centers(x, rng),
                                  device=self.device)
        xt = torch.as_tensor(x, device=self.device)
        prev_inertia = np.inf
        for i in range(max(1, self.max_iterations)):
            centers, _, inertia = self._step(xt, centers)
            self.n_iter_ = i + 1
            if abs(prev_inertia - float(inertia)) < self.tol:
                break
            prev_inertia = float(inertia)
        self.cluster_centers_ = centers.cpu().numpy()
        # assignments/inertia must reflect the FINAL centers (the step
        # returns pre-update assignments, which would disagree with
        # predict() whenever the loop exits on max_iterations)
        _, assign, inertia = self._step(xt, centers)
        self.labels_ = assign.cpu().numpy()
        self.inertia_ = float(inertia)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        _, assign, _ = self._step(
            torch.as_tensor(np.asarray(x, np.float32), device=self.device),
            torch.as_tensor(self.cluster_centers_, device=self.device))
        return assign.cpu().numpy()

    def apply_to(self, points: Sequence[Point]) -> ClusterSet:
        x = np.stack([np.asarray(p.array, np.float32).ravel()
                      for p in points])
        self.fit(x)
        clusters = [Cluster(i, self.cluster_centers_[i])
                    for i in range(self.k)]
        for p, a in zip(points, self.labels_):
            clusters[int(a)].points.append(p)
        return ClusterSet(clusters)
