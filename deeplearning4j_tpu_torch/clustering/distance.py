"""Pairwise distances for the clustering package (the JAX package's
``clustering/distance.py``).

One matmul form, ||a||^2 - 2 a·b + ||b||^2 clamped at 0 against the
cancellation of near points, serving kmeans, knn and tsne; cosine
distance over rows scaled to unit length (norms floored at 1e-12). Both
run on the tensors' device; the callers keep TF32 off for the products
(``torch.backends.cuda.matmul.allow_tf32``, off by default)."""

from __future__ import annotations

import torch


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] squared Euclidean distances."""
    d = ((a * a).sum(dim=1, keepdim=True)
         - 2.0 * a @ b.T
         + (b * b).sum(dim=1)[None, :])
    return d.clamp(min=0.0)


def cosine_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] cosine distances (1 - cos sim)."""
    an = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp(min=1e-12)
    bn = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp(min=1e-12)
    return 1.0 - an @ bn.T
