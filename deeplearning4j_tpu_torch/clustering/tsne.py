"""t-SNE for embedding visualization (the JAX package's
``clustering/tsne.py``).

Ref: deeplearning4j-core/.../plot/BarnesHutTsne.java (perplexity binary
search, PCA init, momentum + gains schedule, Barnes-Hut quad-tree
approximation of the repulsive forces; powers the UI's embedding view).

As in the JAX package, the gradient is the exact O(N^2) one: dense
[N, N] tensors and one product on the device, in place of the
reference's CPU tree, for the N (<= ~10k) this is used for (six [N, N]
float32 buffers: ~2.6 GB at N = 10,312). The perplexity search is a
vectorized binary search whose 50 iterations stay on the device (no
host read inside the loop); the optimizer keeps the reference's
momentum switch and gains schedule, and the PCA initialisation runs on
the host in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.distance import pairwise_sq_dist
from deeplearning4j_tpu_torch.device import resolve_device


def _binary_search_perplexity(d2, target_entropy, iters: int = 50):
    """Per-row beta (precision) search so row entropy == log(perplexity).
    d2: [N, N] squared distances with inf on the diagonal; returns the
    row-normalized conditional P."""
    n = d2.shape[0]
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    # the diagonal carries inf distance; exp(-inf)=0 but 0*inf=NaN, so
    # mask it out of the weighted-distance sum explicitly
    d2_fin = torch.where(torch.isinf(d2), torch.zeros_like(d2), d2)
    for _ in range(iters):
        p = torch.exp(-d2 * beta[:, None])
        psum = p.sum(dim=1).clamp(min=1e-12)
        # H = log(sum) + beta * E[d2]
        h = torch.log(psum) + beta * (p * d2_fin).sum(dim=1) / psum
        too_high = h > target_entropy  # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    p = torch.exp(-d2 * beta[:, None])
    return p / p.sum(dim=1, keepdim=True).clamp(min=1e-12)


def _tsne_grad(y, p):
    """Exact t-SNE gradient 4 * sum_j (p_ij - q_ij) q*_ij (y_i - y_j), and
    KL(P || Q). ``(diag(rowsum(pq)) - pq) @ y`` is taken as
    ``rowsum(pq) * y - pq @ y``, without the [N, N] diagonal matrix."""
    d2 = pairwise_sq_dist(y, y)
    num = 1.0 / (1.0 + d2)                   # student-t kernel, [N, N]
    num.fill_diagonal_(0.0)                  # q_ii = 0
    q = num / num.sum().clamp(min=1e-12)
    pq = (p - q) * num                       # [N, N]
    grad = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
    kl = (p * torch.log(p.clamp(min=1e-12) / q.clamp(min=1e-12))).sum()
    return grad, kl


class Tsne:
    """The reference BarnesHutTsne's options (setMaxIter, perplexity,
    theta: ignored, the gradient is exact), then fit(X) -> [N, 2] coords.
    ``device=None`` runs on the CUDA card (raises without one),
    ``device="cpu"`` on the CPU."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 max_iter: int = 500, learning_rate: float = 200.0,
                 early_exaggeration: float = 12.0, exaggeration_iters: int = 100,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 momentum_switch: int = 250, seed: int = 123,
                 use_pca_init: bool = True, theta: float = 0.0, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.seed = seed
        self.use_pca_init = use_pca_init
        self.device = resolve_device(device)
        self.kl_divergence_: Optional[float] = None

    def _p_matrix(self, x: np.ndarray) -> torch.Tensor:
        xt = torch.as_tensor(x, device=self.device)
        d2 = pairwise_sq_dist(xt, xt)
        d2.fill_diagonal_(float("inf"))
        p = _binary_search_perplexity(
            d2, torch.log(torch.tensor(self.perplexity, dtype=torch.float32,
                                       device=self.device)))
        p = (p + p.T) / (2.0 * len(x))       # symmetrize + normalize
        return p.clamp(min=1e-12)

    def fit(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        n = len(x)
        perp = min(self.perplexity, max(2.0, (n - 1) / 3.0))
        if perp != self.perplexity:
            self.perplexity = perp
        p = self._p_matrix(x)
        rng = np.random.default_rng(self.seed)
        if self.use_pca_init and x.shape[1] > self.n_components:
            xc = x - x.mean(axis=0)
            _, _, vt = np.linalg.svd(xc, full_matrices=False)
            y0 = (xc @ vt[:self.n_components].T)
            y0 = y0 / max(np.std(y0[:, 0]), 1e-12) * 1e-4
        else:
            y0 = rng.normal(scale=1e-4, size=(n, self.n_components))
        y = torch.as_tensor(y0.astype(np.float32), device=self.device)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        for it in range(self.max_iter):
            p_eff = (p * self.early_exaggeration
                     if it < self.exaggeration_iters else p)
            grad, _ = _tsne_grad(y, p_eff)
            mom = (self.momentum if it < self.momentum_switch
                   else self.final_momentum)
            # gains schedule from the reference/original implementation
            same_sign = torch.sign(grad) == torch.sign(vel)
            gains = torch.where(same_sign, gains * 0.8, gains + 0.2)
            gains = gains.clamp(min=0.01)
            vel = mom * vel - self.learning_rate * gains * grad
            y = y + vel
            y = y - y.mean(dim=0, keepdim=True)
        # report KL of the FINAL embedding against the true (never the
        # exaggerated) P, so the number is meaningful for any max_iter
        _, kl = _tsne_grad(y, p)
        self.kl_divergence_ = float(kl)
        self.embedding_ = y.cpu().numpy()
        return self.embedding_

    fit_transform = fit
