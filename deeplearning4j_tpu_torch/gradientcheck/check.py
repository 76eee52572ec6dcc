"""Finite-difference gradient checking (the JAX package's
``gradientcheck/check.py``).

Ref: gradientcheck/GradientCheckUtil.java:75 — centered differences
(f(θ+ε) - f(θ-ε)) / 2ε per parameter vs the analytic gradient, in double
precision, with a smooth-activation whitelist (:47-58) and
maxRelError ≈ 1e-3 / ε ≈ 1e-6 defaults.

Autograd makes the network gradient correct by construction, so the
harness guards the hand-written backward passes (the LSTM's custom
autograd function, masking and loss edge semantics) and the layers' math.
As in the reference, the check runs in float64 on the CPU: the net's
params, layer states and the data are copied there as float64 into a CPU
container built from the same config, whatever device the net lives on
(the card's kernels have no float64 instantiation, so a float64 LSTM
takes the layer's step loop on either device).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _f64(tree):
    return [{k: v.detach().to("cpu", torch.float64).clone()
             for k, v in d.items()} for d in tree]


class GradientCheckUtil:
    SMOOTH_ACTIVATIONS = ("identity", "sigmoid", "tanh", "softmax", "softplus",
                          "softsign", "cube", "elu", "gelu", "rationaltanh")

    @staticmethod
    def check_gradients(net, features, labels, *, epsilon: float = 1e-6,
                        max_rel_error: float = 1e-3,
                        min_abs_error: float = 1e-8,
                        features_mask=None, labels_mask=None,
                        subset: Optional[int] = 128,
                        seed: int = 12345,
                        print_results: bool = False) -> bool:
        """True iff every checked parameter's relative error is within
        tolerance (ref: GradientCheckUtil.checkGradients signature/semantics).

        ``subset``: check at most this many randomly-chosen parameters per
        layer (None = all — the reference checks all; subsetting keeps CI
        fast for bigger nets while still covering every parameter tensor).
        """
        net._check_init()
        cpu = MultiLayerNetwork(net.conf, device="cpu")
        params64, states64 = _f64(net.params), _f64(net.states)

        def t64(a):
            return (None if a is None else
                    torch.as_tensor(np.asarray(a), dtype=torch.float64))
        f, lab = t64(features), t64(labels)
        fm, lm = t64(features_mask), t64(labels_mask)

        def loss(p) -> torch.Tensor:
            # train=True, rng=None => dropout disabled, exactly as the
            # reference disables dropout for gradient checks
            val, _ = cpu._loss_fn(p, states64, f, lab, fm, lm, rng=None,
                                  train=True)
            return val

        leaves = [t.requires_grad_(True) for p in params64 for t in p.values()]
        grads = torch.autograd.grad(loss(params64), leaves, allow_unused=True)
        analytic = iter(np.zeros(tuple(t.shape)) if g is None
                        else g.detach().numpy() for t, g in zip(leaves, grads))
        for t in leaves:
            t.requires_grad_(False)

        rng = np.random.default_rng(seed)
        total_fail = 0
        total_checked = 0
        max_err_seen = 0.0
        with torch.no_grad():
            for li, pdict in enumerate(params64):
                for name, arr in pdict.items():
                    flat = arr.view(-1)
                    n = flat.numel()
                    idxs = (np.arange(n) if subset is None or n <= subset
                            else rng.choice(n, size=subset, replace=False))
                    a_flat = next(analytic).ravel()
                    for i in idxs:
                        orig = float(flat[i])
                        flat[i] = orig + epsilon
                        s_plus = float(loss(params64))
                        flat[i] = orig - epsilon
                        s_minus = float(loss(params64))
                        flat[i] = orig
                        numeric = (s_plus - s_minus) / (2.0 * epsilon)
                        a = float(a_flat[i])
                        denom = max(abs(a), abs(numeric))
                        rel = abs(a - numeric) / denom if denom > 0 else 0.0
                        total_checked += 1
                        max_err_seen = max(max_err_seen, rel)
                        if (rel > max_rel_error
                                and abs(a - numeric) > min_abs_error):
                            total_fail += 1
                            if print_results or total_fail <= 10:
                                logger.warning(
                                    "Gradient check FAIL layer %d param "
                                    "%s[%d]: analytic=%.8g numeric=%.8g "
                                    "rel=%.4g", li, name, i, a, numeric, rel)
        if print_results:
            logger.info("Gradient check: %d/%d failed (max rel err %.3g)",
                        total_fail, total_checked, max_err_seen)
        return total_fail == 0
