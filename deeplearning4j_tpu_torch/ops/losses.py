"""Loss functions (the JAX package's ``ops/losses.py``, the whole table).

Every loss takes ``(labels, preout, activation_name, mask)`` and returns
the **per-example summed** loss vector of shape ``[batch]``; containers
average over the batch to produce the score (mean per-example loss plus
L1/L2). Softmax + MCXENT and sigmoid + XENT are fused for numerical
stability, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from deeplearning4j_tpu_torch.ops.activations import get_activation

Tensor = torch.Tensor

_EPS = 1e-7


def _apply_act(preout: Tensor, activation: str) -> Tensor:
    return get_activation(activation)(preout)


def promote_loss_dtype(preout: Tensor, labels: Tensor):
    """Losses compute in at least f32 (promote, don't hard-cast, so f64
    stays f64)."""
    dt = torch.promote_types(preout.dtype, torch.float32)
    return preout.to(dt), labels.to(dt)


def _reduce(per_elem: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Sum per-element losses over the feature axes -> [batch]; apply the
    mask ([batch], [batch, 1] or the full shape)."""
    if mask is not None:
        while mask.dim() < per_elem.dim():
            mask = mask[..., None]
        per_elem = per_elem * mask
    if per_elem.dim() == 1:
        return per_elem
    return per_elem.sum(dim=tuple(range(1, per_elem.dim())))


def mse(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    # mean over output features of the squared error
    return _reduce((out - labels) ** 2, mask) / labels.shape[-1]


def l2(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    return _reduce((out - labels) ** 2, mask)


def mae(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    return _reduce((out - labels).abs(), mask) / labels.shape[-1]


def l1(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    return _reduce((out - labels).abs(), mask)


def mcxent(labels, preout, activation: str, mask=None) -> Tensor:
    """Multi-class cross entropy. Fused when activation == softmax."""
    if activation == "softmax":
        return _reduce(-labels * torch.log_softmax(preout, dim=-1), mask)
    out = _apply_act(preout, activation).clamp(_EPS, 1.0 - _EPS)
    return _reduce(-labels * torch.log(out), mask)


def negativeloglikelihood(labels, preout, activation: str, mask=None):
    return mcxent(labels, preout, activation, mask)


def xent(labels, preout, activation: str, mask=None) -> Tensor:
    """Binary cross entropy. Fused when activation == sigmoid."""
    if activation == "sigmoid":
        # stable: max(z, 0) - z y + log(1 + exp(-|z|))
        z = preout
        per = z.clamp_min(0.0) - z * labels + torch.log1p(torch.exp(-z.abs()))
        return _reduce(per, mask)
    out = _apply_act(preout, activation).clamp(_EPS, 1.0 - _EPS)
    per = -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))
    return _reduce(per, mask)


def _signs(labels):
    """Labels in {-1, +1} or {0, 1} -> +-1."""
    return torch.where(labels > 0, 1.0, -1.0).to(labels.dtype)


def hinge(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    return _reduce((1.0 - _signs(labels) * out).clamp_min(0.0), mask)


def squared_hinge(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    return _reduce((1.0 - _signs(labels) * out).clamp_min(0.0) ** 2, mask)


def kl_divergence(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation).clamp(_EPS, 1.0)
    lab = labels.clamp(_EPS, 1.0)
    return _reduce(lab * (torch.log(lab) - torch.log(out)), mask)


def poisson(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation).clamp_min(_EPS)
    return _reduce(out - labels * torch.log(out), mask)


def cosine_proximity(labels, preout, activation: str, mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    ln = torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
    on = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    cos = (labels * out).sum(dim=-1, keepdim=True) / (ln * on).clamp_min(_EPS)
    return _reduce(-cos, mask)


def mean_squared_logarithmic_error(labels, preout, activation: str,
                                   mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    per = (torch.log1p(out.clamp_min(-1 + _EPS)) - torch.log1p(labels)) ** 2
    return _reduce(per, mask) / labels.shape[-1]


def mean_absolute_percentage_error(labels, preout, activation: str,
                                   mask=None) -> Tensor:
    out = _apply_act(preout, activation)
    denom = torch.where(labels.abs() < _EPS, _EPS, labels)
    per = ((labels - out) / denom).abs() * 100.0
    return _reduce(per, mask) / labels.shape[-1]


LOSSES: Dict[str, Callable] = {
    "mse": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "nll": negativeloglikelihood,
    "xent": xent,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "msle": mean_squared_logarithmic_error,
    "mape": mean_absolute_percentage_error,
}


def get_loss(name: str) -> Callable:
    try:
        return LOSSES[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; available: "
                         f"{sorted(LOSSES)}") from None
