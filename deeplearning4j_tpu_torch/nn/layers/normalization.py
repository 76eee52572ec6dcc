"""Normalization layers (the JAX package's ``nn/layers/normalization.py``):
batch norm, DL4J's local response normalization and layer norm.

Batch norm's running statistics are layer *state*, returned anew by
``apply`` and threaded through the container, as in the JAX package; they
are f32 whatever the net's dtype.

A data-parallel step over several ranks (``parallel.ParallelTrainer``)
runs its loss under ``netcommon.global_batch_stats``: the net's container
then hands each training batch norm the sum over the ranks (the mesh's
differentiable all-reduce, ``batch_sum``), and the layer takes its
statistics over the whole global batch, as the JAX package's one SPMD
step does. The sum belongs to the net, not to the module: the layer
holds no process group, and a net built afresh (an elastic survivor's)
never sees another mesh's sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, State, register_layer,
)


@register_layer
@dataclass
class BatchNormalization(BaseLayerConf):
    """Batch norm over the channel / feature axis (the last one). In
    training (``is_minibatch``) it normalizes with the batch's mean and
    *population* variance and returns the running state ``decay * old +
    (1 - decay) * batch``; otherwise with the running state. Statistics
    are taken in at least f32 and the output is cast back to the input's
    dtype. With ``lock_gamma_beta`` it holds no params and scales by the
    constants ``gamma`` and ``beta``.

    The normalization is ``torch.native_batch_norm`` over a channels-first
    view (one fused pass; it also returns the batch mean and 1 /
    sqrt(var + eps), from which the new state is computed): PyTorch's
    running-buffer update would use the unbiased variance, in place.
    Given ``batch_sum`` (the sum over the ranks, differentiable) the
    training statistics are the global batch's: ``E[x]`` and ``E[x^2] -
    E[x]^2`` over the summed counts."""
    decay: float = 0.9
    eps: float = 1e-5
    is_minibatch: bool = True
    lock_gamma_beta: bool = False
    gamma: float = 1.0
    beta: float = 0.0
    # filled by builder:
    n_features: int = 0

    #: the containers hand ``apply`` the net's ``batch_sum``
    takes_batch_sum = True

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()
        self.n_features = (in_type.channels if in_type.kind == "cnn"
                           else in_type.flat_size())

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return [] if self.lock_gamma_beta else ["gamma", "beta"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_features,), self.gamma,
                                    dtype=dtype),
                "beta": torch.full((self.n_features,), self.beta,
                                   dtype=dtype)}

    def init_state(self) -> State:
        return {"mean": torch.zeros((self.n_features,)),
                "var": torch.ones((self.n_features,))}

    def apply(self, params, x, *, state, train=False, rng=None, mask=None,
              batch_sum=None):
        acc = torch.promote_types(x.dtype, torch.float32)
        if self.lock_gamma_beta:
            gamma = torch.full((self.n_features,), self.gamma, dtype=acc,
                               device=x.device)
            beta = torch.full_like(gamma, self.beta)
        else:
            gamma, beta = params["gamma"].to(acc), params["beta"].to(acc)
        xc = x.movedim(-1, 1)   # a view: channels first, as torch wants
        if train and self.is_minibatch and batch_sum is not None:
            out, mean, var = self._global_batch_norm(x, gamma, beta, acc,
                                                     batch_sum)
            new_state = {
                "mean": self.decay * state["mean"]
                + (1 - self.decay) * mean.detach(),
                "var": self.decay * state["var"]
                + (1 - self.decay) * var.detach(),
            }
            return out, new_state
        if train and self.is_minibatch:
            out, mean, invstd = torch.native_batch_norm(
                xc, gamma, beta, None, None, True, 0.0, self.eps)
            var = invstd.detach() ** -2 - self.eps
            new_state = {
                "mean": self.decay * state["mean"]
                + (1 - self.decay) * mean.detach(),
                "var": self.decay * state["var"] + (1 - self.decay) * var,
            }
        else:
            out, _, _ = torch.native_batch_norm(
                xc, gamma, beta, state["mean"], state["var"], False, 0.0,
                self.eps)
            new_state = state
        return out.movedim(1, -1), new_state

    def _global_batch_norm(self, x, gamma, beta, acc, batch_sum):
        """(output, global mean, global population variance): one sum over
        the ranks of [sum, sum of squares, count] per channel."""
        xs = x.to(acc)
        rows = tuple(range(x.ndim - 1))
        C = x.shape[-1]
        count = torch.full((1,), float(xs.numel() // C), dtype=acc,
                           device=x.device)
        tot = batch_sum(torch.cat([xs.sum(rows), (xs * xs).sum(rows),
                                    count]))
        n = tot[2 * C]
        mean = tot[:C] / n
        var = (tot[C:2 * C] / n - mean * mean).clamp_min(0.0)
        out = (xs - mean) * torch.rsqrt(var + self.eps) * gamma + beta
        return out.to(x.dtype), mean, var


@register_layer
@dataclass
class LocalResponseNormalization(BaseLayerConf):
    """Cross-channel LRN, DL4J's formula: ``x / (k + alpha * sum x^2) **
    beta``, the sum over a window of ``n`` channels centred on each (zeros
    past the edges). ``alpha`` is not divided by ``n``, so this is not
    ``F.local_response_norm`` with the same arguments."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        half = int(self.n // 2)
        sq = F.pad(x * x, (half, half))
        summed = sq.unfold(-1, int(self.n), 1).sum(-1)
        return x / (self.k + self.alpha * summed) ** self.beta, state


@register_layer
@dataclass
class LayerNormalization(BaseLayerConf):
    """Layer normalization over the feature (last) axis, statistics in at
    least f32. The variance is the population variance (``jnp.var``), and
    ``eps`` sits inside the reciprocal square root."""
    eps: float = 1e-5
    # filled by builder:
    n_features: int = 0

    sequence_local = True

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()
        self.n_features = (in_type.channels if in_type.kind == "cnn"
                           else in_type.flat_size())

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return ["gamma", "beta"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {"gamma": torch.ones((self.n_features,), dtype=dtype),
                "beta": torch.zeros((self.n_features,), dtype=dtype)}

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        in_dtype = x.dtype
        xs = x.to(torch.promote_types(in_dtype, torch.float32))
        mean = xs.mean(dim=-1, keepdim=True)
        var = xs.var(dim=-1, keepdim=True, unbiased=False)
        xhat = (xs - mean) * torch.rsqrt(var + self.eps)
        out = params["gamma"] * xhat + params["beta"]
        return out.to(in_dtype), state
