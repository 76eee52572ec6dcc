"""What the two containers share in training (the JAX package's
``nn/netcommon.py`` and the training-step helpers of its containers): the
lazily read score, the gradient of a loss over a params container, the
refusal of the training settings whose paths are not ported, and the
training hooks that wait for ROADMAP A2."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.builder import TrainingConfig
from deeplearning4j_tpu_torch.nn.updater import PrecisionPolicy, tree_map


def check_trainable(training: TrainingConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, on a training
    setting whose path is not ported."""
    if training.optimization_algo not in ("sgd",
                                          "stochastic_gradient_descent"):
        raise NotImplementedError(
            f"optimization_algo={training.optimization_algo!r}: the "
            "line-search solvers are not ported yet (ROADMAP A2, deferred)")
    if training.remat:
        raise NotImplementedError(
            "remat (gradient checkpointing) is not ported yet "
            "(ROADMAP A2, deferred)")
    if PrecisionPolicy.parse(training.precision,
                             loss_scale=training.loss_scale).mixed:
        raise NotImplementedError(
            f"precision={training.precision!r}: the port trains fp32 only; "
            "mixed precision is ROADMAP A2, deferred")


def value_and_grad(loss_fn: Callable, params) -> Tuple[torch.Tensor, Any,
                                                        Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a params
    container (a dict or list of dicts of tensors): ``loss_fn(leaves)``
    returns ``(loss, aux)``, where ``leaves`` are detached copies of the
    params' tensors that require grad. Returns ``(loss detached, aux,
    grads mirroring params)``; an unused param's gradient is zeros."""
    order = []

    def leaf(t):
        order.append(t.detach().requires_grad_())
        return order[-1]

    leaves = tree_map(leaf, params)
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        flat = iter(torch.autograd.grad(loss, order, allow_unused=True))
    grads = tree_map(lambda t: (lambda g: torch.zeros_like(t) if g is None
                                else g)(next(flat)), leaves)
    return loss.detach(), aux, grads


def detach(tree):
    """A container of tensors (None leaves kept) cut from autograd."""
    return tree_map(lambda t: None if t is None else t.detach(), tree)


class NetCommonMixin:
    """``score_value`` (the last minibatch loss as a float; a device value
    is read, and the device synchronized, on first access only) and the
    training hooks that are not ported yet."""

    _score_raw: Any = float("nan")

    @property
    def score_value(self) -> float:
        if not isinstance(self._score_raw, float):
            self._score_raw = float(self._score_raw)
        return self._score_raw

    @score_value.setter
    def score_value(self, v) -> None:
        self._score_raw = v

    def set_listeners(self, *listeners) -> None:
        raise NotImplementedError(
            "training listeners are not ported yet (ROADMAP A2, deferred)")

    def set_divergence_sentinel(self, sentinel) -> None:
        raise NotImplementedError(
            "the divergence sentinel is not ported yet (ROADMAP A2, "
            "deferred)")


class EvalMixin:
    """``evaluate(iterator)`` for both containers: ``output()`` of each
    batch (with its feature mask, so padded steps do not run as data)
    into one ``Evaluation``, with the label mask. ROC and regression
    evaluation wait for ROADMAP A7."""

    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        evaluation = Evaluation()
        iterator.reset()
        for batch in iterator:
            out = self.output(batch.features, mask=batch.features_mask)
            evaluation.eval(batch.labels, out.float().cpu().numpy(),
                            mask=batch.labels_mask)
        return evaluation
