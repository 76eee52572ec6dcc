"""Activation functions: the JAX package's ``ops/activations.py`` table in
PyTorch, under the same names.

Two entries need care to match ``jax.nn``: ``gelu`` is the tanh
approximation (``jax.nn.gelu`` defaults to ``approximate=True``), and
``softplus`` is ``log(1 + exp(x))`` computed stably.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def identity(x: Tensor) -> Tensor:
    return x


def sigmoid(x: Tensor) -> Tensor:
    return torch.sigmoid(x)


def hardsigmoid(x: Tensor) -> Tensor:
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh_(x: Tensor) -> Tensor:
    return torch.tanh(x)


def hardtanh(x: Tensor) -> Tensor:
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x: Tensor) -> Tensor:
    # 1.7159 * tanh(2x/3) approximation via rational function, as in ND4J
    ax = torch.abs(x)
    a = 1.0 + ax + 0.58576695 * ax * ax + 0.11442251 * ax * ax * ax
    return 1.7159 * torch.sign(x) * (1.0 - 1.0 / a)


def rectifiedtanh(x: Tensor) -> Tensor:
    return torch.clamp(torch.tanh(x), min=0.0)


def relu(x: Tensor) -> Tensor:
    return torch.relu(x)


def relu6(x: Tensor) -> Tensor:
    return torch.clamp(x, 0.0, 6.0)


def leakyrelu(x: Tensor, alpha: float = 0.01) -> Tensor:
    return F.leaky_relu(x, negative_slope=alpha)


def elu(x: Tensor) -> Tensor:
    return F.elu(x)


def selu(x: Tensor) -> Tensor:
    return F.selu(x)


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def softmax(x: Tensor) -> Tensor:
    return torch.softmax(x, dim=-1)


def logsoftmax(x: Tensor) -> Tensor:
    return torch.log_softmax(x, dim=-1)


def softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x: Tensor) -> Tensor:
    return x / (1.0 + torch.abs(x))


def cube(x: Tensor) -> Tensor:
    return x * x * x


def swish(x: Tensor) -> Tensor:
    return F.silu(x)


ACTIVATIONS: Dict[str, Callable[[Tensor], Tensor]] = {
    "identity": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh_,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "swish": swish,
}


def get_activation(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; available: {sorted(ACTIVATIONS)}"
        ) from None
