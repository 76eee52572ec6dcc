"""Weight initialization: the JAX package's ``nn/weights.py`` schemes,
drawn from an explicit ``torch.Generator``.

The schemes match the JAX package's distributions, not its bits:
``jax.random`` and ``torch.Generator`` give different numbers from the
same seed. Tests that compare the two packages copy weights across
(``deeplearning4j_tpu_torch.convert``) instead of re-drawing them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class Distribution:
    """Serializable distribution spec (ref: nn/conf/distribution/*.java)."""
    kind: str  # "normal" | "uniform" | "binomial" | "gaussian"
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    n_trials: int = 1
    prob: float = 0.5

    @staticmethod
    def normal(mean: float = 0.0, std: float = 1.0) -> "Distribution":
        return Distribution(kind="normal", mean=mean, std=std)

    @staticmethod
    def uniform(lower: float, upper: float) -> "Distribution":
        return Distribution(kind="uniform", lower=lower, upper=upper)

    def sample(self, gen: torch.Generator, shape) -> torch.Tensor:
        if self.kind in ("normal", "gaussian"):
            return self.mean + self.std * _normal(gen, shape)
        if self.kind == "uniform":
            return _uniform(gen, shape, self.lower, self.upper)
        if self.kind == "binomial":
            count = torch.full(tuple(shape), float(self.n_trials))
            return torch.binomial(count, torch.full_like(count, self.prob),
                                  generator=gen)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "mean": self.mean, "std": self.std,
                "lower": self.lower, "upper": self.upper,
                "n_trials": self.n_trials, "prob": self.prob}

    @staticmethod
    def from_dict(d: dict) -> "Distribution":
        return Distribution(**d)


WEIGHT_INITS = (
    "distribution", "zero", "one", "sigmoid_uniform", "uniform",
    "xavier", "xavier_uniform", "xavier_fan_in", "xavier_legacy",
    "relu", "relu_uniform", "lecun_normal", "normal",
)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return lo + (hi - lo) * u


def init_weight(gen: torch.Generator, shape, fan_in: float, fan_out: float,
                scheme: str = "xavier",
                distribution: Optional[Distribution] = None,
                dtype=torch.float32) -> torch.Tensor:
    """Sample an initial weight tensor (ref: nn/weights/WeightInitUtil.java)
    from a CPU generator; the container moves params to its device, so a
    seed gives the same weights on every device."""
    scheme = scheme.lower()
    if scheme == "distribution":
        if distribution is None:
            raise ValueError(
                "weight_init='distribution' requires a Distribution")
        return distribution.sample(gen, shape).to(dtype)
    if scheme == "zero":
        return torch.zeros(tuple(shape), dtype=dtype)
    if scheme == "one":
        return torch.ones(tuple(shape), dtype=dtype)
    uniform_bound = {
        "uniform": lambda: 1.0 / math.sqrt(fan_in),
        "sigmoid_uniform": lambda: 4.0 * math.sqrt(6.0 / (fan_in + fan_out)),
        "xavier_uniform": lambda: math.sqrt(6.0 / (fan_in + fan_out)),
        "relu_uniform": lambda: math.sqrt(6.0 / fan_in),
    }
    if scheme in uniform_bound:
        a = uniform_bound[scheme]()
        return _uniform(gen, shape, -a, a).to(dtype)
    normal_std = {
        "xavier": lambda: math.sqrt(2.0 / (fan_in + fan_out)),
        "xavier_fan_in": lambda: math.sqrt(1.0 / fan_in),
        "xavier_legacy": lambda: math.sqrt(1.0 / (fan_in + fan_out)),
        "relu": lambda: math.sqrt(2.0 / fan_in),
        "lecun_normal": lambda: math.sqrt(1.0 / fan_in),
        "normal": lambda: 1.0 / math.sqrt(fan_in),
    }
    if scheme in normal_std:
        return (normal_std[scheme]() * _normal(gen, shape)).to(dtype)
    raise ValueError(
        f"Unknown weight init {scheme!r}; available: {WEIGHT_INITS}")
