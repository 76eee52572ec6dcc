"""Base layer contract + registry (the JAX package's ``nn/layers/base.py``).

A layer is a dataclass of hyperparameters with plain functions on tensors:

- ``set_n_in`` / ``infer_output_type`` — shape inference at build time;
- ``init_params(gen, dtype)`` — a dict of named tensors drawn from a CPU
  ``torch.Generator``, keyed and ordered by ``param_order()`` exactly as
  in the JAX package, so weights carry across by name;
- ``apply(params, x, *, state, mask)`` — the inference forward, returning
  ``(out, state)``.

Layouts are the JAX package's: a weight ``W`` is ``[in, out]`` and a
layer computes ``x @ W``. Training (dropout, regularization, the loss
heads' ``compute_loss``) is not ported yet; the hyperparameters that drive
it are kept on the conf so the configs read the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import Distribution, init_weight

Tensor = torch.Tensor
Params = Dict[str, Tensor]
State = Dict[str, Tensor]

LAYER_REGISTRY: Dict[str, Type["BaseLayerConf"]] = {}


def register_layer(cls):
    """Class decorator: registers the layer under its type tag."""
    LAYER_REGISTRY[cls.type_tag()] = cls
    return cls


@dataclass
class BaseLayerConf:
    """Common hyperparameters every layer inherits from the global builder
    unless overridden per layer."""

    name: Optional[str] = None
    activation: Optional[str] = None          # None -> inherit from global
    weight_init: Optional[str] = None
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None           # DL4J semantics: *retain* prob
    learning_rate: Optional[float] = None
    updater: Optional[str] = None
    frozen: bool = False
    # filled by the builder:
    n_in: Optional[int] = None

    @classmethod
    def type_tag(cls) -> str:
        return cls.__name__

    def apply_global_defaults(self, g: "GlobalConf") -> None:
        """Fill inherited fields from the global conf (ref:
        Builder.layer())."""
        for f in ("activation", "weight_init", "dist", "bias_init", "l1",
                  "l2", "l1_bias", "l2_bias", "dropout"):
            if getattr(self, f) is None:
                setattr(self, f, getattr(g, f))

    def propagate_mask(self, mask):
        """The time mask downstream layers see after this layer."""
        return mask

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator,
                    dtype=torch.float32) -> Params:
        return {}

    def init_state(self) -> State:
        return {}

    def param_order(self) -> List[str]:
        """Flat-buffer ordering contract (ref: nn/params/*ParamInitializer)."""
        return ["W", "b"]

    def apply(self, params: Params, x: Tensor, *, state: State,
              mask: Optional[Tensor] = None) -> Tuple[Tensor, State]:
        raise NotImplementedError

    def _init_w(self, gen, shape, fan_in, fan_out, dtype):
        return init_weight(gen, shape, fan_in, fan_out,
                           scheme=self.weight_init or "xavier",
                           distribution=self.dist, dtype=dtype)

    def _init_b(self, shape, dtype):
        return torch.full(tuple(shape), float(self.bias_init or 0.0),
                          dtype=dtype)

    def has_params(self) -> bool:
        return bool(self.param_order())


@dataclass
class GlobalConf:
    """Global hyperparameters from NeuralNetConfiguration.Builder that
    layers inherit."""
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[Distribution] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: float = 0.0
