"""Base layer contract + registry (the JAX package's ``nn/layers/base.py``).

A layer is a dataclass of hyperparameters with plain functions on tensors:

- ``set_n_in`` / ``infer_output_type`` — shape inference at build time;
- ``init_params(gen, dtype)`` — a dict of named tensors drawn from a CPU
  ``torch.Generator``, keyed and ordered by ``param_order()`` exactly as
  in the JAX package, so weights carry across by name;
- ``apply(params, x, *, state, train=False, rng=None, mask=None)`` — the
  forward, returning ``(out, state)``; ``train`` turns on input dropout,
  drawn from ``rng`` (a ``torch.Generator`` on the net's device);
- ``regularization()`` — param name -> (l1, l2) for the score's penalty;
- loss heads add ``compute_loss(params, x, labels, *, mask, average)``;
- ``to_dict`` / ``from_dict`` — JSON serde under the class's type tag
  (``layer_from_dict`` resolves it through ``LAYER_REGISTRY``), the same
  dict the JAX package writes.

Layouts are the JAX package's: a weight ``W`` is ``[in, out]`` and a
layer computes ``x @ W``. Autograd replaces the JAX package's ``jax.grad``
over the same pure forward.
"""

from __future__ import annotations

import dataclasses
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

    #: True where ``apply`` takes ``batch_sum``: the sum over the ranks a
    #: training batch norm takes its statistics through, which the
    #: containers hand it from the net (``netcommon.global_batch_stats``)
    takes_batch_sum = False

    #: True where the layer works token by token, so a sequence-parallel
    #: step runs it on this rank's time shard as it is; any other layer
    #: sees the whole sequence there (``parallel/tensor.py``)
    sequence_local = False

    #: True where ``apply`` takes ``seq_shard``: its input is this rank's
    #: time shard of a sequence-parallel step
    takes_seq_shard = False

    @classmethod
    def type_tag(cls) -> str:
        return cls.__name__

    def to_dict(self) -> dict:
        """The JSON dict: ``@type`` and every field that is not None
        (tuples as lists, ``dist`` as its own dict)."""
        d = {"@type": self.type_tag()}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, Distribution):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BaseLayerConf":
        d = dict(d)
        d.pop("@type", None)
        if isinstance(d.get("dist"), dict):
            d["dist"] = Distribution.from_dict(d["dist"])
        # tuples come back from JSON as lists
        for f in dataclasses.fields(cls):
            if f.name in d and isinstance(d[f.name], list):
                hint = str(f.type)
                if "Tuple" in hint or "tuple" in hint:
                    d[f.name] = tuple(d[f.name])
        return cls(**d)

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

    def regularization(self) -> Dict[str, Tuple[float, float]]:
        """param name -> (l1, l2). Weights get l1/l2, biases and norm
        params l1_bias/l2_bias."""
        out = {}
        for p in self.param_order():
            if p in ("b", "beta", "gamma", "mean", "var"):
                out[p] = (self.l1_bias or 0.0, self.l2_bias or 0.0)
            else:
                out[p] = (self.l1 or 0.0, self.l2 or 0.0)
        return out

    def apply(self, params: Params, x: Tensor, *, state: State,
              train: bool = False, rng: Optional[torch.Generator] = None,
              mask: Optional[Tensor] = None) -> Tuple[Tensor, State]:
        raise NotImplementedError

    def _dropout_input(self, x: Tensor, train: bool,
                       rng: Optional[torch.Generator]) -> Tensor:
        """Inverted dropout on the layer *input* while training. The conf
        stores DL4J's *retain* probability: each element is kept with
        that probability and scaled by its inverse. The draw comes from
        ``rng`` on x's device, so a seed repeats it."""
        retain = self.dropout
        if (not train or retain is None or retain <= 0.0 or retain >= 1.0
                or rng is None):
            return x
        keep = torch.rand(x.shape, generator=rng, device=x.device) < retain
        return torch.where(keep, x / retain, 0.0)

    def _init_w(self, gen, shape, fan_in, fan_out, dtype):
        return init_weight(gen, shape, fan_in, fan_out,
                           scheme=self.weight_init or "xavier",
                           distribution=self.dist, dtype=dtype)

    def _init_b(self, shape, dtype):
        return torch.full(tuple(shape), float(self.bias_init or 0.0),
                          dtype=dtype)

    def has_params(self) -> bool:
        return bool(self.param_order())

    def column_parallel_params(self, n_model: int) -> set:
        """The params this layer consumes as this rank's column shard
        under a model axis of ``n_model`` (``parallel/tensor.
        column_linear``); every other sharded param is gathered whole on
        use."""
        return set()


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


def layer_from_dict(d: dict) -> BaseLayerConf:
    """The layer a ``to_dict`` result describes, by its ``@type`` tag."""
    tag = d.get("@type")
    if tag not in LAYER_REGISTRY:
        raise ValueError(f"Unknown layer type tag {tag!r}")
    return LAYER_REGISTRY[tag].from_dict(d)
