"""Network configuration DSL (the JAX package's ``nn/conf/builder.py``, the
subset the GPT decoder and the char-RNN use):

    NeuralNetConfiguration.builder().seed(s).updater("adam", learning_rate=lr)
        .weight_init("xavier").dropout(p).l2(1e-4).lr_policy("step", ...)
        .dtype("float32")
        .graph_builder()            # a DAG (ComputationGraph)
        .list()                     # or a stack (MultiLayerNetwork)

Global hyperparameters are inherited by every layer at ``build()``. The
training settings (updater and learning-rate policy, regularization,
gradient normalization, ``minimize``, the optimization algorithm, the
precision policy, rematerialization, tBPTT) are read by
``nn/updater.py`` and the containers' ``fit_batch``, which refuse the
values whose paths are not ported yet.

``conf.validate()`` / ``conf.memory_report()`` (and ``ListBuilder.validate()``
before ``build()``) run ``analysis/graphcheck`` and ``analysis/memory``.

Serde: ``conf.to_json()`` / ``MultiLayerConfiguration.from_json`` and the
YAML twins write and read the JAX package's documents (the same
``format`` tag, fields and type tags), so a config crosses between the
two packages in either direction. PyYAML is imported only inside
``to_yaml`` / ``from_yaml``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor, auto_preprocessor,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, GlobalConf, layer_from_dict,
)
from deeplearning4j_tpu_torch.nn.weights import Distribution

# Layer-family classification: which input kind a layer expects, as in the
# JAX package (where a mismatch inserts a preprocessor).
_CNN_LAYERS = {"ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
               "LocalResponseNormalization"}
_RNN_LAYERS = {"LSTM", "GravesLSTM", "GravesBidirectionalLSTM", "SimpleRnn",
               "GRU", "RnnOutputLayer", "Convolution1DLayer",
               "Subsampling1DLayer", "SelfAttentionLayer",
               "LastTimeStepLayer", "TimeDistributedLayer",
               "ZeroPadding1DLayer", "PositionalEmbeddingLayer",
               "TiedRnnOutputLayer"}
_ANY_LAYERS = {"BatchNormalization", "GlobalPoolingLayer", "ActivationLayer",
               "DropoutLayer", "LossLayer", "ReshapeLayer", "PermuteLayer",
               "LayerNormalization"}


def expected_input_kind(layer: BaseLayerConf) -> str:
    tag = type(layer).__name__
    if tag in _CNN_LAYERS:
        return "cnn"
    if tag in _RNN_LAYERS:
        return "rnn"
    if tag in _ANY_LAYERS:
        return "any"
    return "ff"


@dataclass
class UpdaterConfig:
    """Updater name + hyperparameters (ref: nn/conf/Updater.java) and the
    learning-rate policy (ref: nn/conf/LearningRatePolicy.java)."""
    name: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9           # nesterovs
    rho: float = 0.95               # adadelta / rmsprop decay
    epsilon: float = 1e-8
    beta1: float = 0.9              # adam / adamax
    beta2: float = 0.999
    lr_policy: str = "none"  # none|exponential|inverse|poly|sigmoid|step|schedule
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 1.0
    lr_policy_steps: float = 1.0
    lr_schedule: Optional[Dict[int, float]] = None  # iteration -> lr

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if v is not None}
        if self.lr_schedule is not None:   # JSON keys are strings
            d["lr_schedule"] = {str(k): v
                                for k, v in self.lr_schedule.items()}
        return d

    @staticmethod
    def from_dict(d: dict) -> "UpdaterConfig":
        d = dict(d)
        if d.get("lr_schedule"):
            d["lr_schedule"] = {int(k): v
                                for k, v in d["lr_schedule"].items()}
        return UpdaterConfig(**d)


@dataclass
class TrainingConfig:
    """Settings carried beside the layers: the init seed, the parameter
    dtype, the optimizer, gradient normalization, the precision policy and
    the backprop style. ``iterations``, ``max_num_line_search_iterations``,
    ``minibatch``, ``backprop`` and ``pretrain`` are carried so the JAX
    package's configs load; the containers refuse their non-default
    values (``netcommon.check_trainable``)."""
    seed: int = 12345
    # sgd | line_gradient_descent | conjugate_gradient | lbfgs
    optimization_algo: str = "sgd"
    iterations: int = 1             # outer solver iterations per fit
    max_num_line_search_iterations: int = 5
    minimize: bool = True
    minibatch: bool = True
    updater: UpdaterConfig = field(default_factory=UpdaterConfig)
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"  # standard | truncated_bptt
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    dtype: str = "float32"
    precision: str = "fp32"         # nn/updater.PrecisionPolicy presets
    loss_scale: Optional[float] = None
    remat: bool = False             # recompute activations in backward

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["updater"] = self.updater.to_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "TrainingConfig":
        d = dict(d)
        d["updater"] = UpdaterConfig.from_dict(d["updater"])
        return TrainingConfig(**d)


@dataclass
class MultiLayerConfiguration:
    """The fully resolved sequential-network config: layers, the
    preprocessor in front of each layer index that needs one, and the
    per-layer input types inferred from ``input_type``."""
    layers: List[BaseLayerConf]
    preprocessors: Dict[int, InputPreProcessor] = field(default_factory=dict)
    input_type: Optional[InputType] = None
    input_types: List[InputType] = field(default_factory=list)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration",
            "version": 1,
            "training": self.training.to_dict(),
            "input_type": (self.input_type.to_dict()
                           if self.input_type else None),
            "input_types": [t.to_dict() for t in self.input_types],
            "preprocessors": {str(i): p.to_dict()
                              for i, p in self.preprocessors.items()},
            "layers": [layer.to_dict() for layer in self.layers],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            preprocessors={int(i): InputPreProcessor.from_dict(pd)
                           for i, pd in d.get("preprocessors", {}).items()},
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            input_types=[InputType.from_dict(t)
                         for t in d.get("input_types", [])],
            training=TrainingConfig.from_dict(d["training"]),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def validate(self, mesh=None, batch_size: Optional[int] = None,
                 hbm_bytes: Optional[int] = None,
                 weight_update_sharding=None, precision=None):
        """graphcheck over this config (``analysis/graphcheck``): the
        shape walk, the loss head, the mesh rules (ZeRO legality and the
        GC015 precision policy too; the config's own
        ``training.precision`` when ``precision`` is not given) and the
        memory estimate. Returns the ``Finding``s, empty for a clean
        config. A metadata walk: no tensor is built."""
        from deeplearning4j_tpu_torch.analysis.graphcheck import (
            check_multilayer,
        )
        return check_multilayer(
            self, mesh=mesh, batch_size=batch_size, hbm_bytes=hbm_bytes,
            weight_update_sharding=weight_update_sharding,
            precision=precision)

    def memory_report(self, batch_size: int = 32):
        """Param count and training-memory estimate of this config at
        ``batch_size`` (``analysis/memory.MemoryReport``)."""
        from deeplearning4j_tpu_torch.analysis.memory import memory_report
        return memory_report(self, batch_size=batch_size)

    def to_yaml(self) -> str:
        """YAML twin of ``to_json``: the dict goes through JSON first, so
        both documents carry the same data (tuples as lists, keys as
        strings)."""
        import yaml
        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml
        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))


def validate_layer_options(layers) -> None:
    """Fail at build time on unknown activation names (the layer's own and
    a recurrent layer's ``gate_activation``)."""
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    for layer in layers:
        for name in ("activation", "gate_activation"):
            act = getattr(layer, name, None)
            if act:
                get_activation(act)


class ListBuilder:
    """Sequential-stack builder (ref: NeuralNetConfiguration.ListBuilder)."""

    def __init__(self, parent: "NeuralNetConfiguration"):
        self._parent = parent
        self._layers: List[BaseLayerConf] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None

    def layer(self, layer: BaseLayerConf,
              index: Optional[int] = None) -> "ListBuilder":
        if index is not None and index != len(self._layers):
            raise ValueError("layers must be added in order")
        self._layers.append(layer)
        return self

    def input_pre_processor(self, layer_index: int,
                            p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[layer_index] = p
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    # alias matching the reference naming
    setInputType = set_input_type

    def backprop_type(self, t: str, fwd: int = 20,
                      bwd: int = 20) -> "ListBuilder":
        training = self._parent._training
        training.backprop_type = t
        training.tbptt_fwd_length = fwd
        training.tbptt_bwd_length = bwd
        return self

    def validate(self, mesh=None, batch_size: Optional[int] = None,
                 weight_update_sharding=None):
        """graphcheck without ``build()``: the findings even of a stack
        ``build()`` raises on (its error becomes a GC005 finding). It
        builds a deep COPY: ``build()`` writes the current global
        defaults into the layers, and validating must not freeze them
        early."""
        import copy
        from deeplearning4j_tpu_torch.analysis.findings import (
            Finding, Severity,
        )
        try:
            conf = copy.deepcopy(self).build()
        except (ValueError, TypeError) as e:
            return [Finding("GC005", Severity.ERROR, "<build>", str(e),
                            "fix the configuration; build() rejects it "
                            "outright")]
        return conf.validate(mesh=mesh, batch_size=batch_size,
                             weight_update_sharding=weight_update_sharding)

    def build(self) -> MultiLayerConfiguration:
        training = self._parent._training
        if not self._layers:
            raise ValueError("No layers added")
        for layer in self._layers:
            layer.apply_global_defaults(self._parent._global)
        validate_layer_options(self._layers)
        # shape inference + auto preprocessors
        input_types: List[InputType] = []
        cur = self._input_type
        if cur is not None:
            for i, layer in enumerate(self._layers):
                if i not in self._preprocessors:
                    p = auto_preprocessor(cur, expected_input_kind(layer))
                    if p is not None:
                        self._preprocessors[i] = p
                if i in self._preprocessors:
                    cur = self._preprocessors[i].infer_output_type(cur)
                layer.set_n_in(cur)  # inference overrides any manual n_in
                input_types.append(cur)
                cur = layer.infer_output_type(cur)
        else:
            for layer in self._layers:
                if layer.has_params() and layer.n_in is None:
                    raise ValueError(
                        f"Layer {layer}: n_in not set and no input_type "
                        "given")
        if (training.backprop_type == "truncated_bptt"
                and self._input_type is not None and cur.kind != "rnn"):
            raise ValueError(
                "truncated_bptt requires a time-distributed output layer "
                "(e.g. RnnOutputLayer); the final layer "
                f"{type(self._layers[-1]).__name__} produces "
                "non-recurrent output")
        return MultiLayerConfiguration(
            layers=self._layers, preprocessors=self._preprocessors,
            input_type=self._input_type, input_types=input_types,
            training=training)


class NeuralNetConfiguration:
    """Global-hyperparameter builder (ref: NeuralNetConfiguration.Builder)."""

    KNOWN_UPDATERS = ("sgd", "adam", "adamax", "adadelta", "nesterovs",
                      "adagrad", "rmsprop", "none")
    KNOWN_DTYPES = ("float32", "bfloat16")

    def __init__(self):
        self._global = GlobalConf()
        self._training = TrainingConfig()

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int) -> "NeuralNetConfiguration":
        self._training.seed = int(s)
        return self

    def activation(self, a: str) -> "NeuralNetConfiguration":
        self._global.activation = a
        return self

    def weight_init(self, w: str) -> "NeuralNetConfiguration":
        self._global.weight_init = w
        return self

    def dist(self, d: Distribution) -> "NeuralNetConfiguration":
        self._global.dist = d
        return self

    def bias_init(self, b: float) -> "NeuralNetConfiguration":
        self._global.bias_init = b
        return self

    def l1(self, v: float) -> "NeuralNetConfiguration":
        self._global.l1 = v
        return self

    def l2(self, v: float) -> "NeuralNetConfiguration":
        self._global.l2 = v
        return self

    def dropout(self, retain_prob: float) -> "NeuralNetConfiguration":
        self._global.dropout = retain_prob
        return self

    def updater(self, name: str, **kwargs) -> "NeuralNetConfiguration":
        if name.lower() not in self.KNOWN_UPDATERS:
            raise ValueError(
                f"Unknown updater {name!r}; expected one of "
                f"{self.KNOWN_UPDATERS}")
        u = self._training.updater
        u.name = name.lower()
        for k, v in kwargs.items():
            if not hasattr(u, k):
                raise ValueError(f"Unknown updater option {k!r}")
            setattr(u, k, v)
        return self

    def learning_rate(self, lr: float) -> "NeuralNetConfiguration":
        self._training.updater.learning_rate = lr
        return self

    def optimization_algo(self, algo: str) -> "NeuralNetConfiguration":
        self._training.optimization_algo = algo.lower()
        return self

    def minimize(self, flag: bool = True) -> "NeuralNetConfiguration":
        self._training.minimize = flag
        return self

    def lr_policy(self, policy: str, decay_rate: float = 0.0,
                  power: float = 1.0, steps: float = 1.0,
                  schedule: Optional[Dict[int, float]] = None
                  ) -> "NeuralNetConfiguration":
        u = self._training.updater
        u.lr_policy = policy.lower()
        u.lr_policy_decay_rate = decay_rate
        u.lr_policy_power = power
        u.lr_policy_steps = steps
        u.lr_schedule = schedule
        return self

    def precision(self, policy: str, loss_scale: Optional[float] = None
                  ) -> "NeuralNetConfiguration":
        """Training precision policy ("fp32", "bf16", "fp16"): the
        compute dtype of the forward and backward over f32 master params
        (``nn/updater.PrecisionPolicy``)."""
        self._training.precision = str(policy).lower()
        self._training.loss_scale = loss_scale
        return self

    def gradient_checkpointing(self, flag: bool = True
                               ) -> "NeuralNetConfiguration":
        self._training.remat = flag
        return self

    def gradient_normalization(self, kind: str, threshold: float = 1.0
                               ) -> "NeuralNetConfiguration":
        self._training.gradient_normalization = kind.lower()
        self._training.gradient_normalization_threshold = threshold
        return self

    def dtype(self, dt: str) -> "NeuralNetConfiguration":
        if dt not in self.KNOWN_DTYPES:
            raise ValueError(f"dtype {dt!r}: the port runs "
                             f"{self.KNOWN_DTYPES}")
        self._training.dtype = dt
        return self

    def list(self) -> ListBuilder:
        """Sequential-stack builder (MultiLayerNetwork)."""
        return ListBuilder(self)

    def graph_builder(self):
        """DAG-network builder (ref: ComputationGraphConfiguration.
        GraphBuilder)."""
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
            GraphBuilder)
        return GraphBuilder(self)
