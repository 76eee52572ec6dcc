"""Network configuration DSL (the JAX package's ``nn/conf/builder.py``, the
subset the GPT decoder uses):

    NeuralNetConfiguration.builder().seed(s).updater("adam", learning_rate=lr)
        .weight_init("xavier").dropout(p).dtype("float32").graph_builder()

Global hyperparameters are inherited by every layer at ``build()``. The
updater settings are stored, not acted on: training is not ported yet.
JSON serde, the sequential ``list()`` builder and mixed precision wait.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerConf, GlobalConf
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
    """Updater name + hyperparameters (stored; ref: nn/conf/Updater.java)."""
    name: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9
    rho: float = 0.95
    epsilon: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.999


@dataclass
class TrainingConfig:
    """Settings carried beside the layers: the init seed, the (stored)
    updater and the parameter dtype."""
    seed: int = 12345
    updater: UpdaterConfig = field(default_factory=UpdaterConfig)
    dtype: str = "float32"


def validate_layer_options(layers) -> None:
    """Fail at build time on unknown activation names."""
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    for layer in layers:
        act = getattr(layer, "activation", None)
        if act:
            get_activation(act)


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

    def dtype(self, dt: str) -> "NeuralNetConfiguration":
        if dt not in self.KNOWN_DTYPES:
            raise ValueError(f"dtype {dt!r}: the port runs "
                             f"{self.KNOWN_DTYPES}")
        self._training.dtype = dt
        return self

    def graph_builder(self):
        """DAG-network builder (ref: ComputationGraphConfiguration.
        GraphBuilder)."""
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
            GraphBuilder)
        return GraphBuilder(self)
