"""Configuration DSL."""

from deeplearning4j_tpu_torch.nn.conf.builder import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    TrainingConfig,
    UpdaterConfig,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
