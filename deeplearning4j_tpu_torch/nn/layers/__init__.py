"""Layer zoo: each layer is a dataclass of hyperparameters with plain
functions on tensors (the JAX package's design, in PyTorch)."""

from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    SelfAttentionLayer,
    attention_reference,
)
from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    LAYER_REGISTRY,
    BaseLayerConf,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.embedding import (  # noqa: F401
    PositionalEmbeddingLayer,
    TiedRnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (  # noqa: F401
    LayerNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    GRU,
    LSTM,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LastTimeStepLayer,
    RnnOutputLayer,
    SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.layers.shape import (  # noqa: F401
    TimeDistributedLayer,
)
