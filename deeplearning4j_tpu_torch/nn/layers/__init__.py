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
from deeplearning4j_tpu_torch.nn.layers.convolution import (  # noqa: F401
    Convolution1DLayer,
    ConvolutionLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    RBM,
    ActivationLayer,
    AutoEncoder,
    CenterLossOutputLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    LossLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.embedding import (  # noqa: F401
    PositionalEmbeddingLayer,
    TiedRnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (  # noqa: F401
    BatchNormalization,
    LayerNormalization,
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import (  # noqa: F401
    GlobalPoolingLayer,
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
    PermuteLayer,
    RepeatVectorLayer,
    ReshapeLayer,
    TimeDistributedLayer,
    ZeroPadding1DLayer,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (  # noqa: F401
    VariationalAutoencoder,
)
