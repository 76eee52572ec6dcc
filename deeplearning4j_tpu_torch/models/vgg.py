"""VGG-16 (the JAX package's ``models/vgg.py``; BASELINE config #2 is the
CIFAR-10 variant): 13 3x3 ``same`` convolutions in 5 blocks with 2x2 max
pooling, then two dense layers and a softmax, NHWC input."""

from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization, ConvolutionLayer, DenseLayer, OutputLayer,
    SubsamplingLayer,
)

_VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16(seed: int = 12345, learning_rate: float = 1e-2,
          updater: str = "nesterovs", height: int = 224, width: int = 224,
          channels: int = 3, n_classes: int = 1000,
          fc_size: int = 4096, batch_norm: bool = False,
          dtype: str = "float32") -> MultiLayerConfiguration:
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater, learning_rate=learning_rate)
         .weight_init("relu")
         .dtype(dtype)
         .list())
    for n_out, reps in _VGG16_BLOCKS:
        for _ in range(reps):
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     stride=(1, 1), convolution_mode="same",
                                     activation="relu"))
            if batch_norm:
                b.layer(BatchNormalization())
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)))
    b.layer(DenseLayer(n_out=fc_size, activation="relu"))
    b.layer(DenseLayer(n_out=fc_size, activation="relu"))
    b.layer(OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"))
    return b.set_input_type(
        InputType.convolutional(height, width, channels)).build()


def vgg16_cifar10(seed: int = 12345, **kw) -> MultiLayerConfiguration:
    """CIFAR-sized VGG-16 (32x32x3 input, 10 classes, 512-wide FC)."""
    kw.setdefault("height", 32)
    kw.setdefault("width", 32)
    kw.setdefault("channels", 3)
    kw.setdefault("n_classes", 10)
    kw.setdefault("fc_size", 512)
    return vgg16(seed=seed, **kw)
