"""LeNet-5 for MNIST (the JAX package's ``models/lenet.py``; BASELINE
config #1): conv 5x5x20 - max pool 2 - conv 5x5x50 - max pool 2 - dense
500 - softmax 10, NHWC input [B, 28, 28, 1], Adam at lr 1e-3."""

from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
)


def lenet_mnist(seed: int = 12345, learning_rate: float = 1e-3,
                updater: str = "adam", dtype: str = "float32",
                channels: int = 1, height: int = 28, width: int = 28,
                n_classes: int = 10) -> MultiLayerConfiguration:
    return (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater, learning_rate=learning_rate)
            .weight_init("xavier")
            .dtype(dtype)
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=n_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(height, width, channels))
            .build())
