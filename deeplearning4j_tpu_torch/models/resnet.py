"""ResNet-50 as a ComputationGraph (the JAX package's
``models/resnet.py``; BASELINE configs #3 and #5): a 7x7/2 stem with a
3x3/2 max pool, bottleneck blocks [1x1, 3x3, 1x1] with identity or
projection shortcuts, batch norm after every convolution, NHWC, bf16 and
Nesterov momentum at lr 0.1 by default. The node names are the JAX
package's, so weights and states carry across by name."""

from typing import Tuple

from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration, GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, SubsamplingLayer,
)

_STAGES: Tuple[Tuple[int, int, int], ...] = (
    # (bottleneck width, n blocks, first stride)
    (64, 3, 1),
    (128, 4, 2),
    (256, 6, 2),
    (512, 3, 2),
)


def _conv_bn(g: GraphBuilder, name: str, inp: str, n_out: int, k: int,
             stride: int, act: str = "identity") -> str:
    g.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                 stride=(stride, stride),
                                 convolution_mode="same",
                                 activation="identity", has_bias=False), inp)
    g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    if act != "identity":
        g.add_layer(f"{name}_act", ActivationLayer(activation=act), f"{name}_bn")
        return f"{name}_act"
    return f"{name}_bn"


def _bottleneck(g: GraphBuilder, name: str, inp: str, width: int,
                stride: int, project: bool) -> str:
    a = _conv_bn(g, f"{name}_a", inp, width, 1, stride, act="relu")
    b = _conv_bn(g, f"{name}_b", a, width, 3, 1, act="relu")
    c = _conv_bn(g, f"{name}_c", b, width * 4, 1, 1, act="identity")
    shortcut = inp
    if project:
        shortcut = _conv_bn(g, f"{name}_proj", inp, width * 4, 1, stride,
                            act="identity")
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, shortcut)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_out"


def resnet50(seed: int = 12345, learning_rate: float = 0.1,
             updater: str = "nesterovs", height: int = 224, width: int = 224,
             channels: int = 3, n_classes: int = 1000,
             dtype: str = "bfloat16") -> ComputationGraphConfiguration:
    g = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater, learning_rate=learning_rate, momentum=0.9)
         .weight_init("relu")
         .dtype(dtype)
         .graph_builder()
         .add_inputs("in"))
    # stem: 7x7/2 conv + 3x3/2 maxpool
    cur = _conv_bn(g, "stem", "in", 64, 7, 2, act="relu")
    g.add_layer("stem_pool",
                SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2), convolution_mode="same"), cur)
    cur = "stem_pool"
    for si, (width_c, blocks, first_stride) in enumerate(_STAGES):
        for bi in range(blocks):
            stride = first_stride if bi == 0 else 1
            cur = _bottleneck(g, f"s{si}b{bi}", cur, width_c, stride,
                              project=(bi == 0))
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), cur)
    g.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                   loss="mcxent"), "avgpool")
    return (g.set_outputs("out")
            .set_input_types(InputType.convolutional(height, width, channels))
            .build())


def resnet_tiny(seed: int = 12345, **kw) -> ComputationGraphConfiguration:
    """Small-input ResNet-50 body for tests (32x32, 10 classes)."""
    kw.setdefault("height", 32)
    kw.setdefault("width", 32)
    kw.setdefault("n_classes", 10)
    kw.setdefault("dtype", "float32")
    return resnet50(seed=seed, **kw)
