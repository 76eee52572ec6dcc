"""The port's config DSL serde against the JAX package's.

First the port's counterpart of each case of ``tests/test_conf_serde.py``
(JSON and YAML round trips of an MLP, a CNN, an RNN and the newer layers,
preprocessor auto-insertion kept through a load, a restored conf that
builds a working net, the graph YAML case). That file's
``test_gradient_checkpointing_same_result`` has no counterpart yet: remat
waits for ROADMAP A2, and the port refuses ``remat=True`` in training.

Then the cross-framework cases, parametrised over the GPT decoder, the
char-RNN, LeNet-5, VGG-16-CIFAR, ResNet-50 and a graph with every vertex:
the same builder calls in both packages give ``to_dict()`` results that
compare equal as Python objects, and a JSON (or YAML) document written by
either package loads into the other to the same dict. The models run at
small widths, except ResNet-50, whose conf costs nothing to build.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import char_rnn as jchar, gpt as jgpt
from deeplearning4j_tpu.models import lenet as jlenet, resnet as jresnet
from deeplearning4j_tpu.models import vgg as jvgg
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JMLC, NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.conf.graph_builder import (
    ComputationGraphConfiguration as JCGC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
import deeplearning4j_tpu.nn.layers as jlayers

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import char_rnn, gpt, lenet, resnet, vgg
from deeplearning4j_tpu_torch.nn.conf import graph as tgraph
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    GRU, BatchNormalization, ConvolutionLayer, DenseLayer, GravesLSTM,
    LastTimeStepLayer, OutputLayer, PermuteLayer, RepeatVectorLayer,
    ReshapeLayer, RnnOutputLayer, SubsamplingLayer, TimeDistributedLayer,
    ZeroPaddingLayer,
)
import deeplearning4j_tpu_torch.nn.layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

JAX = SimpleNamespace(NNC=JNNC, InputType=JInputType, L=jlayers, G=jgraph,
                      MLC=JMLC, CGC=JCGC)
PORT = SimpleNamespace(NNC=NeuralNetConfiguration, InputType=InputType,
                       L=tlayers, G=tgraph, MLC=MultiLayerConfiguration,
                       CGC=ComputationGraphConfiguration)


def _mlp_conf(ns=PORT):
    return (ns.NNC.builder()
            .seed(42)
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .l2(1e-4)
            .list()
            .layer(ns.L.DenseLayer(n_out=16, activation="relu"))
            .layer(ns.L.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(ns.InputType.feed_forward(8))
            .build())


def test_builder_infers_shapes():
    conf = _mlp_conf()
    assert conf.layers[0].n_in == 8
    assert conf.layers[1].n_in == 16
    assert conf.layers[0].l2 == 1e-4  # inherited global
    assert conf.layers[0].activation == "relu"  # per-layer override


def test_json_round_trip_mlp():
    conf = _mlp_conf()
    j = conf.to_json()
    conf2 = MultiLayerConfiguration.from_json(j)
    assert conf2.to_json() == j
    assert conf2.layers[0].n_out == 16
    assert conf2.training.updater.name == "adam"
    assert conf2.training.updater.learning_rate == 1e-3


def test_json_round_trip_cnn():
    conf = (NeuralNetConfiguration.builder()
            .seed(7)
            .updater("nesterovs", learning_rate=0.01, momentum=0.9)
            .list()
            .layer(ConvolutionLayer(n_out=6, kernel_size=(5, 5),
                                    stride=(1, 1), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(BatchNormalization())
            .layer(ZeroPaddingLayer(pad=(1, 1, 1, 1)))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())
    j = conf.to_json()
    conf2 = MultiLayerConfiguration.from_json(j)
    assert conf2.to_json() == j
    # conv shape inference: 28 -> 24 -> 12 (pool) -> BN -> pad 14
    assert conf.layers[4].n_in == 14 * 14 * 6
    assert conf2.layers[0].kernel_size == (5, 5)   # lists back to tuples


def test_json_round_trip_rnn():
    conf = (NeuralNetConfiguration.builder()
            .list()
            .layer(GravesLSTM(n_out=12, activation="tanh"))
            .layer(RnnOutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.recurrent(6))
            .build())
    j = conf.to_json()
    conf2 = MultiLayerConfiguration.from_json(j)
    assert conf2.to_json() == j
    assert conf2.layers[0].n_in == 6
    assert conf2.layers[1].n_in == 12


def test_preprocessor_auto_insertion_survives_a_load():
    conf = (NeuralNetConfiguration.builder()
            .list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(DenseLayer(n_out=10))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.convolutional(8, 8, 1))
            .build())
    # the CNN -> FF boundary at layer 1 needs a preprocessor
    for c in (conf, MultiLayerConfiguration.from_json(conf.to_json())):
        assert list(c.preprocessors) == [1]
        assert (type(c.preprocessors[1]).__name__
                == "CnnToFeedForwardPreProcessor")


def test_restored_conf_builds_working_net():
    conf2 = MultiLayerConfiguration.from_json(_mlp_conf().to_json())
    net = MultiLayerNetwork(conf2, device="cpu").init()
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    out = net.output(x)
    assert out.shape == (5, 3)
    np.testing.assert_allclose(out.sum(dim=-1).numpy(), 1.0, atol=1e-5)


def test_json_round_trip_new_layers():
    """GRU / Reshape / Permute / RepeatVector / TimeDistributed(inner)
    survive the JSON round trip (the registry, the nested inner layer)."""
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater("adam", learning_rate=0.01).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=12, activation="relu"))
            .layer(ReshapeLayer(target_shape=(3, 4)))
            .layer(PermuteLayer(dims=(2, 1)))
            .layer(TimeDistributedLayer(
                inner=DenseLayer(n_out=5, activation="tanh")))
            .layer(GRU(n_out=6))
            .layer(LastTimeStepLayer())
            .layer(RepeatVectorLayer(n=2))
            .layer(LastTimeStepLayer())
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(12))
            .build())
    j = conf.to_json()
    conf2 = MultiLayerConfiguration.from_json(j)
    assert conf2.to_json() == j
    net = MultiLayerNetwork(conf2, device="cpu").init()
    assert net.output(np.zeros((2, 12), np.float32)).shape == (2, 3)
    td = conf2.layers[3]
    assert isinstance(td, TimeDistributedLayer)
    assert isinstance(td.inner, DenseLayer) and td.inner.n_out == 5
    assert conf2.layers[4].reset_after is True
    assert isinstance(conf2.layers[5], LastTimeStepLayer)


def test_yaml_round_trip_mlp():
    conf = _mlp_conf()
    y = conf.to_yaml()
    conf2 = MultiLayerConfiguration.from_yaml(y)
    assert conf2.to_json() == conf.to_json()
    assert conf2.to_yaml() == y
    assert conf2.training.updater.name == "adam"
    assert conf2.training.updater.learning_rate == 1e-3


def test_yaml_round_trip_cnn_with_preprocessor():
    conf = (NeuralNetConfiguration.builder()
            .list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(DenseLayer(n_out=10))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.convolutional(8, 8, 1))
            .build())
    conf2 = MultiLayerConfiguration.from_yaml(conf.to_yaml())
    assert conf2.to_json() == conf.to_json()
    # the int-keyed preprocessor dict survives the YAML trip
    assert 1 in conf2.preprocessors
    assert (type(conf2.preprocessors[1]).__name__
            == "CnnToFeedForwardPreProcessor")


def test_yaml_restored_conf_builds_working_net():
    conf = MultiLayerConfiguration.from_yaml(_mlp_conf().to_yaml())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    assert net.output(x).shape == (5, 3)


def test_yaml_round_trip_graph():
    conf = (NeuralNetConfiguration.builder()
            .seed(9).updater("adam", learning_rate=0.05)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=16, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax"),
                       "d1")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4))
            .build())
    conf2 = ComputationGraphConfiguration.from_yaml(conf.to_yaml())
    assert conf2.to_json() == conf.to_json()
    assert conf2.topological_order == conf.topological_order


def test_lr_schedule_keys_round_trip_as_ints():
    conf = (NeuralNetConfiguration.builder()
            .updater("sgd", learning_rate=0.1)
            .lr_policy("schedule", schedule={10: 0.05, 100: 0.01})
            .list()
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(3))
            .build())
    assert conf.to_dict()["training"]["updater"]["lr_schedule"] == {
        "10": 0.05, "100": 0.01}
    conf2 = MultiLayerConfiguration.from_json(conf.to_json())
    assert conf2.training.updater.lr_schedule == {10: 0.05, 100: 0.01}


@pytest.mark.parametrize("field, value, item", [
    ("iterations", 3, "A2"),
    ("max_num_line_search_iterations", 9, "A2"),
    ("minibatch", False, "A2"),
    ("backprop", False, "A7"),
    ("pretrain", True, "A7"),
])
def test_jax_only_training_fields_load_and_are_refused(field, value, item):
    """A JAX config with a solver or pretraining setting loads into the
    port; training it raises, naming the ROADMAP item."""
    jconf = _mlp_conf(JAX)
    setattr(jconf.training, field, value)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert getattr(conf.training, field) == value
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.zeros((2, 8), np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1]]
    with pytest.raises(NotImplementedError, match=item):
        net.fit_batch(DataSet(x, y))


# ---------------------------------------------------------------------------
# the same builder calls in both packages
# ---------------------------------------------------------------------------

def _every_vertex_graph(ns):
    """Two inputs and every vertex type of the registry, with a recurrent
    and a feed-forward head."""
    L, G = ns.L, ns.G
    return (ns.NNC.builder().seed(3).updater("rmsprop", learning_rate=0.01)
            .weight_init("relu").l2(1e-4)
            .graph_builder()
            .add_inputs("seq", "vec")
            .add_layer("d1", L.DenseLayer(n_out=6, activation="relu"), "vec")
            .add_vertex("add", G.ElementWiseVertex(op="add"), "vec", "d1")
            .add_vertex("sub", G.SubsetVertex(from_index=1, to_index=4),
                        "add")
            .add_vertex("stack", G.StackVertex(), "add", "d1")
            .add_vertex("unstack", G.UnstackVertex(index=1, num_stacks=2),
                        "stack")
            .add_vertex("l2n", G.L2NormalizeVertex(), "unstack")
            .add_vertex("l2", G.L2Vertex(), "add", "d1")
            .add_vertex("scale", G.ScaleVertex(scale_factor=-2.5), "l2n")
            .add_vertex("shift", G.ShiftVertex(shift=0.75), "scale")
            .add_vertex("reshape", G.ReshapeVertex(shape=(2, 3)), "shift")
            .add_layer("lstm", L.LSTM(n_out=5), "seq")
            .add_vertex("last", G.LastTimeStepVertex(), "lstm")
            .add_vertex("merge", G.MergeVertex(), "sub", "l2", "last")
            .add_vertex("dup", G.DuplicateToTimeSeriesVertex(timesteps="seq"),
                        "merge")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax"),
                       "merge")
            .add_layer("rnn_out", L.RnnOutputLayer(n_out=4,
                                                   activation="softmax"),
                       "dup")
            .add_layer("shape_out", L.RnnOutputLayer(n_out=2,
                                                     activation="softmax"),
                       "reshape")
            .set_outputs("out", "rnn_out", "shape_out")
            .set_input_types(ns.InputType.recurrent(6, 4),
                             ns.InputType.feed_forward(6))
            .build())


CONFIGS = {
    "gpt": (lambda ns: (jgpt if ns is JAX else gpt).gpt_decoder(
        96, 32, 32, 2, 2)),
    "char_rnn": (lambda ns: (jchar if ns is JAX else char_rnn).char_rnn_lstm(
        20, 16, 2)),
    "lenet": (lambda ns: (jlenet if ns is JAX else lenet).lenet_mnist()),
    "vgg16_cifar": (lambda ns: (jvgg if ns is JAX else vgg).vgg16_cifar10()),
    "resnet50": (lambda ns: (jresnet if ns is JAX else resnet).resnet50()),
    "every_vertex": _every_vertex_graph,
}


def _loader(ns, conf):
    return ns.CGC if type(conf).__name__.startswith("Computation") else ns.MLC


@pytest.mark.parametrize("name", list(CONFIGS))
def test_same_builder_calls_give_the_same_dict(name):
    jconf, tconf = CONFIGS[name](JAX), CONFIGS[name](PORT)
    assert tconf.to_dict() == jconf.to_dict()
    assert tconf.to_json() == jconf.to_json()


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_documents_cross_both_ways(name, fmt):
    jconf, tconf = CONFIGS[name](JAX), CONFIGS[name](PORT)
    want = jconf.to_dict()
    # the JAX package's document into the port, and back out
    from_jax = getattr(_loader(PORT, tconf), f"from_{fmt}")(
        getattr(jconf, f"to_{fmt}")())
    assert type(from_jax) is type(tconf)
    assert from_jax.to_dict() == want
    # the port's document into the JAX package
    from_port = getattr(_loader(JAX, jconf), f"from_{fmt}")(
        getattr(tconf, f"to_{fmt}")())
    assert from_port.to_dict() == want


def test_loaded_every_vertex_graph_runs():
    """The loaded graph resolves its shapes again and runs: a JAX
    document builds a port net whose three heads answer."""
    conf = ComputationGraphConfiguration.from_json(
        _every_vertex_graph(JAX).to_json())
    assert conf.resolved_types["reshape"].kind == "rnn"
    assert isinstance(conf.nodes["dup"].vertex.timesteps, str)
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    outs = net.outputs([rng.normal(size=(2, 4, 6)).astype(np.float32),
                        rng.normal(size=(2, 6)).astype(np.float32)])
    assert [tuple(o.shape) for o in outs] == [(2, 3), (2, 4, 4), (2, 2, 2)]
    assert all(torch.isfinite(o).all() for o in outs)
