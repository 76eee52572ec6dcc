"""Keras model import: HDF5 -> framework configs + weights (the JAX
package's ``keras/keras_import.py``).

Ref: deeplearning4j-modelimport/.../keras/{KerasModelImport.java:48-284,
KerasModel.java, KerasSequentialModel.java, KerasLayer.java (1189 LoC of
layer mapping + dim-ordering fixups)}.

Supports Keras 1.x and 2.x saved models (``model.save`` -> model_config
attr + /model_weights, or ``save_weights`` -> weights at root):

- Sequential -> MultiLayerNetwork
- Functional Model (linear + Add/Concatenate merges) -> ComputationGraph

Weight-layout translation notes (the part KerasLayer.java spends most of
its 1189 lines on):
- Dense kernel [in, out] == our [in, out]; no transpose.
- Conv2D TF ordering [kh, kw, in, out] == our HWIO; TH ordering
  [out, in, kh, kw] is transposed to HWIO.
- LSTM: Keras gate order is (i, f, c, o); our gate blocks are (i, f, g, o)
  with g == c — the orders coincide by design (see
  nn/layers/recurrent.py docstring), so kernels copy straight through.
  Keras 1.x per-gate matrices (W_i, U_i, b_i, ...) are concatenated.
- BatchNormalization: gamma/beta -> params; moving mean/var -> layer state.

In the port the files are read by ``keras/hdf5.py`` (plain Python, no
libhdf5 and no h5py), a ``.keras`` zip's ``model.weights.h5`` too. The
import entry points take ``device=``: the net is built there (``None``
means the CUDA card and raises without one; ``"cpu"`` runs the plain
versions), and each weight is copied from numpy into the net's tensor in
place. An imported ``LSTM`` keeps ``forget_gate_bias_init=0.0``: Keras's
bias already holds its ``unit_forget_bias``, and the fused LSTM adds the
layer's forget-gate bias at run time.
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.keras.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex, LastTimeStepVertex, MergeVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    GRU, LSTM, ActivationLayer, BatchNormalization, Convolution1DLayer,
    ConvolutionLayer, DenseLayer, DropoutLayer, EmbeddingLayer,
    GlobalPoolingLayer, LastTimeStepLayer, LayerNormalization, OutputLayer,
    PermuteLayer, RepeatVectorLayer, ReshapeLayer, SimpleRnn,
    Subsampling1DLayer, SubsamplingLayer, TimeDistributedLayer,
    ZeroPadding1DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

_KERAS_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "softmax": "softmax", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid", "elu": "elu",
    "selu": "selu", "swish": "swish", "gelu": "gelu",
}


def _act(name: Optional[str]) -> str:
    return _KERAS_ACTIVATIONS.get(name or "linear", "identity")


def _cfg(layer_cfg: dict) -> dict:
    return layer_cfg.get("config", layer_cfg)


class KerasLayerMapper:
    """class_name -> layer conf (ref: KerasLayer.getKerasLayerFromConfig)."""

    @staticmethod
    def map(class_name: str, cfg: dict):
        if class_name == "Dense":
            units = cfg.get("units", cfg.get("output_dim"))
            return DenseLayer(n_out=int(units), activation=_act(cfg.get("activation")))
        if class_name in ("Conv2D", "Convolution2D"):
            filters = cfg.get("filters", cfg.get("nb_filter"))
            if "kernel_size" in cfg:
                kh, kw = cfg["kernel_size"]
            else:
                kh, kw = cfg.get("nb_row"), cfg.get("nb_col")
            strides = tuple(cfg.get("strides", cfg.get("subsample", (1, 1))))
            pad = cfg.get("padding", cfg.get("border_mode", "valid"))
            mode = "same" if pad == "same" else "truncate"
            dil = tuple(cfg.get("dilation_rate", (1, 1)))
            return ConvolutionLayer(n_out=int(filters), kernel_size=(kh, kw),
                                    stride=strides, dilation=dil,
                                    convolution_mode=mode,
                                    activation=_act(cfg.get("activation")))
        if class_name in ("Conv1D", "Convolution1D"):
            # ref: the reference's convolution translator handles 1-D too
            # (modelimport/.../layers/KerasConvolution.java); Keras 1.x
            # spells the hyperparams filter_length/subsample_length
            filters = cfg.get("filters", cfg.get("nb_filter"))
            k = (cfg["kernel_size"][0] if "kernel_size" in cfg
                 else cfg.get("filter_length"))
            strides = cfg.get("strides", cfg.get("subsample_length", 1))
            s = strides[0] if isinstance(strides, (list, tuple)) else strides
            pad = cfg.get("padding", cfg.get("border_mode", "valid"))
            if pad == "causal":
                raise ValueError("Conv1D padding='causal' is not supported")
            dil = cfg.get("dilation_rate", 1)
            dil = dil[0] if isinstance(dil, (list, tuple)) else dil
            return Convolution1DLayer(
                n_out=int(filters), kernel_size=(int(k), 1),
                stride=(int(s), 1), dilation=(int(dil), 1),
                convolution_mode="same" if pad == "same" else "truncate",
                activation=_act(cfg.get("activation")))
        if class_name in ("MaxPooling1D", "AveragePooling1D"):
            pool = cfg.get("pool_size", cfg.get("pool_length", 2))
            p0 = pool[0] if isinstance(pool, (list, tuple)) else pool
            strides = cfg.get("strides", cfg.get("stride")) or p0
            s = strides[0] if isinstance(strides, (list, tuple)) else strides
            pad = cfg.get("padding", cfg.get("border_mode", "valid"))
            return Subsampling1DLayer(
                pooling_type="max" if class_name.startswith("Max") else "avg",
                kernel_size=(int(p0), 1), stride=(int(s), 1),
                convolution_mode="same" if pad == "same" else "truncate")
        if class_name in ("MaxPooling2D", "AveragePooling2D"):
            pool = tuple(cfg.get("pool_size", (2, 2)))
            strides = tuple(cfg.get("strides") or pool)
            pad = cfg.get("padding", cfg.get("border_mode", "valid"))
            return SubsamplingLayer(
                pooling_type="max" if class_name.startswith("Max") else "avg",
                kernel_size=pool, stride=strides,
                convolution_mode="same" if pad == "same" else "truncate")
        if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                          "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
            return GlobalPoolingLayer(
                pooling_type="max" if "Max" in class_name else "avg")
        if class_name == "Flatten":
            return "flatten"
        if class_name == "Dropout":
            # Keras stores drop prob; our conf stores retain prob (DL4J-style)
            rate = cfg.get("rate", cfg.get("p", 0.5))
            return DropoutLayer(dropout=1.0 - float(rate))
        if class_name == "Activation":
            return ActivationLayer(activation=_act(cfg.get("activation")))
        if class_name == "LayerNormalization":
            axis = cfg.get("axis", -1)
            if isinstance(axis, (list, tuple)):
                axis = axis[0] if len(axis) == 1 else axis
            if axis not in (-1,):
                raise ValueError(
                    f"LayerNormalization axis={axis} unsupported (only the "
                    "last/feature axis)")
            if not cfg.get("scale", True) or not cfg.get("center", True):
                raise ValueError("LayerNormalization with scale=False or "
                                 "center=False is unsupported")
            return LayerNormalization(eps=float(cfg.get("epsilon", 1e-5)))
        if class_name == "BatchNormalization":
            return BatchNormalization(eps=float(cfg.get("epsilon", 1e-5)),
                                      decay=float(cfg.get("momentum", 0.99)))
        if class_name == "ZeroPadding2D":
            p = cfg.get("padding", (1, 1))
            if isinstance(p, (list, tuple)) and len(p) == 2 \
                    and isinstance(p[0], (list, tuple)):
                (t, b), (l, r) = p
            elif isinstance(p, (list, tuple)):
                t, b, l, r = p[0], p[0], p[1], p[1]
            else:
                t = b = l = r = int(p)
            return ZeroPaddingLayer(pad=(t, b, l, r))
        if class_name == "LSTM":
            units = cfg.get("units", cfg.get("output_dim"))
            return LSTM(n_out=int(units),
                        activation=_act(cfg.get("activation", "tanh")),
                        gate_activation=_act(cfg.get("recurrent_activation",
                                                     cfg.get("inner_activation",
                                                             "sigmoid"))),
                        forget_gate_bias_init=0.0)
        if class_name == "GRU":
            units = cfg.get("units", cfg.get("output_dim"))
            # Keras >= 2.1 always writes reset_after; its absence means a
            # legacy (Keras 1.x) config whose math is reset-BEFORE
            return GRU(n_out=int(units),
                       activation=_act(cfg.get("activation", "tanh")),
                       gate_activation=_act(cfg.get("recurrent_activation",
                                                    cfg.get("inner_activation",
                                                            "sigmoid"))),
                       reset_after=bool(cfg.get("reset_after", False)))
        if class_name == "SimpleRNN":
            units = cfg.get("units", cfg.get("output_dim"))
            return SimpleRnn(n_out=int(units),
                             activation=_act(cfg.get("activation", "tanh")))
        if class_name == "Reshape":
            return ReshapeLayer(target_shape=tuple(cfg["target_shape"]))
        if class_name == "Permute":
            return PermuteLayer(dims=tuple(cfg["dims"]))
        if class_name == "RepeatVector":
            return RepeatVectorLayer(n=int(cfg["n"]))
        if class_name == "ZeroPadding1D":
            p = cfg.get("padding", 1)
            if isinstance(p, (list, tuple)):
                l, r = (p[0], p[1]) if len(p) == 2 else (p[0], p[0])
            else:
                l = r = int(p)
            return ZeroPadding1DLayer(padding=(int(l), int(r)))
        if class_name == "TimeDistributedDense":
            # Keras 1.x spelling of TimeDistributed(Dense); reuse the
            # Dense mapping so future Dense fixes cover this path too
            return TimeDistributedLayer(
                inner=KerasLayerMapper.map("Dense", cfg))
        if class_name == "TimeDistributed":
            inner_cfg = cfg["layer"]
            inner = KerasLayerMapper.map(inner_cfg["class_name"],
                                         _cfg(inner_cfg))
            if isinstance(inner, str) or not hasattr(inner, "apply"):
                raise ValueError(
                    f"TimeDistributed({inner_cfg['class_name']}) unsupported")
            return TimeDistributedLayer(inner=inner)
        if class_name == "Embedding":
            return EmbeddingLayer(n_out=int(cfg.get("output_dim")),
                                  n_in=int(cfg.get("input_dim")),
                                  activation="identity")
        if class_name == "InputLayer":
            return "input"
        raise ValueError(f"Unsupported Keras layer type {class_name!r}")


def _input_type_from_config(cfg: dict) -> Optional[InputType]:
    shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
    if shape is None:
        return None
    dims = [d for d in shape[1:]]
    if len(dims) == 1 and dims[0] is not None:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        # Keras TF ordering: (h, w, c)
        return InputType.convolutional(dims[0], dims[1], dims[2])
    return None


# Keras merge-layer class -> vertex factory. Keras 1.x used a single
# "Merge" layer with a mode string; Keras 2.x has one class per op
# (ref: KerasMerge.java mapping to DL4J MergeVertex/ElementWiseVertex).
def _concat_vertex(cfg: dict) -> MergeVertex:
    axis = cfg.get("axis", cfg.get("concat_axis", -1))
    if axis not in (-1, 3):
        # MergeVertex concatenates along the feature (last) axis; Keras
        # channels-last models use axis=-1 (default) or axis=3 (NHWC
        # channel axis, e.g. keras.applications Inception/ResNet). Anything
        # else (channels_first retrain, time-axis concat) has no mapping.
        raise ValueError(
            f"Concatenate axis={axis} unsupported (only the last/feature "
            "axis maps to MergeVertex)")
    return MergeVertex()


_MERGE_CLASSES = {
    "Add": lambda cfg: ElementWiseVertex(op="add"),
    "Subtract": lambda cfg: ElementWiseVertex(op="subtract"),
    "Multiply": lambda cfg: ElementWiseVertex(op="product"),
    "Average": lambda cfg: ElementWiseVertex(op="average"),
    "Maximum": lambda cfg: ElementWiseVertex(op="max"),
    "Concatenate": _concat_vertex,
}

_KERAS1_MERGE_MODES = {
    "sum": lambda: ElementWiseVertex(op="add"),
    "mul": lambda: ElementWiseVertex(op="product"),
    "ave": lambda: ElementWiseVertex(op="average"),
    "max": lambda: ElementWiseVertex(op="max"),
    "concat": lambda: MergeVertex(),
}


def _inbound_names(inbound_nodes) -> List[str]:
    """Source-layer names of a layer's first inbound node.

    Handles the nested-list format (Keras 1.x/2.x:
    ``[[["src", 0, 0, {}], ...]]``) and the dict format (TF-Keras 2.13+ /
    Keras 3: ``[{"args": [<keras tensors with keras_history>], ...}]``).
    Ref: KerasModel.java inbound-node graph walk.
    """
    if not inbound_nodes:
        return []
    node0 = inbound_nodes[0]
    names: List[str] = []
    if isinstance(node0, dict):
        def walk(obj):
            if isinstance(obj, dict):
                if obj.get("class_name") == "__keras_tensor__":
                    hist = obj.get("config", {}).get("keras_history")
                    if hist:
                        names.append(hist[0])
                    return
                for v in obj.values():
                    walk(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    walk(v)
        walk(node0)
    else:
        for entry in node0:
            if isinstance(entry, (list, tuple)) and entry:
                names.append(entry[0])
            elif isinstance(entry, str):
                names.append(entry)
    return names


def _layer_ref_name(ref) -> str:
    """'fc1000' from an input_layers/output_layers entry (list or str)."""
    if isinstance(ref, (list, tuple)):
        return ref[0]
    return ref


def _layer_refs(val) -> List[str]:
    """Normalize input_layers/output_layers: either a list of refs
    (``[["a",0,0], ["b",0,0]]`` or ``["a","b"]``) or ONE flat ref
    (``["a", 0, 0]`` — Keras 3 single-input form)."""
    if not val:
        return []
    if (isinstance(val, (list, tuple)) and isinstance(val[0], str)
            and len(val) == 3 and isinstance(val[1], int)):
        return [val[0]]
    return [_layer_ref_name(r) for r in val]


def _snake(name: str) -> str:
    """CamelCase -> snake_case, matching Keras's auto object naming
    ('Conv2D' -> 'conv2d', 'SimpleRNN' -> 'simple_rnn')."""
    import re
    s = re.sub(r"\W+", "", name)
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", s)
    s = re.sub(r"([a-z])([A-Z])", r"\1_\2", s)
    return s.lower()


class KerasModelImport:
    """Static entry points (ref: KerasModelImport.java:101
    importKerasSequentialModelAndWeights / importKerasModelAndWeights).

    Accepts legacy HDF5 files (the format the reference supports) AND the
    modern Keras-3 ``.keras`` zip format (config.json +
    model.weights.h5) — an extension beyond the reference's importer.
    """

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path: str, enforce_training_config: bool = False,
            device=None) -> MultiLayerNetwork:
        """A Sequential model's file -> MultiLayerNetwork on ``device``."""
        return KerasModelImport._import(path, "Sequential", device)

    # alias with the reference's naming
    importKerasSequentialModelAndWeights = import_keras_sequential_model_and_weights

    @staticmethod
    def import_keras_model_and_weights(path: str,
                                       enforce_training_config: bool = False,
                                       device=None):
        """Functional ``Model`` -> ComputationGraph; Sequential models go
        the sequential path (ref: KerasModelImport.java:101,
        KerasModel.java getComputationGraphConfiguration/getComputationGraph).
        """
        return KerasModelImport._import(path, None, device)

    # alias with the reference's naming
    importKerasModelAndWeights = import_keras_model_and_weights

    @staticmethod
    def _import(path, require: Optional[str], device):
        """Either format; ``require`` names the one model class the
        caller takes, checked before anything is built."""
        if zipfile.is_zipfile(path):
            return KerasModelImport._import_keras_v3(path, require, device)
        with Hdf5Archive(path) as h5:
            cfg_json = h5.read_attribute_as_string("model_config")
            if cfg_json is None:
                raise ValueError(f"{str(path)!r} has no model_config "
                                 "attribute")
            model_cfg = json.loads(cfg_json)
            cls = model_cfg.get("class_name")
            if require is not None and cls != require:
                raise ValueError(f"Not a {require} model; use "
                                 "import_keras_model_and_weights")
            if cls == "Sequential":
                layer_cfgs = model_cfg["config"]
                if isinstance(layer_cfgs, dict):  # Keras 2.2+: {'layers'}
                    layer_cfgs = layer_cfgs["layers"]
                net = KerasModelImport._build_sequential(layer_cfgs, device)
                KerasModelImport._load_sequential_weights(h5, net)
            elif cls in ("Model", "Functional"):
                net = KerasModelImport._build_graph(model_cfg["config"],
                                                    device)
                KerasModelImport._load_graph_weights(h5, net)
            else:
                raise ValueError(f"Unsupported Keras model class {cls!r}")
        return net

    @staticmethod
    def _build_graph(cfg: dict, device) -> ComputationGraph:
        """Functional-config DAG -> ComputationGraphConfiguration.

        InputLayer nodes become network inputs; merge layers become
        Merge/ElementWise vertices; Flatten collapses into the auto
        CnnToFeedForward preprocessor (alias to its upstream node); the
        Dense feeding each network output becomes an OutputLayer so the
        imported net is trainable (ref: KerasModel.java:1-647).
        """
        layer_cfgs: List[dict] = cfg["layers"]
        input_names = _layer_refs(cfg.get("input_layers", []))
        output_names = _layer_refs(cfg.get("output_layers", []))

        b = NeuralNetConfiguration.builder().seed(12345)
        gb = b.graph_builder()

        # alias: keras layer name -> graph node name that produces its output
        alias: Dict[str, str] = {}
        input_types: Dict[str, InputType] = {}
        # pre-scan: which keras names feed a network output (for OutputLayer
        # conversion) — a Dense is a loss head only if it IS an output
        out_set = set(output_names)
        kept_names: List[str] = []  # layer nodes that own weights, in order

        # Network inputs MUST follow cfg["input_layers"] order, not the
        # layers-list encounter order (Keras stores layers in traversal
        # order) — callers zip positional inputs against this order.
        by_name = {(_cfg(lc).get("name", lc.get("name"))): lc
                   for lc in layer_cfgs}
        if not input_names:  # older configs: fall back to encounter order
            input_names = [_cfg(lc).get("name", lc.get("name"))
                           for lc in layer_cfgs
                           if lc["class_name"] == "InputLayer"]
        for iname in input_names:
            kcfg = _cfg(by_name[iname])
            it = _input_type_from_config(kcfg)
            if it is None:
                raise ValueError(f"InputLayer {iname!r} has no "
                                 "batch_input_shape")
            gb.add_inputs(iname)
            input_types[iname] = it
            alias[iname] = iname

        groups: Dict[str, str] = {}  # node name -> h5 group path rel. root
        for lc in layer_cfgs:
            cls = lc["class_name"]
            kcfg = _cfg(lc)
            name = kcfg.get("name", lc.get("name"))
            inbound = lc.get("inbound_nodes", [])
            if len(inbound) > 1:
                raise ValueError(
                    f"Layer {name!r} is shared (called {len(inbound)} "
                    "times); shared-layer import is unsupported")
            srcs = [alias[s] for s in _inbound_names(inbound)]
            if cls == "InputLayer":
                continue  # added above, in input_layers order
            alias[name] = KerasModelImport._emit_layer(
                gb, kept_names, groups, name, cls, kcfg, srcs, out_set,
                name)

        gb.set_outputs(*[alias[o] for o in output_names])
        gb.set_input_types(*[input_types[i] for i in input_types])
        net = ComputationGraph(gb.build(), device=device).init()
        net._keras_names = kept_names  # node name == keras layer name
        net._keras_groups = groups
        return net

    @staticmethod
    def _emit_layer(gb, kept, groups, node_name, cls, kcfg, srcs, out_set,
                    h5_path, nested_ctx=None):
        """Add one Keras layer (or merge vertex, or nested submodel) to the
        graph builder; returns the node name producing its output.
        ``h5_path`` is the weight-group path (or list of candidate paths)
        relative to the weights root — the keras name at top level;
        nested layers live at ``<outer>/<outer>/<inner>`` (Sequential
        submodels) or ``<outer>/<inner>`` (functional submodels) in the
        legacy HDF5 layout, so nested nodes carry both candidates.
        ``nested_ctx``: (top outer name, relative prefix) when emitting
        inside a submodel."""
        if cls in _MERGE_CLASSES:
            gb.add_vertex(node_name, _MERGE_CLASSES[cls](kcfg), *srcs)
            return node_name
        if cls == "Merge":  # Keras 1.x
            mode = kcfg.get("mode", "sum")
            if mode not in _KERAS1_MERGE_MODES:
                raise ValueError(f"Unsupported Merge mode {mode!r}")
            gb.add_vertex(node_name, _KERAS1_MERGE_MODES[mode](), *srcs)
            return node_name
        if cls in ("Sequential", "Functional", "Model"):
            top, rel = nested_ctx or (node_name, "")
            return KerasModelImport._inline_submodel(
                gb, kept, groups, node_name, cls, kcfg, srcs, out_set,
                top, rel)
        mapped = KerasLayerMapper.map(cls, kcfg)
        if mapped in ("flatten", "input"):
            # collapses into the auto preprocessor of the consumer
            return srcs[0]
        if node_name in out_set and isinstance(mapped, DenseLayer) \
                and not isinstance(mapped, OutputLayer):
            loss = "mcxent" if mapped.activation == "softmax" else "mse"
            mapped = OutputLayer(n_out=mapped.n_out,
                                 activation=mapped.activation, loss=loss)
        gb.add_layer(node_name, mapped, *srcs)
        kept.append(node_name)
        groups[node_name] = h5_path
        if isinstance(mapped, (LSTM, GRU, SimpleRnn)) \
                and not kcfg.get("return_sequences", False):
            # Keras LSTM default emits only the final step; ours emits
            # the sequence — append a LastTimeStepVertex
            gb.add_vertex(node_name + "__last", LastTimeStepVertex(),
                          node_name)
            return node_name + "__last"
        return node_name

    @staticmethod
    def _inline_submodel(gb, kept, groups, outer_name, cls, kcfg, srcs,
                         out_set, top, rel_prefix):
        """Inline a nested Sequential/Functional model as prefixed graph
        nodes (ref: KerasModel.java handles nested models by recursion).
        ``top`` is the top-level submodel's keras name (the h5 group);
        ``rel_prefix`` the path inside nested submodels so far."""
        layers_cfg = kcfg["layers"]

        def inner_emit(iname, icls, icfg, isrcs, inner_out_set):
            # '.'-separated node names: '/' would collide with the
            # sharded-checkpoint leaf-path join (parallel/checkpoint.py)
            node = f"{outer_name}.{iname}"
            rel = rel_prefix + iname
            return KerasModelImport._emit_layer(
                gb, kept, groups, node, icls, icfg, isrcs, inner_out_set,
                [f"{top}/{top}/{rel}", f"{top}/{rel}"],
                nested_ctx=(top, rel + "/"))

        # the submodel's output should become a loss head only when the
        # submodel itself IS a network output
        convert_out = outer_name in out_set

        if cls == "Sequential":
            if len(srcs) != 1:
                raise ValueError(
                    f"Nested Sequential {outer_name!r} needs exactly one "
                    f"input, got {len(srcs)}")
            # convert to a loss head only when the submodel's FINAL
            # emitting layer is a Dense (a mid-sequence Dense followed by
            # Dropout/Activation must stay an inner layer)
            fin = next((lc for lc in reversed(layers_cfg)
                        if lc["class_name"] not in ("InputLayer",
                                                    "Flatten")), None)
            inner_out = frozenset()
            if convert_out and fin is not None \
                    and fin["class_name"] == "Dense":
                fname = _cfg(fin).get("name", fin.get("name"))
                inner_out = {f"{outer_name}.{fname}"}
            prev = srcs[0]
            for lc in layers_cfg:
                icls = lc["class_name"]
                icfg = _cfg(lc)
                iname = icfg.get("name", lc.get("name"))
                if icls == "InputLayer":
                    continue
                prev = inner_emit(iname, icls, icfg, [prev], inner_out)
            return prev

        # nested functional Model: positional inputs map onto the outer
        # sources; single output only (multi-output submodels have no
        # single downstream node to alias)
        in_names = _layer_refs(kcfg.get("input_layers", []))
        if not in_names:
            in_names = [_cfg(lc).get("name", lc.get("name"))
                        for lc in layers_cfg
                        if lc["class_name"] == "InputLayer"]
        out_refs = _layer_refs(kcfg.get("output_layers", []))
        if len(out_refs) != 1:
            raise ValueError(
                f"Nested model {outer_name!r} has {len(out_refs)} "
                "outputs; only single-output submodels import")
        if len(in_names) != len(srcs):
            raise ValueError(
                f"Nested model {outer_name!r} takes {len(in_names)} "
                f"inputs, got {len(srcs)}")
        sub_alias = dict(zip(in_names, srcs))
        inner_out = ({f"{outer_name}.{out_refs[0]}"} if convert_out
                     else frozenset())
        for lc in layers_cfg:
            icls = lc["class_name"]
            icfg = _cfg(lc)
            iname = icfg.get("name", lc.get("name"))
            if icls == "InputLayer":
                continue
            inbound = lc.get("inbound_nodes", [])
            if len(inbound) > 1:
                raise ValueError(
                    f"Layer {iname!r} in nested model {outer_name!r} is "
                    "shared; shared-layer import is unsupported")
            isrcs = [sub_alias[s] for s in _inbound_names(inbound)]
            sub_alias[iname] = inner_emit(iname, icls, icfg, isrcs,
                                          inner_out)
        return sub_alias[out_refs[0]]

    # ---------------------------------------------------------- keras-3 zip
    @staticmethod
    def _import_keras_v3(path, require: Optional[str] = None, device=None):
        """Import the Keras-3 native ``.keras`` zip: config.json carries
        the same polymorphic model config; model.weights.h5 stores each
        layer's variables under ``layers/<class-counter-path>/vars/<i>``
        (paths use per-class counters in model-build order — 'conv2d',
        'conv2d_1', ... — NOT the user layer names). The weights file is
        read from the zip's bytes by ``Hdf5Archive``."""
        with zipfile.ZipFile(path) as z:
            model_cfg = json.loads(z.read("config.json"))
            cls = model_cfg.get("class_name")
            if require is not None and cls != require:
                # fail BEFORE building the graph / copying weights
                raise ValueError(
                    f"Not a {require} model; use "
                    "import_keras_model_and_weights")
            wbytes = z.read("model.weights.h5")
        layer_cfgs = model_cfg["config"]
        if isinstance(layer_cfgs, dict):
            inner_layers = layer_cfgs.get("layers", [])
        else:
            inner_layers = layer_cfgs
        if any(lc["class_name"] in ("Sequential", "Functional", "Model")
               for lc in inner_layers):
            raise ValueError(
                ".keras files with nested submodels are unsupported; "
                "re-save as legacy HDF5 (model.save('m.h5'))")
        if cls == "Sequential":
            net = KerasModelImport._build_sequential(inner_layers, device)
        elif cls in ("Model", "Functional"):
            net = KerasModelImport._build_graph(model_cfg["config"], device)
        else:
            raise ValueError(f"Unsupported Keras model class {cls!r}")

        # keras layer name -> class-counter weight path, in config order
        # (== build order)
        wpaths: Dict[str, str] = {}
        counters: Dict[str, int] = {}
        for lc in inner_layers:
            snake = _snake(lc["class_name"])
            idx = counters.get(snake, 0)
            counters[snake] = idx + 1
            name = _cfg(lc).get("name", lc.get("name"))
            wpaths[name] = snake if idx == 0 else f"{snake}_{idx}"

        is_graph = isinstance(net, ComputationGraph)
        targets = (net._keras_names if is_graph
                   else list(zip(range(len(net.layers)), net._keras_names)))
        with Hdf5Archive(wbytes) as h:
            stored = {n for _, n in h.list_children("/layers")}

            def var_names(grp):
                return [n for k, n in h.list_children(f"{grp}/vars")
                        if k == "d"]
            for entry in targets:
                li, kname = (entry, entry) if is_graph else entry
                wp = wpaths.get(kname)
                if wp is None or wp not in stored:
                    continue
                grp = f"/layers/{wp}"
                for nested in ("cell", "layer"):  # RNNs nest vars in the
                    # cell; TimeDistributed wraps them under 'layer'
                    inner = dict((n, k) for k, n in h.list_children(grp))
                    if not var_names(grp) and inner.get(nested) == "g":
                        grp = f"{grp}/{nested}"
                n_vars = len(var_names(grp))
                if not n_vars:
                    continue
                arrs = [h.read_dataset(f"{grp}/vars/{i}")
                        for i in range(n_vars)]
                layer = (net.conf.nodes[li].layer if is_graph
                         else net.layers[li])
                ds = KerasModelImport._name_v3_vars(layer, arrs)
                KerasModelImport._set_layer_weights(net, li, layer, ds,
                                                    tf_kernels=True)
        return net

    @staticmethod
    def _name_v3_vars(layer, arrs) -> Dict[str, np.ndarray]:
        """Assign Keras variable names to the ordered vars list (the v3
        format stores variables positionally, in layer.weights order)."""
        if isinstance(layer, BatchNormalization):
            if len(arrs) != 4:
                # scale=False / center=False drop gamma/beta from the
                # positional vars list; assigning by position would
                # silently write beta into gamma
                raise ValueError(
                    ".keras BatchNormalization with scale=False or "
                    "center=False is unsupported (positional weight "
                    f"list has {len(arrs)} entries, expected 4)")
            names = ["gamma", "beta", "moving_mean", "moving_variance"]
        elif isinstance(layer, LayerNormalization):
            names = ["gamma", "beta"]
        elif isinstance(layer, (LSTM, GRU, SimpleRnn)):
            names = ["kernel", "recurrent_kernel", "bias"]
        elif isinstance(layer, EmbeddingLayer):
            names = ["embeddings"]
        else:  # Dense / Conv / TimeDistributed-wrapped Dense
            names = ["kernel", "bias"]
        return dict(zip(names, arrs))

    @staticmethod
    def _layer_datasets(h5: Hdf5Archive, group: str) -> Dict[str, np.ndarray]:
        """{param name: array} for one layer's weight group, via the
        ``weight_names`` attr (Keras save_weights layout) or, absent that,
        the group's direct dataset children."""
        wnames = h5.read_attribute_as_string_list("weight_names", group)
        if wnames is None:
            children = h5.list_children(group)
            wnames = [n for k, n in children if k == "d"]
        return {
            wn.split("/")[-1].split(":")[0]:
                h5.read_dataset(f"{group}/{wn}".replace("//", "/"))
            for wn in wnames}

    @staticmethod
    def _load_graph_weights(h5: Hdf5Archive, net: ComputationGraph) -> None:
        root = KerasModelImport._weights_root(h5)
        groups = getattr(net, "_keras_groups", {})
        for name in net._keras_names:
            layer = net.conf.nodes[name].layer
            cand = groups.get(name, name)
            datasets = {}
            for c in ([cand] if isinstance(cand, str) else cand):
                datasets = KerasModelImport._layer_datasets(
                    h5, f"{root}/{c}".replace("//", "/"))
                if datasets:
                    break
            if not datasets:
                continue
            KerasModelImport._set_layer_weights(net, name, layer, datasets)

    @staticmethod
    def _build_sequential(layer_cfgs: List[dict], device) -> MultiLayerNetwork:
        b = NeuralNetConfiguration.builder().seed(12345)
        lb = b.list()
        input_type = None
        kept: List[Tuple[dict, object]] = []  # (keras cfg, our layer)
        for lc in layer_cfgs:
            cls = lc["class_name"]
            cfg = _cfg(lc)
            if input_type is None:
                it = _input_type_from_config(cfg)
                if it is not None:
                    input_type = it
            mapped = KerasLayerMapper.map(cls, cfg)
            if mapped in ("flatten", "input"):
                continue  # flatten == our auto CnnToFeedForward preprocessor
            kept.append((lc, mapped))
            if isinstance(mapped, (LSTM, GRU, SimpleRnn)) \
                    and not cfg.get("return_sequences", False):
                # Keras LSTM default emits only the final step; ours emits
                # the sequence — append a param-free LastTimeStepLayer whose
                # synthetic name has no weight group in the h5 (skipped by
                # the weight loader)
                synth = {"config": {"name": (cfg.get("name", "lstm")
                                             + "__last")}}
                kept.append((synth, LastTimeStepLayer()))
        if input_type is None:
            raise ValueError("Cannot infer input shape (no batch_input_shape)")
        # final Dense becomes an OutputLayer so the net is trainable
        for i, (lc, layer) in enumerate(kept):
            if i == len(kept) - 1 and isinstance(layer, DenseLayer) \
                    and not isinstance(layer, OutputLayer):
                loss = ("mcxent" if layer.activation == "softmax" else "mse")
                layer = OutputLayer(n_out=layer.n_out,
                                    activation=layer.activation, loss=loss)
                kept[i] = (lc, layer)
            lb.layer(layer)
        net = MultiLayerNetwork(lb.set_input_type(input_type).build(),
                                device=device).init()
        net._keras_names = [  # layer name alignment for weight loading
            _cfg(lc).get("name", lc.get("name", f"layer_{i}"))
            for i, (lc, _) in enumerate(kept)]
        return net

    @staticmethod
    def _weights_root(h5: Hdf5Archive) -> str:
        children = dict((name, kind) for kind, name in h5.list_children("/"))
        return "/model_weights" if "model_weights" in children else "/"

    @staticmethod
    def _load_sequential_weights(h5: Hdf5Archive,
                                 net: MultiLayerNetwork) -> None:
        root = KerasModelImport._weights_root(h5)
        for li, (layer, name) in enumerate(zip(net.layers, net._keras_names)):
            group = f"{root}/{name}".replace("//", "/")
            datasets = KerasModelImport._layer_datasets(h5, group)
            if not datasets:
                continue
            KerasModelImport._set_layer_weights(net, li, layer, datasets)

    @staticmethod
    def _set_layer_weights(net, li: int, layer, ds: Dict[str, np.ndarray],
                           tf_kernels: bool = False):
        """``tf_kernels=True`` (the .keras v3 path) asserts kernels are
        already HWIO, suppressing the legacy Theano-ordering heuristic —
        which would mis-fire on HWIO kernels whose height happens to
        equal n_out (e.g. a 3-filter 3x3 conv)."""
        p = net.params[li]

        def put(name, arr):
            ref = p[name]
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"Layer {li} ({type(layer).__name__}) param {name}: "
                    f"shape {tuple(arr.shape)} != expected "
                    f"{tuple(ref.shape)}")
            with torch.no_grad():
                ref.copy_(torch.from_numpy(
                    np.ascontiguousarray(arr)).to(ref.dtype))

        if isinstance(layer, ConvolutionLayer):
            kernel = ds.get("kernel", ds.get("W"))
            if (not tf_kernels and kernel.ndim == 4
                    and kernel.shape[0] == layer.n_out):
                # TH ordering [out, in, kh, kw] -> HWIO
                kernel = kernel.transpose(2, 3, 1, 0)
            put("W", kernel)
            if "bias" in ds or "b" in ds:
                put("b", ds.get("bias", ds.get("b")))
        elif isinstance(layer, LayerNormalization):
            put("gamma", ds.get("gamma"))
            put("beta", ds.get("beta"))
        elif isinstance(layer, BatchNormalization):
            put("gamma", ds.get("gamma"))
            put("beta", ds.get("beta"))
            mean = ds.get("moving_mean", ds.get("running_mean"))
            var = ds.get("moving_variance", ds.get("running_std",
                                                   ds.get("running_var")))
            state = net.states[li]
            with torch.no_grad():
                for key, arr in (("mean", mean), ("var", var)):
                    state[key].copy_(torch.from_numpy(
                        np.asarray(arr, np.float32)).to(state[key].dtype))
        elif isinstance(layer, LSTM):
            if "kernel" in ds:  # Keras 2: fused (i, f, c, o) == our order
                put("W", ds["kernel"])
                put("RW", ds["recurrent_kernel"])
                put("b", ds.get("bias", np.zeros(p["b"].shape)))
            else:  # Keras 1: per-gate W_i/U_i/b_i...
                W = np.concatenate([ds["W_i"], ds["W_f"], ds["W_c"], ds["W_o"]],
                                   axis=-1)
                U = np.concatenate([ds["U_i"], ds["U_f"], ds["U_c"], ds["U_o"]],
                                   axis=-1)
                bvec = np.concatenate([ds["b_i"], ds["b_f"], ds["b_c"], ds["b_o"]])
                put("W", W)
                put("RW", U)
                put("b", bvec)
        elif isinstance(layer, GRU):
            if "kernel" in ds:  # Keras 2+: fused (z, r, h) == our order
                put("W", ds["kernel"])
                put("RW", ds["recurrent_kernel"])
                bias = ds.get("bias")
                if bias is not None:
                    if bias.ndim == 2:  # reset_after: [input; recurrent]
                        put("b", bias[0])
                        put("b2", bias[1])
                    else:
                        put("b", bias)
            else:  # Keras 1: per-gate W_z/U_z/b_z...
                put("W", np.concatenate([ds["W_z"], ds["W_r"], ds["W_h"]],
                                        axis=-1))
                put("RW", np.concatenate([ds["U_z"], ds["U_r"], ds["U_h"]],
                                         axis=-1))
                put("b", np.concatenate([ds["b_z"], ds["b_r"], ds["b_h"]]))
        elif isinstance(layer, SimpleRnn):
            put("W", ds.get("kernel", ds.get("W")))
            put("RW", ds.get("recurrent_kernel", ds.get("U")))
            if "bias" in ds or "b" in ds:
                put("b", ds.get("bias", ds.get("b")))
        elif isinstance(layer, TimeDistributedLayer):
            # Keras nests the wrapped layer's weights directly under the
            # TimeDistributed group; our param dict IS the inner layer's
            KerasModelImport._set_layer_weights(net, li, layer.inner, ds,
                                                tf_kernels=tf_kernels)
            return
        elif isinstance(layer, EmbeddingLayer):
            put("W", ds.get("embeddings", ds.get("W")))
            # Keras embeddings have no bias; ours stays zero
        elif isinstance(layer, DenseLayer):  # incl. OutputLayer
            put("W", ds.get("kernel", ds.get("W")))
            if "bias" in ds or "b" in ds:
                put("b", ds.get("bias", ds.get("b")))
