"""Transfer learning: rebuild networks from pretrained ones (the JAX
package's ``nn/transferlearning.py``).

Ref: nn/transferlearning/TransferLearning.java:34-129 (Builder),
FineTuneConfiguration.java (global hyperparameter overrides),
TransferLearningHelper.java (freeze + featurize-and-cache).

Capabilities matching the reference Builder:
- ``set_feature_extractor(n)``  — freeze layers [0..n] (FrozenLayer wrapper
  in the reference; the ``frozen`` flag + update mask here)
- ``n_out_replace(i, n_out, weight_init)`` — swap a layer's output width,
  re-initializing it and the following layer's inputs
- ``remove_output_layer`` / ``remove_layers_from_output(k)``
- ``add_layer(layer)``
- ``fine_tune_configuration(...)`` — override updater/lr/etc.

The built net lives on the source net's device and starts from copies of
the kept params and layer states, so training it leaves the source as it
was. Re-initialized layers draw from a CPU ``torch.Generator`` seeded with
the config's seed, in layer order. A frozen layer's gradient is computed
and then masked out of the update (``nn/updater.py``), as in the JAX
package, so a frozen LSTM still runs the training kernels.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.builder import TrainingConfig
from deeplearning4j_tpu_torch.nn.conf.graph_builder import NodeConf
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerConf, GlobalConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

Tensor = torch.Tensor


def _copy(tree: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: t.detach().clone() for k, t in tree.items()}


@dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to the copied conf
    (ref: transferlearning/FineTuneConfiguration.java)."""
    updater: Optional[str] = None
    learning_rate: Optional[float] = None
    seed: Optional[int] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None

    def apply(self, training: TrainingConfig, layers: List[BaseLayerConf]):
        if self.updater is not None:
            training.updater.name = self.updater.lower()
        if self.learning_rate is not None:
            training.updater.learning_rate = self.learning_rate
        if self.seed is not None:
            training.seed = self.seed
        for layer in layers:
            if self.l1 is not None:
                layer.l1 = self.l1
            if self.l2 is not None:
                layer.l2 = self.l2
            if self.dropout is not None:
                layer.dropout = self.dropout


class TransferLearning:
    """``TransferLearning.builder(net)`` (ref: TransferLearning.Builder)."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            net._check_init()
            self._src = net
            self._conf = copy.deepcopy(net.conf)
            self._params = [_copy(p) for p in net.params]
            self._states = [_copy(s) for s in net.states]
            self._freeze_until: Optional[int] = None
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._reinit: List[int] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers [0..layer_index] inclusive
            (ref: Builder.setFeatureExtractor)."""
            self._freeze_until = layer_index
            return self

        def n_out_replace(self, layer_index: int, n_out: int,
                          weight_init: Optional[str] = None):
            """Change layer_index's n_out, re-initializing it and the next
            parameterized layer's inputs (ref: Builder.nOutReplace)."""
            layers = self._conf.layers
            layer = layers[layer_index]
            layer.n_out = n_out
            if weight_init is not None:
                layer.weight_init = weight_init
            self._reinit.append(layer_index)
            # next layer's n_in changes => re-init it too
            for j in range(layer_index + 1, len(layers)):
                nxt = layers[j]
                if nxt.has_params():
                    nxt.n_in = n_out
                    self._reinit.append(j)
                    break
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, k: int):
            for _ in range(k):
                self._conf.layers.pop()
                self._params.pop()
                self._states.pop()
                if self._conf.input_types:
                    self._conf.input_types.pop()
            return self

        def add_layer(self, layer: BaseLayerConf):
            layers = self._conf.layers
            # infer n_in from the previous layer's output type
            prev_out = None
            for prev in reversed(layers):
                t = getattr(prev, "n_out", None)
                if t:
                    prev_out = t
                    break
            if prev_out is not None:
                in_t = InputType.feed_forward(prev_out)
                layer.set_n_in(in_t)
                if self._conf.input_types:
                    self._conf.input_types.append(in_t)
            layer.apply_global_defaults(GlobalConf())
            layers.append(layer)
            self._params.append({})
            self._states.append({})
            self._reinit.append(len(layers) - 1)
            return self

        def build(self) -> MultiLayerNetwork:
            if self._fine_tune is not None:
                self._fine_tune.apply(self._conf.training, self._conf.layers)
            if self._freeze_until is not None:
                for i in range(self._freeze_until + 1):
                    self._conf.layers[i].frozen = True
            net = MultiLayerNetwork(self._conf, device=self._src.device)
            # re-init changed layers, keep the rest of the pretrained params
            gen = torch.Generator().manual_seed(self._conf.training.seed)
            params, states = [], []
            for i, layer in enumerate(self._conf.layers):
                fresh = i in self._reinit
                if fresh or not self._params[i]:
                    params.append(layer.init_params(gen, net.dtype)
                                  if layer.has_params() else {})
                else:
                    params.append(self._params[i])
                states.append(self._states[i] if not fresh and
                              self._states[i] else layer.init_state())
            return net.init(params=params, states=states)

    class GraphBuilder:
        """Transfer learning on a ComputationGraph
        (ref: TransferLearning.java:34-129 GraphBuilder —
        setFeatureExtractor / nOutReplace / removeVertexAndConnections /
        addLayer / addVertex / setOutputs)."""

        def __init__(self, net: ComputationGraph):
            net._check_init()
            self._src = net
            self._conf = copy.deepcopy(net.conf)
            self._params = {k: _copy(v) for k, v in net.params.items()}
            self._states = {k: _copy(v) for k, v in net.states.items()}
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_at: List[str] = []
            self._reinit: List[str] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *names: str):
            """Freeze the named vertices and everything upstream of them
            (ref: GraphBuilder.setFeatureExtractor)."""
            self._freeze_at = list(names)
            return self

        def n_out_replace(self, layer_name: str, n_out: int,
                          weight_init: Optional[str] = None):
            """Change a layer's n_out and re-initialize it; downstream
            layers whose input widths change re-initialize via the shape
            pass + shape-mismatch detection at build
            (ref: GraphBuilder.nOutReplace)."""
            node = self._conf.nodes[layer_name]
            if node.layer is None:
                raise ValueError(f"{layer_name!r} is not a layer node")
            node.layer.n_out = n_out
            if weight_init is not None:
                node.layer.weight_init = weight_init
            self._reinit.append(layer_name)
            return self

        def remove_vertex_and_connections(self, name: str):
            """Drop a node and every edge referencing it
            (ref: GraphBuilder.removeVertexAndConnections). Consumers of
            the removed node must be rewired (add new layers/outputs)
            before build()."""
            self._conf.nodes.pop(name)
            self._params.pop(name, None)
            self._states.pop(name, None)
            for node in self._conf.nodes.values():
                node.inputs = [i for i in node.inputs if i != name]
            self._conf.network_outputs = [
                o for o in self._conf.network_outputs if o != name]
            return self

        def add_layer(self, name: str, layer: BaseLayerConf, *inputs: str):
            if name in self._conf.nodes:
                raise ValueError(f"Duplicate node name {name!r}")
            layer.name = name
            layer.apply_global_defaults(GlobalConf())
            self._conf.nodes[name] = NodeConf(name=name, kind="layer",
                                              inputs=list(inputs),
                                              layer=layer)
            self._reinit.append(name)
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            if name in self._conf.nodes:
                raise ValueError(f"Duplicate node name {name!r}")
            self._conf.nodes[name] = NodeConf(name=name, kind="vertex",
                                              inputs=list(inputs),
                                              vertex=vertex)
            return self

        def set_outputs(self, *names: str):
            for n in names:
                if n not in self._conf.nodes:
                    raise ValueError(f"Unknown output {n!r}")
            self._conf.network_outputs = list(names)
            return self

        def _ancestors(self, names: List[str]) -> set:
            """The named nodes plus everything upstream of them."""
            out = set()
            stack = list(names)
            while stack:
                n = stack.pop()
                if n in out:
                    continue
                out.add(n)
                stack.extend(self._conf.nodes[n].inputs)
            return out

        def build(self) -> ComputationGraph:
            layer_confs = [n.layer for n in self._conf.nodes.values()
                           if n.layer is not None]
            if self._fine_tune is not None:
                self._fine_tune.apply(self._conf.training, layer_confs)
            if self._freeze_at:
                for n in self._ancestors(self._freeze_at):
                    node = self._conf.nodes[n]
                    if node.layer is not None:
                        node.layer.frozen = True
            self._conf._resolve_shapes()  # re-infer n_in after edits
            net = ComputationGraph(self._conf, device=self._src.device).init()
            # keep pretrained params wherever shapes still match and the
            # node wasn't explicitly re-initialized
            reinit = set(self._reinit)
            params, states = dict(net.params), dict(net.states)
            for name, p in net.params.items():
                if name in reinit or name not in self._params:
                    continue
                old = self._params[name]
                if (set(old) == set(p)
                        and all(old[k].shape == p[k].shape for k in p)):
                    params[name] = old
                    if self._states.get(name):
                        states[name] = self._states[name]
            return net.init(params=params, states=states)

    @staticmethod
    def builder(net) -> "TransferLearning.Builder":
        return TransferLearning.Builder(net)

    @staticmethod
    def graph_builder(net) -> "TransferLearning.GraphBuilder":
        return TransferLearning.GraphBuilder(net)


class TransferLearningHelper:
    """Featurize-and-cache training for frozen-bottom networks
    (ref: transferlearning/TransferLearningHelper.java): run inputs through
    the frozen stack once, then train only the unfrozen top on the cached
    features."""

    def __init__(self, net: MultiLayerNetwork):
        net._check_init()
        self.net = net
        frozen = [i for i, layer in enumerate(net.layers) if layer.frozen]
        self._split = (max(frozen) + 1) if frozen else 0

    def featurize(self, features) -> Tensor:
        """Activations at the frozen/unfrozen boundary, in inference mode
        (ref: MultiLayerNetwork.feedForwardToLayer)."""
        net, split = self.net, self._split
        conf, in_types = net.conf, net.conf.input_types
        h = net._to_tensor(features)
        with torch.no_grad():
            for i in range(split):
                if i in conf.preprocessors:
                    h = conf.preprocessors[i].transform(
                        h, in_types[i] if in_types else None)
                h, _ = net.layers[i].apply(net.params[i], h,
                                           state=net.states[i], train=False,
                                           rng=None)
            if split in conf.preprocessors:
                h = conf.preprocessors[split].transform(
                    h, in_types[split] if in_types else None)
        return h

    def unfrozen_net(self) -> MultiLayerNetwork:
        """A standalone net of the unfrozen top layers sharing params."""
        conf = copy.deepcopy(self.net.conf)
        conf.layers = conf.layers[self._split:]
        conf.preprocessors = {i - self._split: p
                              for i, p in conf.preprocessors.items()
                              if i >= self._split}
        conf.input_types = conf.input_types[self._split:]
        top = MultiLayerNetwork(conf, device=self.net.device)
        return top.init(params=self.net.params[self._split:],
                        states=self.net.states[self._split:])
