"""ComputationGraph configuration builder (the JAX package's
``nn/conf/graph_builder.py``): ``add_inputs`` / ``add_layer`` /
``add_vertex`` / ``set_outputs`` / ``set_input_types`` / ``build()``.
``build()`` applies the global defaults, orders the DAG topologically
(Kahn's algorithm) and infers every layer's ``n_in``. Input preprocessors
are not ported yet: a layer whose input kind would need one raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.builder import (
    NeuralNetConfiguration, TrainingConfig, expected_input_kind,
    validate_layer_options,
)
from deeplearning4j_tpu_torch.nn.conf.graph import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerConf


@dataclass
class NodeConf:
    """One DAG node: an input placeholder, a layer, or a vertex op."""
    name: str
    kind: str                       # "input" | "layer" | "vertex"
    inputs: List[str] = field(default_factory=list)
    layer: Optional[BaseLayerConf] = None
    vertex: Optional[GraphVertex] = None


def _check_input_kind(name: str, cur: InputType, want: str) -> None:
    kind = "ff" if cur.kind == "cnnflat" else cur.kind
    if want not in ("any", kind):
        raise NotImplementedError(
            f"node {name!r}: its {cur.kind} input needs a {want} input "
            "preprocessor, which the port does not have yet")


@dataclass
class ComputationGraphConfiguration:
    nodes: Dict[str, NodeConf]
    network_inputs: List[str]
    network_outputs: List[str]
    input_types: Dict[str, InputType] = field(default_factory=dict)
    resolved_types: Dict[str, InputType] = field(default_factory=dict)
    topological_order: List[str] = field(default_factory=list)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    def _topo_sort(self) -> List[str]:
        """Kahn's algorithm (ref: ComputationGraph.topologicalSortOrder)."""
        indeg = {n: len(c.inputs) for n, c in self.nodes.items()}
        children: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for n, c in self.nodes.items():
            for inp in c.inputs:
                if inp not in self.nodes:
                    raise ValueError(
                        f"Node {n!r} references unknown input {inp!r}")
                children[inp].append(n)
        queue = [n for n, d in indeg.items() if d == 0]
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for ch in children[n]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    queue.append(ch)
        if len(order) != len(self.nodes):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise ValueError(f"Graph has a cycle involving {cyc}")
        return order

    def _resolve_shapes(self) -> None:
        """Infer every node's output InputType and fill layer n_in."""
        self.topological_order = self._topo_sort()
        if not self.input_types:
            return
        types: Dict[str, InputType] = {}
        for name in self.topological_order:
            node = self.nodes[name]
            if node.kind == "input":
                types[name] = self.input_types[name]
                continue
            in_ts = [types[i] for i in node.inputs]
            if node.kind == "layer":
                _check_input_kind(name, in_ts[0],
                                  expected_input_kind(node.layer))
                node.layer.set_n_in(in_ts[0])
                types[name] = node.layer.infer_output_type(in_ts[0])
            else:
                want = node.vertex.n_inputs()
                if want is not None and len(in_ts) != want:
                    raise ValueError(f"Vertex {name!r} expects {want} "
                                     f"inputs, got {len(in_ts)}")
                types[name] = node.vertex.infer_output_type(in_ts)
        self.resolved_types = types


class GraphBuilder:
    """Fluent DAG builder (ref: ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, parent: NeuralNetConfiguration):
        self._parent = parent
        self._nodes: Dict[str, NodeConf] = {}
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._input_types: Dict[str, InputType] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            self._inputs.append(n)
            self._nodes[n] = NodeConf(name=n, kind="input")
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        if len(types) != len(self._inputs):
            raise ValueError("one InputType per network input required")
        self._input_types = dict(zip(self._inputs, types))
        return self

    def add_layer(self, name: str, layer: BaseLayerConf,
                  *inputs: str) -> "GraphBuilder":
        if name in self._nodes:
            raise ValueError(f"Duplicate node name {name!r}")
        layer.name = name
        self._nodes[name] = NodeConf(name=name, kind="layer",
                                     inputs=list(inputs), layer=layer)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        if name in self._nodes:
            raise ValueError(f"Duplicate node name {name!r}")
        self._nodes[name] = NodeConf(name=name, kind="vertex",
                                     inputs=list(inputs), vertex=vertex)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("addInputs() required")
        if not self._outputs:
            raise ValueError("setOutputs() required")
        for out in self._outputs:
            if out not in self._nodes:
                raise ValueError(f"Unknown output {out!r}")
        layers = [n.layer for n in self._nodes.values() if n.layer is not None]
        for layer in layers:
            layer.apply_global_defaults(self._parent._global)
        validate_layer_options(layers)
        conf = ComputationGraphConfiguration(
            nodes=self._nodes,
            network_inputs=self._inputs,
            network_outputs=self._outputs,
            input_types=self._input_types,
            training=self._parent._training,
        )
        conf._resolve_shapes()
        return conf
