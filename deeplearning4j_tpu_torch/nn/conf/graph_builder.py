"""ComputationGraph configuration builder (the JAX package's
``nn/conf/graph_builder.py``): ``add_inputs`` / ``add_layer`` /
``add_vertex`` / ``set_outputs`` / ``set_input_types`` / ``build()``.
``backprop_type``. ``build()`` applies the global defaults, orders the DAG
topologically (Kahn's algorithm), infers every layer's ``n_in`` and, under
truncated BPTT, checks that every output is time-distributed. Where a layer's
input kind differs from what it expects, an input preprocessor goes in
front of it, as in the JAX package (``add_layer(..., preprocessor=)``
sets one by hand). ``to_json`` / ``from_json`` and the YAML twins write
and read the JAX package's documents: the nodes in topological order,
shapes resolved again on load.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.builder import (
    NeuralNetConfiguration, TrainingConfig, expected_input_kind,
    validate_layer_options,
)
from deeplearning4j_tpu_torch.nn.conf.graph import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor, auto_preprocessor,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, layer_from_dict,
)


@dataclass
class NodeConf:
    """One DAG node: an input placeholder, a layer, or a vertex op."""
    name: str
    kind: str                       # "input" | "layer" | "vertex"
    inputs: List[str] = field(default_factory=list)
    layer: Optional[BaseLayerConf] = None
    vertex: Optional[GraphVertex] = None
    preprocessor: Optional[InputPreProcessor] = None


@dataclass
class ComputationGraphConfiguration:
    nodes: Dict[str, NodeConf]
    network_inputs: List[str]
    network_outputs: List[str]
    input_types: Dict[str, InputType] = field(default_factory=dict)
    resolved_types: Dict[str, InputType] = field(default_factory=dict)
    topological_order: List[str] = field(default_factory=list)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    def to_dict(self) -> dict:
        def node_dict(n: NodeConf) -> dict:
            d = {"name": n.name, "kind": n.kind, "inputs": n.inputs}
            if n.layer is not None:
                d["layer"] = n.layer.to_dict()
            if n.vertex is not None:
                d["vertex"] = n.vertex.to_dict()
            if n.preprocessor is not None:
                d["preprocessor"] = n.preprocessor.to_dict()
            return d

        return {
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration",
            "version": 1,
            "training": self.training.to_dict(),
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "input_types": {k: v.to_dict()
                            for k, v in self.input_types.items()},
            "nodes": [node_dict(self.nodes[name])
                      for name in self.topological_order],
            "topological_order": self.topological_order,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        nodes: Dict[str, NodeConf] = {}
        for nd in d["nodes"]:
            nodes[nd["name"]] = NodeConf(
                name=nd["name"], kind=nd["kind"], inputs=list(nd["inputs"]),
                layer=(layer_from_dict(nd["layer"]) if "layer" in nd
                       else None),
                vertex=(GraphVertex.from_dict(nd["vertex"])
                        if "vertex" in nd else None),
                preprocessor=(InputPreProcessor.from_dict(nd["preprocessor"])
                              if "preprocessor" in nd else None))
        conf = ComputationGraphConfiguration(
            nodes=nodes,
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            input_types={k: InputType.from_dict(v)
                         for k, v in d.get("input_types", {}).items()},
            topological_order=list(d["topological_order"]),
            training=TrainingConfig.from_dict(d["training"]),
        )
        conf._resolve_shapes()
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        """YAML twin of ``to_json``, normalized through JSON first so both
        documents carry the same data."""
        import yaml
        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))

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
        """Infer every node's output InputType, put a preprocessor in
        front of each layer whose input kind needs one, and fill layer
        n_in."""
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
                cur = in_ts[0]
                if node.preprocessor is None:
                    node.preprocessor = auto_preprocessor(
                        cur, expected_input_kind(node.layer))
                if node.preprocessor is not None:
                    cur = node.preprocessor.infer_output_type(cur)
                node.layer.set_n_in(cur)
                types[name] = node.layer.infer_output_type(cur)
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

    def add_layer(self, name: str, layer: BaseLayerConf, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        if name in self._nodes:
            raise ValueError(f"Duplicate node name {name!r}")
        layer.name = name
        self._nodes[name] = NodeConf(name=name, kind="layer",
                                     inputs=list(inputs), layer=layer,
                                     preprocessor=preprocessor)
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

    def backprop_type(self, t: str, fwd: int = 20,
                      bwd: int = 20) -> "GraphBuilder":
        training = self._parent._training
        training.backprop_type = t
        training.tbptt_fwd_length = fwd
        training.tbptt_bwd_length = bwd
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
        if (conf.training.backprop_type == "truncated_bptt"
                and conf.resolved_types):
            bad = [o for o in self._outputs
                   if conf.resolved_types[o].kind != "rnn"]
            if bad:
                raise ValueError(
                    "truncated_bptt requires time-distributed (rnn) "
                    f"output(s); outputs {bad} resolve to non-rnn types")
        return conf
