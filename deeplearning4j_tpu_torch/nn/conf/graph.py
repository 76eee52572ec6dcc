"""Graph vertices: parameterless DAG ops for ComputationGraph (the JAX
package's ``nn/conf/graph.py``; so far ``ElementWiseVertex``, the residual
add of the GPT blocks)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Type

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class GraphVertex:
    """Parameterless multi-input op in the DAG."""

    def n_inputs(self) -> Optional[int]:
        return None  # None = any

    def infer_output_type(self, in_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise add/subtract/product/average/max
    (ref: ElementWiseVertex.java; subtract needs exactly 2 inputs)."""
    op: str = "add"

    def infer_output_type(self, in_types):
        return in_types[0]

    def apply(self, inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "average":
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown elementwise op {self.op!r}")
