"""Graph vertices: parameterless DAG ops for ComputationGraph (the JAX
package's ``nn/conf/graph.py``; so far ``ElementWiseVertex``, the residual
add of the GPT blocks, and ``MergeVertex`` and
``DuplicateToTimeSeriesVertex``, which join a static input to a time
series)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Type, Union

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


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature (last) axis (ref: MergeVertex.java)."""

    def infer_output_type(self, in_types):
        t0 = in_types[0]
        if t0.kind == "cnn":
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in in_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in in_types),
                                       t0.timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in in_types))

    def apply(self, inputs):
        return torch.cat(inputs, dim=-1)


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F] by duplication. ``timesteps`` is a fixed T or
    the name of a graph node whose current activation gives T at run time
    (ref: rnn/DuplicateToTimeSeriesVertex.java), which keeps the vertex
    right when tBPTT slices the time axis."""
    timesteps: Union[int, str] = 1

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        t = self.timesteps if isinstance(self.timesteps, int) else None
        return InputType.recurrent(in_types[0].flat_size(), t)

    def apply(self, inputs, ref_act=None):
        if ref_act is not None:
            t = ref_act.shape[1]
        elif isinstance(self.timesteps, int):
            t = self.timesteps
        else:
            raise ValueError(
                f"DuplicateToTimeSeriesVertex references node "
                f"{self.timesteps!r} but no reference activation was "
                "supplied")
        return inputs[0][:, None, :].expand(-1, t, -1)
