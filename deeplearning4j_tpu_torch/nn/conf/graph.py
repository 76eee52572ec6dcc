"""Graph vertices: parameterless DAG ops for ComputationGraph (the JAX
package's ``nn/conf/graph.py``): merge, elementwise, subset, stack and
unstack, L2 normalize, L2 distance, scale, shift, reshape, last time step
and duplicate-to-time-series. The graph walk hands ``LastTimeStepVertex``
its input's mask (``apply_masked``) and ``DuplicateToTimeSeriesVertex``
its reference node's activation."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Type, Union

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
class SubsetVertex(GraphVertex):
    """The feature-axis slice [from_index, to_index], both inclusive."""
    from_index: int = 0
    to_index: int = 0

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        n = self.to_index - self.from_index + 1
        t = in_types[0]
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        return InputType.feed_forward(n)

    def apply(self, inputs):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """Concatenate the inputs along the batch axis (shared weights,
    triplet nets)."""

    def infer_output_type(self, in_types):
        return in_types[0]

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Batch slice ``index`` of ``num_stacks`` equal slices."""
    index: int = 0
    num_stacks: int = 1

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        return in_types[0]

    def apply(self, inputs):
        x = inputs[0]
        step = x.shape[0] // self.num_stacks
        return x[self.index * step:(self.index + 1) * step]


def _example_axes(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(1, x.dim()))


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    """x / sqrt(sum x^2 + eps) over each example's axes."""
    eps: float = 1e-8

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        return in_types[0]

    def apply(self, inputs):
        x = inputs[0]
        return x / torch.sqrt((x * x).sum(_example_axes(x), keepdim=True)
                              + self.eps)


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """The L2 distance of two inputs per example -> [B, 1] (siamese and
    triplet losses)."""
    eps: float = 1e-8

    def n_inputs(self):
        return 2

    def infer_output_type(self, in_types):
        return InputType.feed_forward(1)

    def apply(self, inputs):
        a, b = inputs
        return torch.sqrt(((a - b) ** 2).sum(_example_axes(a), keepdim=True)
                          + self.eps)


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar."""
    scale_factor: float = 1.0

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        return in_types[0]

    def apply(self, inputs):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    """Add a fixed scalar."""
    shift: float = 0.0

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        return in_types[0]

    def apply(self, inputs):
        return inputs[0] + self.shift


@register_vertex
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape each example to ``shape``: (F) ff, (T, F) rnn, (H, W, C)
    cnn."""
    shape: Tuple[int, ...] = ()

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        if len(self.shape) == 1:
            return InputType.feed_forward(self.shape[0])
        if len(self.shape) == 3:
            return InputType.convolutional(*self.shape)
        if len(self.shape) == 2:
            return InputType.recurrent(self.shape[1], self.shape[0])
        raise ValueError(self.shape)

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F]: the last step, or with a mask each example's
    last unmasked step (pre- or post-padding)."""

    def n_inputs(self):
        return 1

    def infer_output_type(self, in_types):
        return InputType.feed_forward(in_types[0].size)

    def apply(self, inputs):
        return inputs[0][:, -1, :]

    def apply_masked(self, inputs, mask):
        if mask is None:
            return self.apply(inputs)
        x = inputs[0]
        # the last step where mask == 1: the first 1 of the reversed mask
        T = mask.shape[1]
        idx = T - 1 - torch.argmax((torch.flip(mask, dims=[1]) > 0).to(
            torch.int32), dim=1)
        return x[torch.arange(x.shape[0], device=x.device), idx]


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
