"""Visualization listeners: convolutional activation grids and the network
flow view (the JAX package's ``ui/listeners.py``, for both containers).

Ref: deeplearning4j-ui/.../weights/ConvolutionalIterationListener.java
(636 LoC — tiles conv-layer activation channels into one image grid every
N iterations for the UI) and flow/FlowIterationListener.java (555 LoC —
network-graph layout + per-layer metadata JSON for the flow dashboard).
Here the grid is produced as a numpy image (optionally dumped to .npy /
rendered into the components HTML report) and the flow view is the same
nodes+edges JSON.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


def tile_activations(act: np.ndarray, pad: int = 1) -> np.ndarray:
    """[H, W, C] (or [B, H, W, C]: first example) -> one [rows*H, cols*W]
    grayscale grid, channels tiled row-major and min-max normalized —
    what ConvolutionalIterationListener renders per layer."""
    a = np.asarray(act)
    if a.ndim == 4:
        a = a[0]
    if a.ndim != 3:
        raise ValueError(f"need [H,W,C] activations, got shape {a.shape}")
    H, W, C = a.shape
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    lo, hi = float(a.min()), float(a.max())
    norm = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    grid = np.zeros((rows * (H + pad) - pad, cols * (W + pad) - pad),
                    np.float32)
    for c in range(C):
        r, col = divmod(c, cols)
        grid[r * (H + pad):r * (H + pad) + H,
             col * (W + pad):col * (W + pad) + W] = norm[..., c]
    return grid


def _activations(model, x):
    """(key, activation) of every layer of ``model`` on ``x``, inference
    mode: ``feed_forward`` of a ``MultiLayerNetwork`` by layer index, the
    walk of a ``ComputationGraph`` by node name (its inputs left out)."""
    if hasattr(model.conf, "nodes"):
        with torch.no_grad():
            acts = model._forward(model.params, model.states,
                                  model._to_input_map(x))[0]
        inputs = set(model.conf.network_inputs)
        return [(k, a) for k, a in acts.items() if k not in inputs]
    return list(enumerate(model.feed_forward(x)))


class ConvolutionalIterationListener(IterationListener):
    """Every ``frequency`` iterations, capture conv-layer activation grids
    for the current input. ``renders`` maps layer index (a graph's node
    name) -> latest grid. Only the first example of each rank-4
    activation is copied off the card."""

    def __init__(self, frequency: int = 10,
                 output_dir: Optional[str] = None):
        self.frequency = max(1, frequency)
        self.output_dir = output_dir
        self.renders: Dict[object, np.ndarray] = {}

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency:
            return
        x = getattr(model, "last_input", None)
        if x is None:
            return
        for i, a in _activations(model, x):
            if a.dim() == 4:  # conv-shaped [B, H, W, C]
                grid = tile_activations(a[0].float().cpu().numpy())
                self.renders[i] = grid
                if self.output_dir:
                    np.save(f"{self.output_dir}/layer{i}_iter{iteration}.npy",
                            grid)


class FlowIterationListener(IterationListener):
    """Network-graph JSON for the flow view: per-layer nodes (name, type,
    output shape, param count) + sequential/DAG edges + latest score."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.snapshot: Optional[dict] = None

    @staticmethod
    def _describe_multilayer(model) -> dict:
        nodes, edges = [], []
        nodes.append({"name": "input", "layerType": "Input"})
        prev = "input"
        for i, layer in enumerate(model.conf.layers):
            name = f"layer{i}"
            nodes.append({
                "name": name,
                "layerType": type(layer).__name__,
                "nOut": getattr(layer, "n_out", None),
                "activation": getattr(layer, "activation", None),
                "numParams": int(sum(
                    np.prod(p.shape) for p in model.params[i].values())
                    if i < len(model.params) else 0),
            })
            edges.append({"from": prev, "to": name})
            prev = name
        return {"nodes": nodes, "edges": edges}

    @staticmethod
    def _describe_graph(model) -> dict:
        conf = model.conf
        nodes, edges = [], []
        for name in conf.network_inputs:
            nodes.append({"name": name, "layerType": "Input"})
        for name, node in conf.nodes.items():
            if node.kind == "input":    # placeholders already emitted above
                continue
            kind = (type(node.layer).__name__ if node.layer is not None
                    else type(node.vertex).__name__)
            nodes.append({"name": name, "layerType": kind})
            for src in node.inputs:
                edges.append({"from": src, "to": name})
        return {"nodes": nodes, "edges": edges}

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency:
            return
        if hasattr(model, "conf") and hasattr(model.conf, "nodes"):
            d = self._describe_graph(model)
        elif hasattr(model, "conf"):
            d = self._describe_multilayer(model)
        else:
            return
        d["iteration"] = iteration
        d["score"] = float(score)
        self.snapshot = d

    def to_json(self) -> str:
        return json.dumps(self.snapshot or {})
