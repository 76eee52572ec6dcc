"""MultiLayerNetwork: the sequential model container (the JAX package's
``nn/multilayer.py``), inference and stateful streaming.

Params are a list of per-layer dicts {param name -> tensor}, in the JAX
package's names and layouts, on the net's device. The container runs on
``cuda`` unless it is built with ``device="cpu"``; with ``device=None``
and no card it raises. The JAX container stops its forward before a loss
head and applies the head afterwards, without the time mask; the port's
heads have no loss yet, so every layer applies in order and a final loss
head (a layer with a ``loss``) gets no mask, which computes the same
output: a masked step's output is the head on its zero activation.
Training, tBPTT, pretraining, the flat parameter view and the
evaluation/scoring mixins are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration

Tensor = torch.Tensor


def _sum_aux_losses(states):
    """Sum the differentiable auxiliary losses layers surface in their
    state (``aux_loss``), added to the objective inside the gradient; 0.0
    when none does."""
    total = 0.0
    leaves = states.values() if isinstance(states, dict) else states
    for st in leaves:
        if isinstance(st, dict) and "aux_loss" in st:
            total = total + st["aux_loss"]
    return total


def _dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.dtype = _dtype_of(conf.training.dtype)
        self.params: Optional[List[Dict[str, Tensor]]] = None
        self.states: Optional[List[Dict[str, Tensor]]] = None
        self._rnn_carries: Optional[List[Any]] = None  # rnn_time_step state

    # ------------------------------------------------------------------ init
    def init(self, params=None) -> "MultiLayerNetwork":
        """Draw params from a CPU ``torch.Generator`` seeded with the
        config's seed, layer by layer (the same weights on every device),
        or take ``params`` (e.g. ``convert.params_from_jax``); either way
        they are moved to the net's device."""
        if params is None:
            gen = torch.Generator().manual_seed(self.conf.training.seed)
            params = [layer.init_params(gen, self.dtype)
                      if layer.has_params() else {} for layer in self.layers]
        self.params = [{k: t.to(self.device) for k, t in p.items()}
                       for p in params]
        self.states = [layer.init_state() for layer in self.layers]
        return self

    def _check_init(self):
        if self.params is None:
            raise RuntimeError("Call init() before using the network")

    def num_params(self) -> int:
        self._check_init()
        return sum(t.numel() for p in self.params for t in p.values())

    # ---------------------------------------------------------------- forward
    def _forward(self, params, states, x, *, mask=None,
                 carries: Optional[list] = None, collect: bool = False):
        """Inference forward through preprocessors and layers.

        ``carries``: optional per-layer RNN carry list (rnn_time_step);
        layers with ``supports_carry`` then run ``scan`` from their carry.
        Returns (output, per-layer activations if ``collect``, new
        carries)."""
        acts: List[Tensor] = []
        new_carries: list = [None] * len(self.layers)
        cur_mask = mask
        in_types = self.conf.input_types
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                it = in_types[i] if in_types else None
                h = self.conf.preprocessors[i].transform(h, it)
                cur_mask = self.conf.preprocessors[i].transform_mask(
                    cur_mask, it)
            if carries is not None and getattr(layer, "supports_carry",
                                               False):
                c_in = carries[i]
                if c_in is None:
                    c_in = layer.initial_carry(h.shape[0], h.dtype, h.device)
                h, new_carries[i] = layer.scan(params[i], h, c_in, cur_mask)
            else:
                head = i == last and hasattr(layer, "loss")
                h, _ = layer.apply(params[i], h, state=states[i],
                                   mask=None if head else cur_mask)
            # layers that consume or rearrange the time axis drop the mask
            cur_mask = layer.propagate_mask(cur_mask)
            if collect:
                acts.append(h)
        return h, acts, new_carries

    def _to_tensor(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def feed_forward(self, x) -> List[Tensor]:
        """All layer activations (ref: MultiLayerNetwork.feedForward)."""
        self._check_init()
        with torch.no_grad():
            _, acts, _ = self._forward(self.params, self.states,
                                       self._to_tensor(x), collect=True)
        return acts

    def output(self, x, mask=None) -> Tensor:
        """Final network output (ref: MultiLayerNetwork.output). ``mask``:
        a [B, T] feature mask for recurrent input."""
        self._check_init()
        mask = None if mask is None else self._to_tensor(mask)
        with torch.no_grad():
            h, _, _ = self._forward(self.params, self.states,
                                    self._to_tensor(x), mask=mask)
        return h

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (ref: MultiLayerNetwork.predict)."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    # ------------------------------------------------------- rnn statefulness
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, x) -> Tensor:
        """Stateful streaming inference (ref: MultiLayerNetwork.rnnTimeStep
        — keeps the carries between calls). ``x``: [B, T, F], or [B, F]
        for one step (the output is then [B, n_out])."""
        self._check_init()
        x = self._to_tensor(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = [
                layer.initial_carry(x.shape[0], x.dtype, x.device)
                if getattr(layer, "supports_carry", False) else None
                for layer in self.layers]
        with torch.no_grad():
            h, _, new_carries = self._forward(
                self.params, self.states, x, carries=self._rnn_carries)
        # keep existing carries for non-RNN layers
        self._rnn_carries = [nc if nc is not None else oc
                             for nc, oc in zip(new_carries, self._rnn_carries)]
        return h[:, 0] if squeeze else h
