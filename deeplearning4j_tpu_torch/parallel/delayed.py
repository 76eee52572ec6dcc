"""Delayed-synchronization data parallelism (the JAX package's
``parallel/delayed.py``: the parameter-server tier's analog, ref:
ParameterServerParallelWrapper.java:289-345).

Params stay replicated. Each rank is one worker: its gradient of its rows
of the global batch, at the params of the last sync, accumulates into a
local buffer with no collective. Every ``sync_frequency`` steps the
buffers are all-reduced (the one param-sized collective), divided by the
workers and the steps, and one update is applied; the updater state
advances only then. The layer states' floats and the loss are averaged
over the ranks every step (one small all-reduce).

A net that trains by truncated BPTT takes one step per time window, the
rank's rows carrying their recurrent state between windows, as
``ParallelTrainer`` and the net's own ``fit_batch`` step it: so
``sync_frequency`` counts windows, and at 1 this trainer is
``ParallelTrainer``. The JAX trainer steps the whole sequence (ROADMAP C).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator,
)
from deeplearning4j_tpu_torch.nn.netcommon import (
    check_trainable, detach, value_and_grad,
)
from deeplearning4j_tpu_torch.nn.updater import (
    compute_updates, tree_leaves,
)
from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
from deeplearning4j_tpu_torch.parallel.trainer import (
    check_mesh_device, layers_of, unflatten,
)


class DelayedSyncTrainer:
    """k-step delayed-sync data-parallel trainer (MLN or graph); every rank
    calls ``fit_batch`` with the same global batch."""

    def __init__(self, net, mesh: Optional[MeshContext] = None,
                 sync_frequency: int = 4, device=None):
        net._check_init()
        self.net = net
        self.mesh = mesh if mesh is not None else MeshContext.create(
            device=device)
        check_mesh_device(net, self.mesh)
        self.sync_frequency = max(1, int(sync_frequency))
        self.workers = self.mesh.n_data
        self._is_graph = not hasattr(net, "layers")
        self._layers = layers_of(net)
        net.params = self.mesh.shard_params(net.params)
        net.states = self.mesh.shard_params(net.states)
        self._gbuf: Optional[torch.Tensor] = None   # flat, this rank's sum
        self._since_sync = 0

    def fit_batch(self, batch) -> torch.Tensor:
        """One local gradient on this rank's rows (one a time window under
        tBPTT); an update every ``sync_frequency`` of them. Returns the
        loss, averaged over the workers (under tBPTT the mean of the
        windows'), as a device scalar."""
        net = self.net
        check_trainable(net.conf.training)
        rows = self.mesh.local_rows(batch)
        dev = net._split(rows) if self._is_graph else net._batch(rows)
        net.last_batch_size = batch.num_examples()
        net.last_grads = None   # the step collects no gradients
        if not net._tbptt_applies(batch):
            f, l, fm, lm = dev
            loss, aux, grads = value_and_grad(
                lambda p: net._loss_fn(p, net.states, f, l, fm, lm,
                                       rng=net._rng, train=True),
                net.params)
            return self._step(loss, grads,
                              aux if self._is_graph else aux[0])
        fwd = net.conf.training.tbptt_fwd_length
        T = net._tbptt_length(dev)
        carries = net._initial_carries(tree_leaves(dev[1])[0].shape[0],
                                       net.dtype)
        total, windows = 0.0, 0
        for start in range(0, T, fwd):
            window = net._tbptt_windows(dev, start, min(start + fwd, T))
            loss, (states, carries), grads = value_and_grad(
                lambda p, c=carries: net._tbptt_loss(p, *window, c),
                net.params)
            total = total + self._step(loss, grads, states)
            windows += 1
        return total / windows

    def _step(self, loss, grads, new_states) -> torch.Tensor:
        """Add one step's gradient to the buffer, average its loss and
        states over the ranks, update every ``sync_frequency`` steps."""
        net = self.net
        flat = torch.cat([g.reshape(-1) for g in tree_leaves(grads)])
        self._gbuf = flat if self._gbuf is None else self._gbuf.add_(flat)
        new_states = detach(new_states)
        # the loss and the states' floats: one small average every step
        small = [loss.reshape(1)] + [t for t in tree_leaves(new_states)
                                     if t.is_floating_point()]
        self.mesh.mean_(small)
        net.states = new_states
        self._since_sync += 1
        if self._since_sync >= self.sync_frequency:
            self._sync(self._since_sync)
        net.score_value = loss
        net.iteration_count += 1
        net._notify_iteration()
        return loss

    def _sync(self, steps: int) -> None:
        """The one param-sized all-reduce: the mean gradient over the
        workers and the ``steps`` accumulated, one update."""
        net = self.net
        g = self.mesh.all_reduce_(self._gbuf).div_(self.workers).div_(steps)
        compute_updates(net._tx, unflatten(g, net.params), net.opt_state,
                        net.params, self._layers, net.conf.training)
        self._gbuf = None
        self._since_sync = 0

    def fit(self, data: Union[DataSet, DataSetIterator], epochs: int = 1,
            use_async: bool = True) -> "DelayedSyncTrainer":
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self.fit_batch(data)
            return self
        it = (AsyncDataSetIterator(data)
              if use_async and data.async_supported() else data)
        try:
            for _ in range(epochs):
                for b in it:
                    self.fit_batch(b)
                self.net.epoch_count += 1
        finally:
            if it is not data:
                it.close()
        return self

    def flush(self) -> None:
        """Synchronize now (the end-of-training drain; every rank calls
        it): applies whatever gradient is buffered, scaled by the number
        of steps accumulated."""
        if self._since_sync:
            self._sync(self._since_sync)
