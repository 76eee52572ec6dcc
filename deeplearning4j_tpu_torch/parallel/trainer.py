"""The synchronous data-parallel trainer (the JAX package's
``parallel/trainer.py``), one rank per process over ``torch.distributed``.

The JAX trainer is one jitted SPMD step whose batch is sharded over the
mesh's ``data`` axis, XLA inserting the gradient all-reduce. Here every
rank runs the same step on its rows of the global batch (``MeshContext.
local_rows``), and the trainer issues the collectives itself:

- ``weight_update_sharding="off"``: the gradients are concatenated into
  one flat buffer and all-reduced; every rank applies the same update
  (``nn/updater.compute_updates``, in place).
- ``"zero1"``: the gradients are packed into a persistent ``(dp, row)``
  buffer (the replicated-size anchor) and ``reduce_scatter_tensor``
  turns it into this rank's row; the update runs on the row
  (``nn/updater.compute_updates_sharded``) and ``all_gather_into_tensor``
  of the updated rows rebuilds every param.
- ``"zero2"``: the same, with a transient packed buffer: from the
  reduce-scatter on the gradient exists only as this rank's row.

``gradient_accumulation=k`` splits the global batch into k microbatches
(microbatch i is rows [i*B/k, (i+1)*B/k), each cut over the ranks as the
JAX step shards it), reduces each microbatch's gradient (into the row
under ZeRO) right after its backward and adds it to one accumulator, so
one full-size gradient lives at a time, then takes one update with the
mean: the
reduction order is the same in every mode, so fp32 zero1 and zero2
trajectories equal the replicated ones bit for bit at world 2.

A net that trains by truncated BPTT (``char_rnn_lstm``) takes one
synchronized update per time window, as its own ``fit_batch`` does, each
microbatch keeping its carries; the JAX trainer instead takes one update
over the whole sequence (it calls the net's ``_loss_fn``), so the two
agree where a batch is one window (ROADMAP C).

``precision`` (a ``PrecisionPolicy``, a preset name like ``"bf16"``, or
None for the net's own) casts the params and float features to the
compute dtype at the step boundary, with f32 gradients, loss and masters
(``nn/updater.precision_value_and_grad``). Under a divergence sentinel the
step's non-finite flag is read from what every rank already holds after
the reduction (the all-reduced loss and gradient; under ZeRO the
all-reduced sum of the rows' squares), so every rank skips the same
step. ``collect_training_stats`` records the
``shard`` / ``step`` / ``listener`` / ``data_wait`` phases, synchronizing
the card each step.

The port's trainer updates the net's tensors in place, so
``donate_params`` changes nothing. ``tuned=`` waits for the autotuner
(ROADMAP A7.4). ``step_program`` / ``shardcheck`` analyse the JAX step's
compiled program (``analysis/shardcheck``) and are not ported.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator,
)
from deeplearning4j_tpu_torch.nn.netcommon import (
    ScanFitMixin, check_trainable, detach, emit_scan_burst, value_and_grad,
)
from deeplearning4j_tpu_torch.nn.updater import (
    PrecisionPolicy, Updater, ZeroLayout, cast_floats, compute_updates,
    compute_updates_sharded, gather_updater_state, precision_value_and_grad,
    shard_updater_state, torch_dtype, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.optimize.training_stats import (
    TrainingStats, maybe_phase,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    MeshContext, WeightUpdateSharding, take_rows,
)
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience.sentinel import (
    guarded_in_place, nonfinite_flag,
)


def tuned_not_ported():
    return NotImplementedError(
        "tuned= takes a TunedConfig from the autotuner, which is not "
        "ported yet (ROADMAP A7.4)")


def layers_of(net) -> list:
    """The layer confs aligned with ``net.params`` (a list for a stack, the
    layer nodes' for a graph)."""
    if hasattr(net, "layers"):
        return net.layers
    return [net.conf.nodes[n].layer for n in net._layer_nodes]


def unflatten(flat: torch.Tensor, like):
    """``like``'s structure over consecutive slices of ``flat`` (views, in
    ``tree_leaves`` order)."""
    leaves = tree_leaves(like)
    parts = flat.split([t.numel() for t in leaves])
    index = {id(t): i for i, t in enumerate(leaves)}
    return tree_map(lambda t: parts[index[id(t)]].view(t.shape), like)


def check_mesh_device(net, mesh: MeshContext) -> None:
    if net.device.type != mesh.device.type:
        raise ValueError(
            f"the net lives on {net.device} but the mesh's rank trains on "
            f"{mesh.device}; build both on one device")


class ParallelTrainer:
    """Data-parallel trainer for a MultiLayerNetwork or ComputationGraph.
    Every rank calls ``fit_batch`` with the same global batch. While a
    ZeRO mode is attached, ``net.opt_state`` holds this rank's rows of the
    moments (sharded checkpoints save them as they are); call
    :meth:`gather_opt_state` on every rank before handing the net to the
    zip serializer or a replicated trainer."""

    def __init__(self, net, mesh: Optional[MeshContext] = None,
                 gradient_accumulation: int = 1,
                 donate_params: bool = True,
                 collect_training_stats: bool = False,
                 weight_update_sharding=None,
                 precision=None,
                 tuned=None, device=None):
        if tuned is not None:
            raise tuned_not_ported()
        net._check_init()
        self.net = net
        self.mesh = mesh if mesh is not None else MeshContext.create(
            device=device)
        check_mesh_device(net, self.mesh)
        self.gradient_accumulation = max(1, int(gradient_accumulation))
        self.weight_update_sharding = WeightUpdateSharding.parse(
            weight_update_sharding)
        self.mesh.validate_weight_update_sharding(
            self.weight_update_sharding)
        training = net.conf.training
        self.precision = PrecisionPolicy.parse(
            precision if precision is not None else training.precision,
            loss_scale=training.loss_scale)
        self.training_stats = (TrainingStats()
                               if collect_training_stats else None)
        self._is_graph = not hasattr(net, "layers")
        self._layers = layers_of(net)
        net.params = self.mesh.shard_params(net.params)
        net.states = self.mesh.shard_params(net.states)
        self._sharded = False
        self._opt_template = None
        self._layout: Optional[ZeroLayout] = None
        self._anchor: Optional[torch.Tensor] = None
        if self.weight_update_sharding.enabled:
            self._shard_opt_state()

    # -------------------------------------------------------- the ZeRO layout
    def _shard_opt_state(self) -> None:
        net, mesh = self.net, self.mesh
        net.opt_state, self._opt_template = shard_updater_state(
            net.opt_state, mesh)
        self._layout = ZeroLayout(net.params, mesh.world, mesh.rank)
        # the sharded checkpoint reads the moments as rows of (dp, chunk)
        net._zero_shards = (mesh.rank, mesh.world)
        self._sharded = True

    def gather_opt_state(self):
        """Restore ``net.opt_state`` to whole tensors (a collective: every
        rank calls it) and return it. A no-op in replicated mode; the next
        ``fit_batch`` shards again."""
        if self._sharded:
            self.net.opt_state = gather_updater_state(
                self.net.opt_state, self._opt_template, self.mesh)
            self._opt_template = None
            self._sharded = False
            self.net._zero_shards = None
        return self.net.opt_state

    # --------------------------------------------------------------- batches
    def _micro_rows(self, batch) -> list:
        """This rank's rows of each microbatch of the global ``batch``."""
        k, world, rank = (self.gradient_accumulation, self.mesh.world,
                          self.mesh.rank)
        B = batch.num_examples()
        if B % k:
            raise ValueError(f"batch size {B} not divisible by "
                             f"gradient_accumulation={k}")
        mb = B // k
        if mb % world:
            raise ValueError(
                f"microbatch of {mb} rows not divisible by the {world}-way "
                "data axis")
        if k == 1 and world == 1:
            return [batch]
        per = mb // world
        return [take_rows(batch, slice(i * mb + rank * per,
                                       i * mb + (rank + 1) * per))
                for i in range(k)]

    def _to_device(self, rows):
        """(features, labels, feature mask, label mask) on the card (dicts
        for a graph), features cast to the compute dtype under a mixed
        policy."""
        net = self.net
        f, l, fm, lm = net._split(rows) if self._is_graph else \
            net._batch(rows)
        if self.precision.mixed:
            f = cast_floats(f, self.precision.compute_dtype)
            fm = cast_floats(fm, self.precision.compute_dtype)
        return f, l, fm, lm

    def _sync(self) -> None:
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    # ------------------------------------------------------------ the step
    def _value_and_grad(self, loss_fn):
        """(loss, aux, f32 grads) of ``loss_fn(params)`` under the
        trainer's precision policy."""
        return precision_value_and_grad(loss_fn, self.net.params,
                                        self.precision, value_and_grad)

    def _reduce(self, grads) -> torch.Tensor:
        """This microbatch's gradient summed over the ranks and divided by
        the world: one flat buffer (replicated mode) or this rank's row
        (ZeRO)."""
        mesh = self.mesh
        if not self._sharded:
            flat = torch.cat([g.reshape(-1) for g in tree_leaves(grads)])
            return mesh.all_reduce_(flat).div_(mesh.world)
        if self.weight_update_sharding.zero2:
            packed = self._layout.pack(grads)
        else:
            if self._anchor is None:
                self._anchor = torch.empty(
                    mesh.world, self._layout.row,
                    dtype=tree_leaves(grads)[0].dtype, device=mesh.device)
            packed = self._layout.pack(grads, out=self._anchor)
        return mesh.reduce_scatter(packed.view(-1)).div_(mesh.world)

    def _flag(self, loss, acc) -> torch.Tensor:
        """The step's non-finite flag, the same on every rank: ``loss`` is
        all-reduced and so is ``acc`` in replicated mode; under ZeRO the
        rows' sums of squares are."""
        if not self._sharded:
            return nonfinite_flag(loss, unflatten(acc, self.net.params))
        gsq = self.mesh.all_reduce_((acc.float() ** 2).sum().reshape(1))
        return ~(torch.isfinite(loss) & torch.isfinite(gsq[0]))

    def _apply(self, acc: torch.Tensor, loss):
        """One update from the reduced (mean) gradient ``acc``, guarded
        under a sentinel. Returns the flag, or None."""
        net = self.net
        training = net.conf.training
        bad = None
        if net._sentinel is not None:
            Updater.device_count(net.opt_state, net.device)
            bad = self._flag(loss, acc)
        if self._sharded:
            compute_updates_sharded(
                net._tx, self._layout.views(acc, net.params), net.opt_state,
                net.params, self._layers, training, self.mesh, self._layout,
                bad)
            return bad

        def update():
            compute_updates(net._tx, unflatten(acc, net.params),
                            net.opt_state, net.params, self._layers,
                            training)
        if bad is None:
            update()
        else:
            written = tree_leaves(net.params) + [net.opt_state["count"]] + [
                t for k, v in net.opt_state.items() if k != "count"
                for t in tree_leaves(v)]
            guarded_in_place(bad, written, update)
        return bad

    def _accumulate(self, acc, total, loss, grads):
        """Reduce one microbatch's gradient and add it to ``acc`` (the flat
        buffer, or this rank's row under ZeRO), its loss to ``total``. The
        caller drops ``grads`` before the next microbatch, so one full-size
        gradient lives at a time (under zero2 only the row outlives it)."""
        red = self._reduce(grads)
        acc = red if acc is None else acc.add_(red)
        total = loss if total is None else total + loss
        return acc, total

    def _synced_update(self, acc, total, k: int):
        """One update with the mean of ``k`` accumulated microbatches.
        Returns (loss over the ranks and microbatches, bad flag)."""
        if k > 1:
            acc.div_(k)
        loss = self.mesh.all_reduce_(total.reshape(1)).reshape(()) \
            .div(self.mesh.world)
        if k > 1:
            loss = loss / k
        return loss, self._apply(acc, loss)

    def _settle_states(self, bad, new_states) -> None:
        """The step's layer states, their floats averaged over the ranks,
        guarded under a sentinel."""
        new_states = detach(new_states)
        if self.mesh.world > 1:
            self.mesh.mean_(tree_leaves(new_states))
        self.net.states = self.net._guard_tree(bad, self.net.states,
                                               new_states)

    def _standard_step(self, micro):
        """One update on the microbatches' whole sequences."""
        net = self.net
        states, acc, total = net.states, None, None
        for f, l, fm, lm in micro:
            loss, aux, grads = self._value_and_grad(
                lambda p, s=states: net._loss_fn(p, s, f, l, fm, lm,
                                                 rng=net._rng, train=True))
            states = aux if self._is_graph else aux[0]
            acc, total = self._accumulate(acc, total, loss, grads)
            del grads
        loss, bad = self._synced_update(acc, total, len(micro))
        self._settle_states(bad, states)
        return loss, bad

    def _tbptt_step(self, micro):
        """One synchronized update per time window, each microbatch
        carrying its own recurrent state between windows (the net's
        ``_fit_tbptt``, across the ranks). Listeners and the sentinel hear
        of each window. Returns the mean of the windows' losses."""
        net = self.net
        fwd = net.conf.training.tbptt_fwd_length
        dt = (torch_dtype(self.precision.compute_dtype)
              if self.precision.mixed else net.dtype)
        T = net._tbptt_length(micro[0])
        carries = [net._initial_carries(
            tree_leaves(m[1])[0].shape[0], dt) for m in micro]
        total, windows = 0.0, 0
        for start in range(0, T, fwd):
            end = min(start + fwd, T)
            old_states, new_carries = net.states, []
            acc = wtotal = None
            for i, m in enumerate(micro):
                window = net._tbptt_windows(m, start, end)
                loss, (states, nc), grads = self._value_and_grad(
                    lambda p, c=carries[i]: net._tbptt_loss(p, *window, c))
                net.states = states   # the next microbatch's _tbptt_loss
                acc, wtotal = self._accumulate(acc, wtotal, loss, grads)
                del grads
                new_carries.append(nc)
            net.states = old_states
            loss, bad = self._synced_update(acc, wtotal, len(micro))
            self._settle_states(bad, states)
            carries = [net._guard_tree(bad, c, nc)
                       for c, nc in zip(carries, new_carries)]
            total = total + loss
            windows += 1
            net.iteration_count += 1
            net.score_value = loss
            net._observe_sentinel(bad)
            net._notify_iteration()
        return total / max(windows, 1)

    def _tbptt(self, batch) -> bool:
        return self.net._tbptt_applies(batch)

    # -------------------------------------------------------------------- fit
    def _train(self, batch):
        """Shard ``batch`` and run its step (no bookkeeping). Returns
        (loss, bad flag or None, whether it ran tBPTT windows)."""
        net = self.net
        check_trainable(net.conf.training)
        if self.weight_update_sharding.enabled and not self._sharded:
            # a gather_opt_state() between fits: shard again
            self._shard_opt_state()
        stats = self.training_stats
        tracer = get_tracer()
        tbptt = self._tbptt(batch)
        with tracer.span("shard"):
            t0 = time.perf_counter()
            micro = [self._to_device(rows)
                     for rows in self._micro_rows(batch)]
            if stats:
                self._sync()
                stats.record("shard", time.perf_counter() - t0)
        with tracer.span("step"):
            t0 = time.perf_counter()
            if tbptt:
                loss, bad = self._tbptt_step(micro), None
            else:
                loss, bad = self._standard_step(micro)
            if stats:
                self._sync()
                stats.record("step", time.perf_counter() - t0)
        return loss, bad, tbptt

    def fit_batch(self, batch):
        """One synchronized step on one global batch (one per time window
        under tBPTT). Returns the loss, the mean over the whole global
        batch, as a device scalar."""
        net = self.net
        loss, bad, tbptt = self._train(batch)
        net.last_batch_size = batch.num_examples()
        net.last_grads = None   # the step collects no gradients
        if tbptt:
            return loss
        net.score_value = loss
        net.iteration_count += 1
        net._observe_sentinel(bad)
        with get_tracer().span("listener"), \
                maybe_phase(self.training_stats, "listener"):
            net._notify_iteration()
        return loss

    def fit(self, data: Union[DataSet, DataSetIterator], epochs: int = 1,
            use_async: bool = True,
            scan_window: int = 1) -> "ParallelTrainer":
        """``scan_window > 1``: see :meth:`fit_batches_scan`. An
        ``AsyncDataSetIterator`` made here is closed on the way out."""
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self.fit_batch(data)
            return self
        it = (AsyncDataSetIterator(data)
              if use_async and data.async_supported() else data)
        stats = self.training_stats
        try:
            for _ in range(epochs):
                src = stats.timed_iter(it) if stats else it
                if scan_window > 1:
                    ScanFitMixin._fit_epoch_scan(self, src, scan_window)
                else:
                    for batch in src:
                        self.fit_batch(batch)
                self.net.epoch_count += 1
        finally:
            if it is not data:
                it.close()
        return self

    def fit_batches_scan(self, batches):
        """The batches' steps back to back, their losses kept on the card
        and read once in a listener burst (the JAX package's scanned
        window; here the steps ``fit_batch`` runs). Masked, ragged, tBPTT
        or graph windows, and a net under a sentinel, train per batch."""
        net = self.net
        batches = list(batches)
        if not batches:
            return np.zeros((0,), np.float32)
        scannable = (
            not self._is_graph
            and net._sentinel is None
            and all(isinstance(b, DataSet)
                    and b.features_mask is None and b.labels_mask is None
                    and not self._tbptt(b) for b in batches)
            and len({(np.shape(b.features), np.shape(b.labels))
                     for b in batches}) == 1)
        if not scannable:
            return np.asarray([float(self.fit_batch(b))
                               for b in batches], np.float32)
        t0 = time.perf_counter()
        losses = torch.stack([self._train(b)[0] for b in batches])
        net.last_batch_size = batches[-1].num_examples()
        net.last_grads = None
        if net.listeners:
            emit_scan_burst(net, losses, len(batches), t0)
        else:
            net.iteration_count += len(batches)
        net.score_value = losses[-1]
        return losses
