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

At world > 1 the step is the JAX package's one SPMD step over the global
batch in three more ways. Batch norm takes its statistics over the global
batch (the loss runs under ``netcommon.global_batch_stats`` with the
step's ``mesh.GlobalBatch``, the mesh's differentiable sum), so its
running states come out equal on every rank and are not averaged after
the step. An ``MoELayer`` takes its capacity, its tokens' positions in
the experts' buffers and its balancing loss over the global microbatch
through the same seam (``parallel/expert.py``), on every mode: the
replicated one, zero1, zero2, accumulation and an sp axis. And each rank draws its
dropout masks from a stream of its own, derived from the net's stream,
its rank and the step (``netcommon.derived_stream``): no two ranks draw
the same mask for their rows, and the net's own generator, which the
checkpoint cursor records with the derived seeds, stays as it was, so a
resumed run draws what the uninterrupted one would. The JAX masks are
bits of a JAX PRNG: the port holds their structure, not their bits. At
world 1 the step is the net's own ``fit_batch`` bit for bit.

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

On a mesh with a ``model`` or ``sp`` axis (``MeshContext.create(n_model=,
n_seq=)``; ROADMAP A6.2a) the step is the JAX trainer's GSPMD step
written out per rank (``parallel/tensor.py``). While the trainer is
attached, each leaf ``param_spec`` shards over 'model' holds this rank's
columns, and its updater moments too (``gather_params`` puts the whole
tensors back; ``output`` / ``score`` / the zip serializer refuse a net
holding columns). The rows are cut by the data index and, on an sp axis,
a batch whose T divides the axis by the sp index too. Each microbatch's
loss and gradient run inside ``mesh.sequence_parallel_scope``; the
gradients (column shards as they are) are all-reduced over the data x sp
group and divided by the data axis' width, so the model ranks of a
replica reduce nothing; the sentinel's flag is taken over the model ranks
too, and the norm-based gradient normalizations sum a column shard's
squares over the model axis. Batch norm sums over the data x sp group,
and the dropout stream is the replica's (data and sp index): the model
ranks of a replica draw the same masks. ZeRO composes with an sp axis
(the gradient summed over it first, then reduce-scattered over the data
axis), not with a model axis, as in the JAX package.

The port's trainer updates the net's tensors in place, so
``donate_params`` changes nothing. ``tuned=`` (an
``autotune.TunedConfig``) fills the mesh and the knobs left at their
defaults, as in the JAX package. ``step_program`` / ``shardcheck`` analyse the JAX step's
compiled program (``analysis/shardcheck``) and are not ported.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator,
)
from deeplearning4j_tpu_torch.nn.netcommon import (
    ScanFitMixin, check_trainable, derived_stream, emit_scan_burst,
    global_batch_stats, value_and_grad,
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
    GlobalBatch, MeshContext, WeightUpdateSharding, sequence_parallel_scope,
    take_rows, take_steps,
)
from deeplearning4j_tpu_torch.parallel.tensor import ModelShards
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience.sentinel import (
    guarded_in_place, nonfinite_flag,
)


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


def check_data_mesh(mesh: MeshContext, who: str) -> None:
    """Refuse a mesh with a model, sp, pp or ep axis: ``who`` trains
    data-parallel only, as the JAX package's does."""
    if mesh.n_model > 1 or mesh.n_seq > 1:
        raise ValueError(
            f"{who} trains data-parallel only; this mesh has n_model="
            f"{mesh.n_model}, n_seq={mesh.n_seq} (use ParallelTrainer)")
    check_no_pipe_or_expert(mesh, who)


def check_no_pipe_or_expert(mesh: MeshContext, who: str) -> None:
    """Refuse a mesh with a 'pp' or 'ep' axis: the pipeline trainers
    train over 'pp', and 'ep' shards ``parallel/expert.moe_ffn``."""
    if mesh.n_pipe > 1 or mesh.n_expert > 1:
        raise ValueError(
            f"{who} does not train over a pipeline or expert axis; this "
            f"mesh has n_pipe={mesh.n_pipe}, n_expert={mesh.n_expert} "
            "(use PipelineTrainer / GraphPipelineTrainer for 'pp')")


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
    zip serializer or a replicated trainer. On a model axis the net's
    sharded leaves hold this rank's columns while the trainer is attached;
    call :meth:`gather_params` on every rank before ``output``, ``score``
    or the zip serializer."""

    def __init__(self, net, mesh: Optional[MeshContext] = None,
                 gradient_accumulation: int = 1,
                 donate_params: bool = True,
                 collect_training_stats: bool = False,
                 weight_update_sharding=None,
                 precision=None,
                 tuned=None, device=None):
        if tuned is not None:
            # the autotuner's configuration (autotune.TunedConfig): its
            # mesh when none is given, and each knob left at its default;
            # explicit arguments win
            if mesh is None:
                mesh = tuned.mesh_context(
                    device=device if device is not None else net.device)
            if gradient_accumulation == 1:
                gradient_accumulation = tuned.gradient_accumulation
            if weight_update_sharding is None:
                weight_update_sharding = tuned.weight_update_sharding
            if precision is None:
                precision = tuned.precision
        net._check_init()
        self.net = net
        self.mesh = mesh if mesh is not None else MeshContext.create(
            device=device)
        check_mesh_device(net, self.mesh)
        check_no_pipe_or_expert(self.mesh, "ParallelTrainer")
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
        self._stream = None
        if self.mesh.n_replicas > 1:
            # this replica's dropout stream (the model ranks of a replica
            # share it: they compute the same activations); the cursor
            # records every replica's
            self._stream = torch.Generator(device=net.device)
            net._rank_streams = self.mesh.n_replicas
        self._sharded = False
        self._opt_template = None
        self._layout: Optional[ZeroLayout] = None
        self._anchor: Optional[torch.Tensor] = None
        if self.weight_update_sharding.enabled:
            self._shard_opt_state()
        self._model_sharded = False
        if self.mesh.n_model > 1:
            self._shard_model()

    # -------------------------------------------------------- the ZeRO layout
    def _shard_opt_state(self) -> None:
        net, mesh = self.net, self.mesh
        net.opt_state, self._opt_template = shard_updater_state(
            net.opt_state, mesh)
        self._layout = ZeroLayout(net.params, mesh.n_data, mesh.data_index)
        # the sharded checkpoint reads the moments as rows of (dp, chunk)
        net._zero_shards = (mesh.data_index, mesh.n_data)
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

    # ------------------------------------------------------ the model axis
    def _param_keys(self) -> list:
        params = self.net.params
        return list(range(len(params))) if isinstance(params, list) \
            else list(params)

    def _shard_model(self) -> None:
        """Cut every leaf ``mesh.param_spec`` shards over 'model' (and its
        updater moments) to this rank's columns."""
        net, mesh = self.net, self.mesh
        if getattr(net, "_model_shards", None) is not None:
            raise ValueError(
                "the net already holds column shards of another trainer; "
                "call its gather_params() first")
        spec = {k: {n: bool(mesh.param_spec(n, tuple(t.shape)))
                    for n, t in net.params[k].items()}
                for k in self._param_keys()}
        slots = [s for s in net.opt_state if s != "count"]
        with torch.no_grad():
            for k, names in spec.items():
                for n, sharded in names.items():
                    if not sharded:
                        continue
                    net.params[k][n] = mesh.model_columns(net.params[k][n])
                    for slot in slots:
                        net.opt_state[slot][k][n] = mesh.model_columns(
                            net.opt_state[slot][k][n])
        d, m, s = mesh.coords
        net._model_shards = ModelShards(m, mesh.n_model, spec,
                                        writer=d == 0 and s == 0)
        self._model_sharded = True

    def gather_params(self):
        """Put the whole tensors of every model-sharded leaf (and its
        updater moments) back on the net (a collective: every rank calls
        it) and return ``net.params``, for ``output``, ``score`` and the
        zip serializer. A no-op without a model axis; the next
        ``fit_batch`` shards again."""
        net, mesh = self.net, self.mesh
        shards = getattr(net, "_model_shards", None)
        if not self._model_sharded or shards is None:
            return net.params
        slots = [s for s in net.opt_state if s != "count"]
        with torch.no_grad():
            for k, names in shards.spec.items():
                for n, sharded in names.items():
                    if not sharded:
                        continue
                    net.params[k][n] = mesh.gather_model(net.params[k][n])
                    for slot in slots:
                        net.opt_state[slot][k][n] = mesh.gather_model(
                            net.opt_state[slot][k][n])
        net._model_shards = None
        self._model_sharded = False
        return net.params

    # --------------------------------------------------------------- batches
    def _micro_batches(self, batch, tbptt: bool = False) -> list:
        """(this rank's part, split on T) of each microbatch of the
        global ``batch``: the rows of its data index and, on an sp axis,
        its time steps of a batch whose T divides the axis (not under
        tBPTT, whose windows cut the whole sequence)."""
        mesh = self.mesh
        k, n_data, d = (self.gradient_accumulation, mesh.n_data,
                        mesh.data_index)
        B = batch.num_examples()
        if B % k:
            raise ValueError(f"batch size {B} not divisible by "
                             f"gradient_accumulation={k}")
        mb = B // k
        if mb % n_data:
            raise ValueError(
                f"microbatch of {mb} rows not divisible by the "
                f"{n_data}-way data axis")
        if k == 1 and n_data == 1:
            micro = [batch]
        else:
            per = mb // n_data
            micro = [take_rows(batch, slice(i * mb + d * per,
                                            i * mb + (d + 1) * per))
                     for i in range(k)]
        T = None if tbptt else mesh.seq_length(batch)
        if T is None:
            return [(m, False) for m in micro]
        return [(take_steps(m, T, mesh.seq_slice(T)), True) for m in micro]

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
        """This microbatch's gradient summed over the data x sp ranks (the
        model ranks of a replica hold the same replicated gradients and
        each its own columns) and divided by the data axis' width: one
        flat buffer (replicated mode) or this rank's row (ZeRO; on an sp
        axis summed over it first)."""
        mesh = self.mesh
        if not self._sharded:
            flat = torch.cat([g.reshape(-1) for g in tree_leaves(grads)])
            return mesh.all_reduce_(flat, axis="replicas").div_(mesh.n_data)
        if self.weight_update_sharding.zero2:
            packed = self._layout.pack(grads)
        else:
            if self._anchor is None:
                self._anchor = torch.empty(
                    mesh.n_data, self._layout.row,
                    dtype=tree_leaves(grads)[0].dtype, device=mesh.device)
            packed = self._layout.pack(grads, out=self._anchor)
        packed = mesh.all_reduce_(packed, axis="sp")
        return mesh.reduce_scatter(packed.view(-1)).div_(mesh.n_data)

    def _flag(self, loss, acc) -> torch.Tensor:
        """The step's non-finite flag, the same on every rank: ``loss`` is
        all-reduced and so is ``acc`` in replicated mode; under ZeRO the
        rows' sums of squares are."""
        if not self._sharded:
            flag = nonfinite_flag(loss, unflatten(acc, self.net.params))
            if self.mesh.n_model > 1:
                # a model rank sees its own columns: any rank's flag counts
                flag = self.mesh.any_flag(flag, "model")
            return flag
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

        shards = getattr(net, "_model_shards", None)
        model = None if shards is None else (self.mesh,
                                             shards.mirror(net.params))

        def update():
            compute_updates(net._tx, unflatten(acc, net.params),
                            net.opt_state, net.params, self._layers,
                            training, model=model)
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
        loss = self.mesh.all_reduce_(total.reshape(1), axis="replicas") \
            .reshape(()).div(self.mesh.n_data)
        if k > 1:
            loss = loss / k
        return loss, self._apply(acc, loss)

    def _settle_states(self, bad, new_states) -> None:
        """The step's layer states, guarded under a sentinel. They need no
        average over the ranks: batch norm's running statistics and an MoE
        layer's balancing loss are taken over the global batch, equal on
        every rank."""
        self.net.states = self.net._guard_tree(bad, self.net.states,
                                               new_states)

    def _standard_step(self, micro):
        """One update on the microbatches' whole sequences."""
        net = self.net
        states, acc, total = net.states, None, None
        for (f, l, fm, lm), split in micro:
            with sequence_parallel_scope(self.mesh, seq_split=split):
                loss, aux, grads = self._value_and_grad(
                    lambda p, s=states: net._loss_fn(
                        p, s, f, l, fm, lm, rng=net._rng, train=True))
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
        micro = [m for m, _ in micro]
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
                with sequence_parallel_scope(self.mesh, seq_split=False):
                    loss, (states, nc), grads = self._value_and_grad(
                        lambda p, c=carries[i]: net._tbptt_loss(p, *window,
                                                                c))
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

    @contextlib.contextmanager
    def _rank_step(self):
        """With more than one replica (data x sp ranks): batch norm over
        the global batch, dropout from this replica's stream (the model
        ranks of a replica draw the same masks). With one: the net's own
        step."""
        if self._stream is None:
            yield
            return
        with global_batch_stats(self.net, GlobalBatch(self.mesh)), \
                derived_stream(self.net, self.mesh.replica_index,
                               self._stream):
            yield

    # -------------------------------------------------------------------- fit
    def _train(self, batch):
        """Shard ``batch`` and run its step (no bookkeeping). Returns
        (loss, bad flag or None, whether it ran tBPTT windows)."""
        net = self.net
        check_trainable(net.conf.training)
        if self.weight_update_sharding.enabled and not self._sharded:
            # a gather_opt_state() between fits: shard again
            self._shard_opt_state()
        if self.mesh.n_model > 1 and not self._model_sharded:
            self._shard_model()     # a gather_params() between fits
        stats = self.training_stats
        tracer = get_tracer()
        tbptt = self._tbptt(batch)
        with tracer.span("shard"):
            t0 = time.perf_counter()
            micro = [(self._to_device(rows), split) for rows, split
                     in self._micro_batches(batch, tbptt)]
            if stats:
                self._sync()
                stats.record("shard", time.perf_counter() - t0)
        with tracer.span("step"), self._rank_step():
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
