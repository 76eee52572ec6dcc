"""ParallelWrapper: the parameter-averaging trainer (the JAX package's
``parallel/wrapper.py``; ref: deeplearning4j-scaleout-parallelwrapper/.../
ParallelWrapper.java:343-466).

N worker replicas each fit their own minibatches; every
``averaging_frequency`` parallel iterations their params (and, with
``average_updaters``, their updater moments; always their layer states'
floats) are replaced by the mean over the workers. The JAX wrapper keeps
the N replicas as one stacked pytree and ``jax.vmap``s the train step
over them. The port's kernels' ``autograd.Function``s have no vmap rule,
so here each rank owns ``workers / world`` replicas (whole nets, on the
rank's device) and steps them in turn, each through its own
``fit_batch`` (truncated BPTT, precision, sentinel guard as the net
trains alone); an average is a local sum over the rank's replicas, one
all-reduce of the sums and a division by ``workers``. ``workers`` must
divide by the world. The replicas are ``replica(w)`` (a global worker
index this rank owns), as the JAX tests read ``_stacked_params[...][w]``.
With more than one worker each replica draws its dropout masks from a
stream of its own, reseeded every parallel iteration from the net's
stream, its global worker index and the step (``netcommon.stream_seed``;
the JAX wrapper splits a key per worker): no two workers draw the same
mask, and the net's generator, which a checkpoint's cursor records, is
left as it was.

``weight_update_sharding="zero1"/"zero2"`` is the JAX wrapper's
placement: each device holds only its own workers' replicas and updater
state, which is how the port always lays them out; it validates the mesh
as the JAX wrapper does. After ``fit_batch`` / ``fit`` the wrapped net
takes global worker 0's state (broadcast from rank 0), as the reference
copies the averaged params into the source model. For the synchronous
mode use ``ParallelTrainer`` (``averaging_frequency=1`` with lower
variance).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Union

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator, ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.netcommon import stream_seed
from deeplearning4j_tpu_torch.nn.updater import (
    PrecisionPolicy, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    MeshContext, WeightUpdateSharding, copy_flat_into,
)
from deeplearning4j_tpu_torch.parallel.trainer import (
    check_data_mesh, check_mesh_device,
)
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer


def _moments(opt_state) -> List[torch.Tensor]:
    """An updater state's float moments (the counts stay per worker, as
    the JAX wrapper's integer leaves do)."""
    return [t for k, v in opt_state.items() if k != "count"
            for t in tree_leaves(v)]


def _floats(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if t.is_floating_point()]


class _FlagCollector:
    """Stands in for a replica's sentinel: its steps are guarded, and the
    wrapper hands their flags to the net's sentinel once a parallel
    iteration (any worker's flag, any rank's)."""

    def __init__(self):
        self.flags: List[torch.Tensor] = []

    def observe(self, flag, step: int) -> None:
        self.flags.append(flag)


class ParallelWrapper:
    """Parameter averaging over ``workers`` replicas, ``workers / world``
    of them on each rank."""

    def __init__(self, net, workers: Optional[int] = None,
                 prefetch_buffer: int = 16, averaging_frequency: int = 1,
                 average_updaters: bool = True,
                 mesh: Optional[MeshContext] = None,
                 report_score_after_averaging: bool = True,
                 weight_update_sharding=None,
                 precision=None,
                 tuned=None, device=None):
        if tuned is not None:
            # the autotuner's configuration: its mesh, its dp width as the
            # workers, its accumulation as the averaging frequency, its
            # sharding and precision, each where left at its default
            if mesh is None:
                mesh = tuned.mesh_context(
                    device=device if device is not None else net.device)
            if workers is None:
                workers = tuned.dp
            if averaging_frequency == 1:
                averaging_frequency = tuned.gradient_accumulation
            if weight_update_sharding is None:
                weight_update_sharding = tuned.weight_update_sharding
            if precision is None:
                precision = tuned.precision
        net._check_init()
        self.net = net
        self.mesh = mesh if mesh is not None else MeshContext.create(
            device=device)
        check_mesh_device(net, self.mesh)
        check_data_mesh(self.mesh, "ParallelWrapper")
        self.workers = int(workers or self.mesh.n_data)
        self.prefetch_buffer = prefetch_buffer
        self.averaging_frequency = max(1, averaging_frequency)
        self.average_updaters = average_updaters
        self.report_score_after_averaging = report_score_after_averaging
        self.weight_update_sharding = WeightUpdateSharding.parse(
            weight_update_sharding)
        self.mesh.validate_weight_update_sharding(
            self.weight_update_sharding)
        world = self.mesh.world
        if self.workers % world:
            raise ValueError(
                f"{self.workers} workers cannot shard evenly over the "
                f"{world}-way {self.mesh.data_axis!r} axis")
        training = net.conf.training
        self.precision = PrecisionPolicy.parse(
            precision if precision is not None else training.precision,
            loss_scale=training.loss_scale)
        self._local = self.workers // world
        self._first = self.mesh.rank * self._local
        self._replicas = [self._twin(net) for _ in range(self._local)]
        net._rank_streams = self.workers if self.workers > 1 else None
        self._iter_since_avg = 0
        self._collector: Optional[_FlagCollector] = None

    # --------------------------------------------------------------- replicas
    def _twin(self, net):
        """A replica of ``net``: its own copies of the params, layer
        states and updater state, the net's step count and generator
        state, and the wrapper's precision."""
        conf = net.conf
        if PrecisionPolicy.of(conf.training) != self.precision:
            conf = copy.deepcopy(conf)
            conf.training.precision = self.precision.compute_dtype
            conf.training.loss_scale = self.precision.loss_scale
        twin = type(net)(conf, device=net.device)
        twin.init(params=tree_map(lambda t: t.detach().clone(), net.params),
                  states=tree_map(lambda t: t.detach().clone(),
                                  net.states))
        twin.opt_state = tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            net.opt_state)
        twin.iteration_count = net.iteration_count
        twin._rng.set_state(net._rng.get_state())
        return twin

    def replica(self, worker: int):
        """The replica of global worker ``worker`` (one this rank owns)."""
        j = worker - self._first
        if not 0 <= j < self._local:
            raise IndexError(f"worker {worker} lives on another rank "
                             f"(this one owns {self._first}.."
                             f"{self._first + self._local - 1})")
        return self._replicas[j]

    def _attach_sentinels(self) -> None:
        """Guard the replicas' steps while the net has a sentinel."""
        if self.net._sentinel is None:
            self._collector = None
            for r in self._replicas:
                r._sentinel = None
            return
        if self._collector is None:
            self._collector = _FlagCollector()
            for r in self._replicas:
                r._sentinel = self._collector

    # ---------------------------------------------------------------- the step
    def _average(self) -> None:
        """Every replica's params (and moments, and the states' floats)
        replaced by the mean over all workers: one all-reduce of the local
        sums."""
        def groups(r):
            out = [tree_leaves(r.params), _floats(r.states)]
            if self.average_updaters:
                out.append(_moments(r.opt_state))
            return [t for g in out for t in g]

        per_replica = [groups(r) for r in self._replicas]
        flat = torch.cat([t.reshape(-1).float() for t in per_replica[0]])
        for tensors in per_replica[1:]:
            flat.add_(torch.cat([t.reshape(-1).float() for t in tensors]))
        self.mesh.all_reduce_(flat).div_(self.workers)
        for tensors in per_replica:
            copy_flat_into(flat, tensors)

    def _parallel_iteration(self, batches: List[DataSet]) -> None:
        """One parallel iteration: global worker w fits ``batches[w]``."""
        net = self.net
        self._attach_sentinels()
        with get_tracer().span("parallel_iteration", workers=self.workers):
            if self.workers > 1:
                for j, r in enumerate(self._replicas):
                    r._rng.manual_seed(stream_seed(
                        net, self._first + j, net.iteration_count))
            losses = [r.fit_batch(batches[self._first + j])
                      for j, r in enumerate(self._replicas)]
            self._iter_since_avg += 1
            if self._iter_since_avg >= self.averaging_frequency:
                self._average()
                self._iter_since_avg = 0
            score = torch.stack([l.float() for l in losses]).sum()
            self.mesh.all_reduce_(score.reshape(1))
        net.iteration_count += 1
        if self._collector is not None:
            flags = self._collector.flags
            self._collector.flags = []
            net._observe_sentinel(self.mesh.any_flag(
                torch.stack(flags).any()) if flags else None)
        net.last_grads = None
        net.score_value = float(score) / self.workers
        net.last_batch_size = sum(b.num_examples() for b in batches)
        with get_tracer().span("listener"):
            net._notify_iteration()

    def _sync_to_net(self) -> None:
        """The wrapped net takes global worker 0's params, layer states
        and updater state (rank 0's first replica, broadcast)."""
        src, net = self._replicas[0], self.net
        pairs = list(zip(tree_leaves(src.params), tree_leaves(net.params)))
        pairs += list(zip(tree_leaves(src.states), tree_leaves(net.states)))
        pairs += list(zip(_moments(src.opt_state), _moments(net.opt_state)))
        floats = [(s, d) for s, d in pairs if d.is_floating_point()]
        if self.mesh.world == 1:
            with torch.no_grad():
                for s, d in floats:
                    d.copy_(s)
        else:
            flat = torch.cat([s.reshape(-1).float() for s, _ in floats])
            self.mesh.broadcast_(flat, src=0)
            copy_flat_into(flat, [d for _, d in floats])
        count = src.opt_state["count"]
        net.opt_state["count"] = (count.clone() if isinstance(
            count, torch.Tensor) else count)

    # ------------------------------------------------------------------- fit
    def fit_batch(self, batch: DataSet) -> float:
        """One parallel iteration on one global minibatch split evenly over
        the workers (the per-batch seam FaultTolerantTrainer drives), then
        the net takes worker 0's state so a checkpoint sees current
        weights. A batch that does not divide by ``workers`` is refused."""
        n = batch.num_examples()
        if n % self.workers:
            raise ValueError(
                f"global batch of {n} examples not divisible by "
                f"workers={self.workers}")
        self._parallel_iteration(batch.batch_by(n // self.workers))
        self._sync_to_net()
        return self.net.score_value

    def fit(self, iterator: Union[DataSetIterator, DataSet],
            epochs: int = 1) -> "ParallelWrapper":
        """Round-robin dispatch of minibatches to the workers, averaging
        every ``averaging_frequency`` parallel iterations (ref:
        fit():343-466). A short last dispatch reuses its last batch."""
        if isinstance(iterator, DataSet):
            iterator = ListDataSetIterator(iterator.batch_by(
                max(1, iterator.num_examples() // self.workers)))
        it = (AsyncDataSetIterator(iterator, queue_size=self.prefetch_buffer)
              if iterator.async_supported() else iterator)
        try:
            for _ in range(epochs):
                pending: List[DataSet] = []
                for batch in it:
                    pending.append(batch)
                    if len(pending) < self.workers:
                        continue
                    self._parallel_iteration(pending)
                    pending = []
                if pending:
                    while len(pending) < self.workers:
                        pending.append(pending[-1])
                    self._parallel_iteration(pending)
                self.net.epoch_count += 1
        finally:
            if it is not iterator:
                it.close()
        self._sync_to_net()
        return self
