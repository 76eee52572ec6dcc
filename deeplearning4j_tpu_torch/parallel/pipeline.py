"""Pipeline parallelism: the GPipe microbatch schedule over a mesh's 'pp'
axis (the JAX package's ``parallel/pipeline.py``), one process a stage.

The JAX package runs every stage in one SPMD program: the stage programs
are branches of a ``lax.switch``, activations and params travel as
right-padded flat buffers and a ``ppermute`` ring hands each tick's
activation on. Here each rank is a process that runs its own stage: it
holds that stage's params and updater state only, and hands its
activations to the next stage through the mesh's differentiable
point-to-point pair (``MeshContext.send_stage`` / ``recv_stage``), whose
backward sends each gradient back. Two tiers, as in the JAX package:

- ``pipeline_apply``: the homogeneous primitive (every stage maps
  ``[B_mb, ...]`` to the same shape); its result reaches every rank.
- ``PipelineTrainer`` (a ``MultiLayerNetwork``) and
  ``GraphPipelineTrainer`` (a ``ComputationGraph``): the net's body cut
  into S contiguous stages. A step runs each stage on microbatches
  0 .. M-1 in order, keeping each microbatch's autograd graph, then the
  last stage computes the head's loss once over the M microbatches'
  rows and the stages run their backwards in reverse microbatch order.
  Each rank then updates its own stage (``nn/updater.compute_updates``
  on the stage's part of the net). The loss comes back on every rank.

What the JAX pipeline's step does, the stages do:

- the L1/L2 penalty is each stage's own layers', summed over the stages;
- batch norm normalizes each microbatch by its own statistics and its
  running averages run through the microbatches in order; with a data
  axis (``MeshContext.create(n_pipe=, n_data=)``: rank = d * n_pipe + p)
  each microbatch's rows are cut over it, the gradients are averaged
  over it, and the running averages are averaged over it after the step;
- dropout draws from a stream of this rank's (its stage and data index:
  ``netcommon.derived_stream``), so masks differ per stage, microbatch
  and data shard and a seed repeats them; the JAX masks are bits of a JAX
  PRNG, and the port holds their structure, not their bits;
- auxiliary losses (an ``MoELayer``'s balancing term) ride the
  activation to the last stage as one more element, summed stage by
  stage, and the objective takes their mean over the microbatches;
  with M > 1 that is not the whole batch's (a one-time warning says so);
- under truncated BPTT each window is one step, the recurrent layers'
  carries are kept per microbatch, cut from the graph at window edges
  and zero at each batch;
- a divergence sentinel's flag is taken over every stage (and data
  shard), so a bad step skips the update, the states and the carries on
  all of them;
- a norm-based gradient normalization of a graph's tree takes one norm
  over the whole tree: each stage's sum of squares is summed over 'pp'.

The graph's tied head (``TiedRnnOutputLayer``, tied to the embedding of
stage 0 while the head sits on the last stage): each step the tied
stage sends its current ``W`` to the last stage after its microbatches,
the head's loss uses it, and the head's gradient of it comes back into
that stage's gradient of ``W`` before the update.

While a trainer is attached the net holds its stage's params only:
``output``, ``score`` and the zip serializer refuse it until
``gather_params()`` (a collective over 'pp') brings every stage's params,
updater moments and layer states to every rank; the next ``fit_batch``
drops them again.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.graphcheck import graph_cut_points
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    FeedForwardToRnnPreProcessor, RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.netcommon import derived_stream
from deeplearning4j_tpu_torch.nn.updater import (
    Updater, compute_updates, l1_l2_penalty, tree_leaves, tree_map,
)
from deeplearning4j_tpu_torch.optimize.training_stats import TrainingStats
from deeplearning4j_tpu_torch.parallel.mesh import MeshContext, _group_world
from deeplearning4j_tpu_torch.parallel.trainer import check_mesh_device
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.resilience.sentinel import (
    guarded_in_place, nonfinite_flag,
)

Tensor = torch.Tensor
logger = logging.getLogger(__name__)

# one process-wide aux-loss semantics warning (see PipelineTrainer)
_WARNED_AUX_MICROBATCH = False


def _pipe_mesh(mesh: Optional[MeshContext], axis: str, device):
    """The trainer's mesh: ``mesh``, or every rank on 'pp'."""
    if mesh is None:
        mesh = MeshContext.create(n_pipe=_group_world(None)[0],
                                  device=device)
    if axis != "pp":   # the mesh's one pipeline axis
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    return mesh


def pipeline_apply(stage_fn: Callable, stacked_params, x_microbatches,
                   mesh: MeshContext, axis: str = "pp"):
    """Run a homogeneous pipeline.

    stage_fn(params_slice, x) -> y with y.shape == x.shape (homogeneous
    stages). ``stacked_params``: a params container whose tensors carry a
    leading stage axis S == the mesh's 'pp' size (every rank passes the
    whole stack and runs row ``pipe_index``). ``x_microbatches``: [M,
    B_mb, ...], the same on every rank. Returns [M, B_mb, ...], the last
    stage's outputs, on every rank (its gradient reaches each stage's row
    of the stack through the point-to-point pair). The backward posts its
    sends: ``mesh.wait_sends()`` after it."""
    _pipe_mesh(mesh, axis, None)
    S, p = mesh.n_pipe, mesh.pipe_index
    M = x_microbatches.shape[0]
    params = tree_map(lambda a: a[p], stacked_params)
    outs, tokens = [], []
    for m in range(M):
        x = (x_microbatches[m] if p == 0 else mesh.recv_stage(
            x_microbatches.shape[1:], x_microbatches.dtype, p - 1, m))
        y = stage_fn(params, x)
        if p < S - 1:
            tokens.append(mesh.send_stage(y, p + 1, m))
        else:
            outs.append(y)
    mesh.wait_sends()
    if p == S - 1:
        out = torch.stack(outs)
    else:
        # zeros, whose backward reaches the sends' tokens
        out = torch.zeros_like(x_microbatches) + torch.stack(tokens).sum()
    return mesh.sum_value(out, "pp")


def stack_stage_params(param_list):
    """Stack per-stage params containers along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *param_list)


def _reject_remat(conf):
    """A stage runs ``layer.apply`` without recomputation: a remat'd
    config would silently lose its gradient checkpointing (and its
    memory headroom) — fail loudly like the other unsupported
    features."""
    if getattr(conf.training, "remat", False):
        raise ValueError(
            "gradient_checkpointing (remat) is unsupported in the "
            "pipeline trainers — stage branches store activations for "
            "backward; disable remat or train without the pipeline")


# ---------------------------------------------------------------------------
# stage partitioning
# ---------------------------------------------------------------------------

def _optimal_cuts(costs, boundaries, n_stages):
    """Place ``n_stages - 1`` cuts from the candidate ``boundaries``
    (each a (position, activation_elems) pair; position b cuts between
    item b-1 and item b) minimizing

        max_stage(sum costs) + act_weight-scaled max_cut(activation)

    where the caller pre-scales the activation term into the boundary
    values. Exact O(S * n^2) DP — the candidate sets are tiny (layers of
    one network). Returns the chosen cut positions, sorted."""
    n = len(costs)
    ps = [0]
    for c in costs:
        ps.append(ps[-1] + c)

    def seg(a, b):  # cost of items a..b-1
        return ps[b] - ps[a]

    acts = sorted({a for _, a in boundaries})
    best_obj, best_cuts = None, None
    for amax in acts:
        allowed = sorted(p for p, a in boundaries if a <= amax)
        if len(allowed) < n_stages - 1:
            continue
        # dp over (stage count k, last cut position): minimal max stage
        # cost for items[0:pos] split into k stages. This pass finds only
        # the optimal VALUE; the winning amax's DP is re-run below with
        # parent links to recover the actual cut positions.
        INF = float("inf")
        dp = {0: 0.0}  # pos -> best max-cost using k cuts so far
        for _ in range(n_stages - 1):
            nxt = {}
            for pos, m in dp.items():
                for q in allowed:
                    if q <= pos:
                        continue
                    v = max(m, seg(pos, q))
                    if v < nxt.get(q, INF):
                        nxt[q] = v
            dp = nxt
            if not dp:
                break
        if not dp:
            continue
        m = min((max(v, seg(pos, n)), pos) for pos, v in dp.items())
        obj = m[0] + amax
        if best_obj is None or obj < best_obj:
            best_obj, best_cuts = obj, (amax, m[0])
    if best_cuts is None:
        return None
    # re-run the DP for the winning amax, tracking parents, to recover
    # the actual cut positions
    amax = best_cuts[0]
    allowed = sorted(p for p, a in boundaries if a <= amax)
    dp = {0: (0.0, None)}
    layers_dp = [dp]
    for _ in range(n_stages - 1):
        nxt = {}
        for pos, (m, _par) in layers_dp[-1].items():
            for q in allowed:
                if q <= pos:
                    continue
                v = max(m, seg(pos, q))
                if q not in nxt or v < nxt[q][0]:
                    nxt[q] = (v, pos)
        layers_dp.append(nxt)
    end = min(layers_dp[-1].items(),
              key=lambda kv: max(kv[1][0], seg(kv[0], n)))
    cuts = []
    pos = end[0]
    for k in range(n_stages - 1, 0, -1):
        cuts.append(pos)
        pos = layers_dp[k][pos][1]
    return sorted(cuts)


def partition_stages(layers, params, n_stages: int,
                     act_elems: Optional[Sequence[float]] = None,
                     act_weight: float = 1.0) -> List[List[int]]:
    """Split body-layer indices into ``n_stages`` contiguous groups.

    Cost model: exact DP minimizing ``max_stage(param_count) +
    act_weight * max_cut(act_elems)``. ``act_elems[i]`` = activation
    elements per sample crossing the boundary after layer ``i`` (what a
    stage hands the next there); when None the activation term is zero
    and the DP reduces to optimal param-count balance. More stages than
    body layers: the trailing stages are identity pass-throughs."""
    n = len(layers)
    if n_stages > n:
        return ([[i] for i in range(n)]
                + [[] for _ in range(n_stages - n)])
    costs = [sum(int(np.prod(tuple(v.shape))) for v in params[i].values())
             + 1 for i in range(n)]
    if act_elems is None:
        bounds = [(b, 0.0) for b in range(1, n)]
    else:
        bounds = [(b, act_weight * float(act_elems[b - 1]))
                  for b in range(1, n)]
    cuts = _optimal_cuts(costs, bounds, n_stages)
    if cuts is None:  # n_stages == 1
        return [list(range(n))]
    edges = [0] + cuts + [n]
    return [list(range(edges[i], edges[i + 1]))
            for i in range(len(edges) - 1)]


def _type_elems(t) -> int:
    """Per-sample activation elements of an InputType."""
    return int(np.prod(_type_shape(t, 1)))


def _true_layer_shapes(conf, layers, b: int,
                       timesteps: Optional[int] = None) -> List[tuple]:
    """[input_shape, out_of_layer_0, ..., out_of_last] — the TRUE tensor
    shapes flowing between layers. This differs from the InputType walk
    in one place: RnnToFeedForward/FeedForwardToRnn preprocessors are
    no-ops here (the broadcast form keeps [B, T, F] through FF layers),
    so an ff-typed tensor inside such a region still carries the time
    axis. ``timesteps`` overrides the recurrent input length (tBPTT
    windows)."""
    cur = conf.input_type
    if timesteps is not None and cur.kind == "rnn":
        cur = InputType.recurrent(cur.size, timesteps)
    broadcast_t: Optional[int] = None  # live time axis on an ff type

    def true_shape(t, bt):
        if t.kind == "ff" and bt:
            return (b, bt, t.size)
        return _type_shape(t, b)

    shapes = [true_shape(cur, broadcast_t)]
    for i, layer in enumerate(layers):
        if i in conf.preprocessors:
            pre = conf.preprocessors[i]
            if isinstance(pre, RnnToFeedForwardPreProcessor):
                broadcast_t = cur.timesteps
            cur = pre.infer_output_type(cur)
            if (isinstance(pre, FeedForwardToRnnPreProcessor)
                    and cur.timesteps is None and broadcast_t):
                cur = InputType.recurrent(cur.size, broadcast_t)
            if cur.kind != "ff":
                broadcast_t = None
        cur = layer.infer_output_type(cur)
        if cur.kind == "rnn":
            if cur.timesteps is None and broadcast_t:
                cur = InputType.recurrent(cur.size, broadcast_t)
            broadcast_t = None
        shapes.append(true_shape(cur, broadcast_t))
    return shapes


def _mln_boundary_elems(conf, layers) -> List[int]:
    """Per-sample activation elements leaving each body layer (the
    payload if the stage cut lands after that layer)."""
    shapes = _true_layer_shapes(conf, layers, 1)
    return [int(np.prod(s[1:])) for s in shapes[1:]]


def _type_shape(t, batch: int):
    """Concrete activation shape for an InputType at a given batch size."""
    if t.kind == "ff":
        return (batch, t.size)
    if t.kind == "rnn":
        if t.timesteps is None:
            raise ValueError("PipelineTrainer needs fixed timesteps in the "
                             "recurrent InputType (static shapes: each "
                             "stage receives a buffer of a known size)")
        return (batch, t.timesteps, t.size)
    if t.kind == "cnn":
        return (batch, t.height, t.width, t.channels)
    raise ValueError(f"Unsupported InputType kind {t.kind!r}")


def _numel(shape) -> int:
    return int(np.prod(shape))


# ---------------------------------------------------------------------------
# the schedule both trainers run
# ---------------------------------------------------------------------------

class _StageTrainer:
    """``fit_batch`` / ``fit`` / ``gather_params`` shared by the stack and
    graph pipeline trainers; subclasses build the stages and provide the
    stage's forward (``_stage_forward``), the head's loss
    (``_head_loss``), the batch's microbatches (``_microbatches``), the
    payload shapes (``_payload``) and the keys each stage holds
    (``_stage_keys``)."""

    training_stats = None
    _tbptt = False
    _graph = False

    def _setup(self, net, mesh, axis, n_microbatches, collect_training_stats,
               device):
        if collect_training_stats:
            self.training_stats = TrainingStats()
        self.mesh = _pipe_mesh(mesh, axis, device)
        net._check_init()
        check_mesh_device(net, self.mesh)
        _reject_remat(net.conf)
        self.net = net
        self.axis = axis
        self.S = self.mesh.n_pipe
        self.p = self.mesh.pipe_index
        self.dp = self.mesh.n_data
        self.M = int(n_microbatches or self.S)
        self._sharded = False
        self._gen = torch.Generator(device=net.device)

    # ------------------------------------------------------ stage-local net
    def _keys(self) -> list:
        params = self.net.params
        return list(range(len(params))) if isinstance(params, list) \
            else list(params)

    def _own(self) -> set:
        return set(self._stage_keys(self.p))

    def _shard(self) -> None:
        """Drop every other stage's params and updater moments from the
        net (their shapes kept for ``gather_params``)."""
        net = self.net
        if getattr(net, "_pipeline_stage", None) is not None:
            raise ValueError(
                "the net already holds one stage of another pipeline "
                "trainer; call its gather_params() first")
        self._meta = {k: {n: (tuple(t.shape), t.dtype)
                          for n, t in net.params[k].items()}
                      for k in self._keys()}
        own = self._own()
        slots = [s for s in net.opt_state if s != "count"]
        for k in self._keys():
            if k not in own:
                net.params[k] = {}
                for slot in slots:
                    net.opt_state[slot][k] = {}
        net._pipeline_stage = (self.p, self.S)
        self._sharded = True

    def gather_params(self):
        """Every stage's params, updater moments and layer states on every
        rank (a collective over 'pp': every rank calls it), for
        ``output``, ``score`` and the zip serializer; returns
        ``net.params``. The next ``fit_batch`` drops them again."""
        net, mesh = self.net, self.mesh
        if not self._sharded:
            return net.params
        slots = [s for s in net.opt_state if s != "count"]
        with torch.no_grad():
            for s in range(self.S):
                for k in self._stage_keys(s):
                    for n, (shape, dtype) in self._meta[k].items():
                        trees = [net.params] + [net.opt_state[sl]
                                                for sl in slots]
                        for tree in trees:
                            if s != self.p:
                                tree[k][n] = torch.empty(
                                    shape, dtype=dtype, device=net.device)
                            mesh.broadcast_(tree[k][n], s, "pp")
                    for t in net.states[k].values():
                        mesh.broadcast_(t, s, "pp")
        net._pipeline_stage = None
        self._sharded = False
        return net.params

    # -------------------------------------------------------------- batches
    def _rows(self, m: int, b_mb: int, local: bool) -> slice:
        """This rank's rows of microbatch ``m``: its data index's share of
        a global batch, or rows [m * b_mb / dp, (m + 1) * b_mb / dp) of a
        batch marked ``data_ranks`` (this rank's rows already, as
        ``ParallelTrainer`` cuts one)."""
        per = b_mb // self.dp
        if local:
            return slice(m * per, (m + 1) * per)
        d = self.mesh.data_index
        return slice(m * b_mb + d * per, m * b_mb + (d + 1) * per)

    def _global_rows(self, batch) -> int:
        """The rows of the global batch ``batch`` stands for: its own, or
        dp times its own where it is marked ``data_ranks``."""
        B = self._validate(batch)
        return B * self.dp if self.mesh.holds_local_rows(batch) else B

    def _check_rows(self, B: int) -> int:
        if B % self.M != 0:
            raise ValueError(f"batch size {B} not divisible by "
                             f"n_microbatches={self.M}")
        b_mb = B // self.M
        if b_mb % self.dp != 0:
            raise ValueError(
                f"microbatch size {b_mb} (batch {B} / {self.M} "
                f"microbatches) not divisible by the dp axis ({self.dp})")
        return b_mb

    def _stream(self):
        """This rank's dropout stream at world > 1 (its stage and data
        index); the net's own at world 1."""
        if self.mesh.world == 1:
            return contextlib.nullcontext()
        return derived_stream(self.net, self.mesh.rank, self._gen)

    def _sync(self) -> None:
        if self.net.device.type == "cuda":
            torch.cuda.synchronize(self.net.device)

    # ------------------------------------------------------------ the step
    def _pack(self, y: Tensor, aux, numel: int) -> Tensor:
        """The payload to the next stage: ``y`` flat (and the running aux
        sum as one more element)."""
        if y.numel() != numel:
            raise ValueError(
                f"stage {self.p} made {tuple(y.shape)} where the next stage "
                f"takes {numel} elements")
        flat = y.reshape(-1)
        if not self._aux:
            return flat
        return torch.cat([flat, aux.reshape(1).to(flat.dtype)])

    def _unpack(self, buf: Tensor, numel: int):
        return (buf[:numel], buf[numel] if self._aux else None)

    def _step(self, xs, ys, carries, payload):
        """One GPipe step on this rank's microbatches: ``xs`` stage 0's M
        inputs, ``ys`` the last stage's M labels, ``carries`` each
        microbatch's carries (tBPTT) or None, ``payload`` (elements in,
        elements out, the input's shape) of a microbatch. Returns (loss,
        bad flag or None, new carries), the update applied."""
        net, mesh, S, p, M = self.net, self.mesh, self.S, self.p, self.M
        n_in, n_out, in_shape = payload
        P = tree_map(lambda t: t.detach().requires_grad_(), net.params)
        states = net.states
        outs, tokens, new_carries = [], [], []
        with torch.enable_grad(), self._stream():
            rng = net._rng
            for m in range(M):
                aux = None
                if p == 0:
                    x = xs[m]
                else:
                    buf = mesh.recv_stage((n_in + self._aux,), net.dtype,
                                          p - 1, m)
                    flat, aux = self._unpack(buf, n_in)
                    x = flat.view(in_shape)
                y, states, c, aux_here = self._stage_forward(
                    P, x, states, None if carries is None else carries[m],
                    rng)
                new_carries.append(c)
                if self._aux:
                    zero = torch.zeros((), device=net.device)
                    aux = (zero if aux is None else aux) + (
                        zero if aux_here is None else aux_here)
                if p < S - 1:
                    tokens.append(mesh.send_stage(
                        self._pack(y, aux, n_out), p + 1, m))
                else:
                    outs.append((y, aux))
            tie = self._tie_forward(P)
            penalty = l1_l2_penalty(self._param_list(P), self._layer_list())
            if p == S - 1:
                hs = [y.detach().requires_grad_() for y, _ in outs]
                obj = self._head_loss(P, hs, ys, tie) + penalty
                if self._aux:
                    auxs = [a.detach().requires_grad_() for _, a in outs]
                    obj = obj + torch.stack(auxs).mean().to(obj.dtype)
                obj.backward()
                for m in reversed(range(M)):
                    pairs = [(outs[m][0], hs[m].grad)]
                    if self._aux:
                        pairs.append((outs[m][1], auxs[m].grad))
                    pairs = [(r, g) for r, g in pairs if r.requires_grad]
                    if pairs:
                        torch.autograd.backward(*zip(*pairs))
                local = obj.detach()
            else:
                if tie is not None:
                    torch.autograd.backward(tie)
                if isinstance(penalty, Tensor):
                    penalty.backward()
                for m in reversed(range(M)):
                    torch.autograd.backward(tokens[m])
                local = (penalty.detach() if isinstance(penalty, Tensor)
                         else torch.zeros((), device=net.device))
        mesh.wait_sends()
        loss = mesh.all_reduce_(local.float().reshape(1), axis="pp")
        loss = mesh.all_reduce_(loss, axis="data").reshape(()) / self.dp
        grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                         else t.grad, P)
        del P, outs, tokens
        bad = self._apply(grads, loss)
        self._settle_states(bad, states)
        return loss, bad, new_carries

    def _apply(self, grads, loss):
        """The stage's update from its gradient (averaged over the data
        axis), guarded under a sentinel by a flag taken over every rank.
        Returns the flag, or None."""
        net, mesh = self.net, self.mesh
        mesh.mean_(tree_leaves(grads))
        bad = None
        if net._sentinel is not None:
            Updater.device_count(net.opt_state, net.device)
            bad = mesh.any_flag(nonfinite_flag(loss, grads), "pp")
            bad = mesh.any_flag(bad, "data")

        def update():
            compute_updates(net._tx, grads, net.opt_state, net.params,
                            self._layer_list(), net.conf.training,
                            pipe=mesh if self._graph else None)
        if bad is None:
            update()
        else:
            written = tree_leaves(net.params) + [net.opt_state["count"]] + [
                t for k, v in net.opt_state.items() if k != "count"
                for t in tree_leaves(v)]
            guarded_in_place(bad, written, update)
        return bad

    def _settle_states(self, bad, new_states) -> None:
        """The stage's layer states after the step: averaged over the data
        axis (the running statistics each shard took of its rows), kept
        as they were where the step was bad."""
        net = self.net
        states = net._guard_tree(bad, net.states, new_states)
        self.mesh.mean_([t for k in self._own() for t in states[k].values()])
        net.states = states

    # ---------------------------------------------------------------- fit
    def fit_batch(self, batch):
        """One step on one global batch (one a time window under tBPTT) on
        every rank. Returns the loss (the mean over the windows under
        tBPTT) as a device scalar."""
        net = self.net
        if not self._sharded:
            self._shard()
        B = self._global_rows(batch)
        b_mb = self._check_rows(B)
        feats = batch.features
        if self._tbptt and not isinstance(batch, MultiDataSet) \
                and len(feats.shape) == 3:
            # rank-3 features + truncated_bptt => window the updates, as
            # MultiLayerNetwork.fit_batch routes them — including its
            # rank-3-labels requirement: slicing a rank-2 label tensor
            # along time would shear off classes
            labels = batch.labels
            if len(labels.shape) != 3:
                raise ValueError(
                    "truncated_bptt requires rank-3 (time-distributed) "
                    "labels [B, T, K]; got rank-"
                    f"{len(labels.shape)} {tuple(labels.shape)} — use "
                    "standard backprop for sequence-to-one training")
            return self._fit_batch_tbptt(batch, b_mb, B)
        stats = self.training_stats
        tracer = get_tracer()
        with tracer.span("shard"):
            t0 = time.perf_counter()
            xs, ys = self._microbatches(batch, b_mb)
            if stats:
                self._sync()
                stats.record("shard", time.perf_counter() - t0)
        with tracer.span("step", microbatches=self.M):
            t0 = time.perf_counter()
            loss, bad, _ = self._step(xs, ys, None,
                                      self._payload(b_mb // self.dp))
            if stats:
                self._sync()
                stats.record("step", time.perf_counter() - t0)
        net.last_batch_size = B
        net.last_grads = None   # the step collects no gradients
        net.score_value = loss
        net.iteration_count += 1
        net._observe_sentinel(bad)
        with tracer.span("listener"):
            t0 = time.perf_counter()
            net._notify_iteration()
            if stats:
                stats.record("listener", time.perf_counter() - t0)
        return loss

    def _fit_batch_tbptt(self, batch, b_mb: int, B: int):
        """Truncated BPTT through the stages: one step a time window; the
        recurrent layers' final carries are kept per microbatch and cut
        from the graph between windows (ref:
        MultiLayerNetwork.doTruncatedBPTT:1119-1183), zero at each
        batch."""
        net = self.net
        fwd = net.conf.training.tbptt_fwd_length
        T = batch.features.shape[1]
        b_loc = b_mb // self.dp
        stats = self.training_stats
        carries = [self._initial_carries(b_loc) for _ in range(self.M)]
        total, windows = 0.0, 0
        for start in range(0, T, fwd):
            end = min(start + fwd, T)
            t0 = time.perf_counter()
            window = DataSet(batch.features[:, start:end],
                             batch.labels[:, start:end],
                             data_ranks=batch.data_ranks)
            xs, ys = self._microbatches(window, b_mb)
            if stats:
                self._sync()
                stats.record("shard", time.perf_counter() - t0)
            t0 = time.perf_counter()
            loss, bad, new_carries = self._step(
                xs, ys, carries, self._payload(b_loc, timesteps=end - start))
            carries = [net._guard_tree(bad, c, nc)
                       for c, nc in zip(carries, new_carries)]
            if stats:
                self._sync()
                stats.record("step", time.perf_counter() - t0)
            total = total + loss
            windows += 1
            net.score_value = loss
            net.iteration_count += 1
            net._observe_sentinel(bad)
            t0 = time.perf_counter()
            net._notify_iteration()
            if stats:
                stats.record("listener", time.perf_counter() - t0)
        net.last_batch_size = B
        net.last_grads = None
        return total / max(windows, 1)

    def fit(self, data, epochs: int = 1):
        """``epochs`` passes over ``data`` (a batch or an iterable of
        them), with a ``TrainingListener``'s epoch hooks around each."""
        net = self.net
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        elif hasattr(data, "attach"):
            # a streaming input pipeline: its batches land on the card as
            # this data rank's rows of each of the M microbatches
            data.attach(mesh=self.mesh, microbatches=self.M)
        stats = self.training_stats
        for _ in range(epochs):
            net._notify_epoch("on_epoch_start")
            src = stats.timed_iter(data) if stats else data
            for batch in src:
                self.fit_batch(batch)
            net.epoch_count += 1
            net._notify_epoch("on_epoch_end")
        return self

    # -------------------------------------------------------- subclass hooks
    def _tie_forward(self, P):
        """The tied head's weight exchange (graphs): None without one."""
        return None

    def _initial_carries(self, rows: int):
        return None


# ---------------------------------------------------------------------------
# the stack: PipelineTrainer
# ---------------------------------------------------------------------------

class PipelineTrainer(_StageTrainer):
    """GPipe pipeline-parallel trainer for a ``MultiLayerNetwork``.

    The net's body layers (all but the loss head) are partitioned into S
    contiguous stages (``partition_stages``, or ``stages``); stage s runs
    on the rank at pipe index s of the mesh's 'pp' axis (with a data
    axis, on each data index), the loss head on the last stage. Layers
    run as ``MultiLayerNetwork._forward`` runs them, and the head's loss,
    the penalty and the update are the single-device code's, so at
    ``n_microbatches == 1`` (and at any M without batch norm, dropout or
    aux layers) a step is ``net.fit_batch`` up to float reassociation.

    Batch norm statistics are per microbatch (and per data shard, the
    running averages averaged over the data axis after the step), as in
    GPipe: they match the single-device step only at M == 1.

    MoE aux-loss semantics under microbatching: with M > 1 each
    microbatch computes its balancing loss over its own slice of the
    batch and the objective takes the mean of those per-microbatch
    values, not the full batch's aux. Exact parity holds only at M=1 on
    a pp-only mesh; a one-time ``logger.warning`` marks runs that train
    aux layers with M > 1.

    Recurrent layers run their whole sequence in their stage (zero carry
    per batch); under truncated BPTT the final carries are kept between
    time windows per microbatch, cut from the graph at window edges
    (pp-only meshes)."""

    def __init__(self, net, mesh: Optional[MeshContext] = None,
                 axis: str = "pp", n_microbatches: Optional[int] = None,
                 stages: Optional[Sequence[Sequence[int]]] = None,
                 collect_training_stats: bool = False, device=None):
        self._setup(net, mesh, axis, n_microbatches, collect_training_stats,
                    device)
        if not hasattr(net, "layers"):
            raise ValueError("PipelineTrainer supports MultiLayerNetwork "
                             "(use GraphPipelineTrainer for a graph)")
        if net.conf.input_type is None:
            raise ValueError("PipelineTrainer needs set_input_type() on the "
                             "config (static boundary shapes)")
        body = net.layers[:-1]
        head = net.layers[-1]
        if not hasattr(head, "compute_loss"):
            raise ValueError("Last layer must be an output/loss layer")
        # aux losses ride the activation to the last stage (the layer
        # states carry no gradient)
        self._aux_layers = [i for i, l in enumerate(body)
                            if "aux_loss" in net.states[i]]
        self._aux = int(bool(self._aux_layers))
        global _WARNED_AUX_MICROBATCH
        if self._aux_layers and self.M > 1 and not _WARNED_AUX_MICROBATCH:
            _WARNED_AUX_MICROBATCH = True
            logger.warning(
                "PipelineTrainer: %d aux-loss layer(s) with "
                "n_microbatches=%d — the balancing loss is a mean of "
                "per-microbatch values, not the full-batch aux; exact "
                "single-device parity holds only at n_microbatches=1 "
                "(see the class docstring)",
                len(self._aux_layers), self.M)
        self._carry_layers = [i for i, l in enumerate(body)
                              if getattr(l, "supports_carry", False)]
        # gate on backprop_type alone: a truncated_bptt net with no carry
        # layers (e.g. bidirectional-only) still windows its updates on a
        # single device, and must window here too
        self._tbptt = (net.conf.training.backprop_type == "truncated_bptt")
        if self._tbptt and self._carry_layers and self.dp > 1:
            raise ValueError(
                "tBPTT under the pipeline needs a pp-only mesh: carries "
                "are per-batch-row and cannot ride the dp-averaged state "
                "buffer — drop the dp axis or train without tBPTT")
        if self._tbptt:
            tr = net.conf.training
            bwd = tr.tbptt_bwd_length or tr.tbptt_fwd_length
            if bwd < tr.tbptt_fwd_length:
                # MLN's split-window trick (forward-only head, backprop
                # tail) does not fit the stages: a silently full-window
                # backprop would train differently
                raise ValueError(
                    "tbptt_bwd_length < tbptt_fwd_length is unsupported "
                    "under the pipeline (windows backprop whole); set "
                    "bwd == fwd or train without the pipeline")
        self.stages = ([list(s) for s in stages] if stages is not None
                       else partition_stages(
                           body, net.params, self.S,
                           act_elems=_mln_boundary_elems(net.conf, body)))
        if len(self.stages) != self.S:
            raise ValueError(f"{len(self.stages)} stages != pp size {self.S}")
        flat = [i for st in self.stages for i in st]
        if flat != list(range(len(body))):
            raise ValueError(f"stages must cover body layers 0..{len(body)-1}"
                             f" contiguously, got {self.stages}")
        if any(not st for st in self.stages[:-1]) and any(
                st for i, st in enumerate(self.stages) if i
                and not self.stages[i - 1]):
            raise ValueError("empty (identity) stages must be trailing, "
                             f"got {self.stages}")
        self._shard()

    def _stage_keys(self, s: int) -> list:
        keys = list(self.stages[s])
        return keys + [len(self.net.layers) - 1] if s == self.S - 1 else keys

    def _param_list(self, P):
        return P

    def _layer_list(self):
        return self.net.layers

    def _validate(self, batch) -> int:
        if not isinstance(batch, DataSet):
            raise ValueError(
                "this pipeline trainer takes a single-input DataSet; "
                f"got {type(batch).__name__}")
        if batch.features_mask is not None or batch.labels_mask is not None:
            # loud, like the other unsupported features — a silently
            # dropped mask would train a whole run subtly wrong
            raise ValueError("masked DataSets are unsupported in the "
                             "pipeline trainers (mask threading "
                             "through the stages is future work)")
        return int(batch.features.shape[0])

    def _microbatches(self, batch, b_mb: int):
        """(stage 0's microbatch features, the last stage's microbatch
        labels) on the card, this rank's rows of each; None where the
        stage takes none."""
        net = self.net
        local = self.mesh.holds_local_rows(batch)
        xs = ys = None
        if self.p == 0:
            xs = [net._to_tensor(batch.features[self._rows(m, b_mb, local)])
                  for m in range(self.M)]
        if self.p == self.S - 1:
            ys = [torch.as_tensor(batch.labels[self._rows(m, b_mb, local)],
                                  device=net.device) for m in range(self.M)]
        return xs, ys

    def _payload(self, rows: int, timesteps: Optional[int] = None):
        """(elements entering this stage, elements leaving it, the
        entering shape) for ``rows`` rows of a microbatch: the TRUE
        activation shapes (``_true_layer_shapes``)."""
        body = [self.net.layers[i] for st in self.stages for i in st]
        shapes = _true_layer_shapes(self.net.conf, body, rows, timesteps)
        stage_in, pos = [], 0
        for st in self.stages:
            stage_in.append(shapes[pos])
            pos += len(st)
        stage_in.append(shapes[-1])
        return (_numel(stage_in[self.p]), _numel(stage_in[self.p + 1]),
                stage_in[self.p])

    def _initial_carries(self, rows: int):
        if not self._tbptt:
            return None
        net = self.net
        return {i: net.layers[i].initial_carry(rows, net.dtype, net.device)
                for i in self.stages[self.p] if i in self._carry_layers}

    def _stage_forward(self, P, h, states, carries, rng):
        """This stage's layers on one microbatch, as
        ``MultiLayerNetwork._forward`` runs them (tBPTT's carries
        branch with ``carries``). Returns (activation, states, new
        carries, the stage's aux sum or None)."""
        net, conf = self.net, self.net.conf
        states = list(states)
        new_carries = None if carries is None else {}
        aux = None
        for i in self.stages[self.p]:
            layer = net.layers[i]
            if i in conf.preprocessors:
                it = conf.input_types[i] if conf.input_types else None
                h = conf.preprocessors[i].transform(h, it)
            train = not layer.frozen
            if carries is not None and i in carries:
                # scan() bypasses apply(): input dropout must still fire
                h = layer._dropout_input(h, train, rng)
                h, new_carries[i] = layer.scan(P[i], h, carries[i], None)
            else:
                h, s = layer.apply(P[i], h, state=states[i], train=train,
                                   rng=rng, mask=None)
                if not layer.frozen:
                    states[i] = s
            if i in self._aux_layers and "aux_loss" in states[i]:
                a = states[i]["aux_loss"].float()
                aux = a if aux is None else aux + a
        return h, states, new_carries, aux

    def _head_loss(self, P, hs, ys, tie):
        net, conf = self.net, self.net.conf
        head_idx = len(net.layers) - 1
        h = torch.cat(hs, dim=0)
        pre = conf.preprocessors.get(head_idx)
        if pre is not None:
            # e.g. the auto CnnToFeedForward flatten before an OutputLayer
            # head — exactly as MultiLayerNetwork._forward applies it
            h = pre.transform(h, conf.input_types[head_idx]
                              if conf.input_types else None)
        return net.layers[head_idx].compute_loss(
            P[head_idx], h, torch.cat(ys, dim=0), mask=None)


# ---------------------------------------------------------------------------
# the graph: GraphPipelineTrainer
# ---------------------------------------------------------------------------

def find_graph_cut_points(conf) -> List[Tuple[int, str]]:
    """Valid stage boundaries of a DAG: positions ``p`` in the topological
    order where exactly ONE node's activation crosses from the prefix
    ``topo[:p]`` to the suffix. Returns [(p, crossing_node_name)]
    (``analysis/graphcheck.graph_cut_points``)."""
    return graph_cut_points(conf)


class GraphPipelineTrainer(_StageTrainer):
    """GPipe pipeline-parallel trainer for a ``ComputationGraph``. The
    topological order is split at single-tensor cut points
    (``find_graph_cut_points``) into S contiguous stages balanced by
    parameter count (and the boundary's activation size); skip
    connections live inside stages, so one stage hands the next one
    tensor. Batch norm, dropout and the data axis as in
    ``PipelineTrainer``; the output heads' losses and the update are the
    graph's single-device code's.

    Multi-input graphs feed every network input to stage 0; multi-output
    graphs put every loss head's input on the last boundary
    (``find_graph_cut_points`` counts heads as consumers, so no cut can
    strand a head input in an earlier stage) and the loss sums the
    heads. A tied loss head takes the tied layer's ``W`` from that
    layer's stage each step (see the module docstring).

    Out of scope, as in the JAX package: masks, RNN/carry vertices
    (LastTimeStep / DuplicateToTimeSeries), recurrent layers, aux-loss
    layers, truncated BPTT, tied layers that are not loss heads."""

    _graph = True
    _aux = 0

    def __init__(self, net, mesh: Optional[MeshContext] = None,
                 axis: str = "pp", n_microbatches: Optional[int] = None,
                 collect_training_stats: bool = False, device=None):
        from deeplearning4j_tpu_torch.nn.conf.graph import (
            DuplicateToTimeSeriesVertex, LastTimeStepVertex,
        )
        self._setup(net, mesh, axis, n_microbatches, collect_training_stats,
                    device)
        conf = net.conf
        if not conf.resolved_types:
            raise ValueError("GraphPipelineTrainer needs set_input_types() "
                             "on the config (static boundary shapes)")
        self.in_names = list(conf.network_inputs)
        self.out_names = list(conf.network_outputs)
        consumers_of = {n: 0 for n in conf.topological_order}
        for n in conf.topological_order:
            for i in conf.nodes[n].inputs:
                consumers_of[i] += 1
        for o in self.out_names:
            out_node = conf.nodes[o]
            if out_node.kind != "layer" \
                    or not hasattr(out_node.layer, "compute_loss"):
                raise ValueError(f"output node {o!r} must be a loss head")
            if consumers_of[o]:
                raise ValueError(f"output node {o!r} feeds other nodes — "
                                 "unsupported in the graph pipeline")
        self.head_in_names = []
        for o in self.out_names:
            for i in conf.nodes[o].inputs:
                if i not in self.head_in_names:
                    self.head_in_names.append(i)
        for name in conf.topological_order:
            node = conf.nodes[name]
            if node.kind == "vertex" and isinstance(
                    node.vertex, (LastTimeStepVertex,
                                  DuplicateToTimeSeriesVertex)):
                raise ValueError(f"vertex {name!r} "
                                 f"({type(node.vertex).__name__}) is "
                                 "unsupported in the graph pipeline v1")
            if node.kind != "layer":
                continue
            l = node.layer
            if "aux_loss" in net.states.get(name, {}):
                raise ValueError(f"layer node {name!r} carries an "
                                 "auxiliary loss — unsupported (see "
                                 "PipelineTrainer)")
            if getattr(l, "supports_carry", False):
                raise ValueError(f"layer node {name!r} is recurrent — "
                                 "unsupported in the graph pipeline v1")
            if getattr(l, "tied_to", None) and name not in self.out_names:
                # a tied layer inside a stage would need its partner's
                # params there; only the loss heads take them at the loss
                raise ValueError(
                    f"layer node {name!r} ties weights (tied_to="
                    f"{l.tied_to!r}) but is not an output head — only "
                    "tied LOSS heads are supported in the graph pipeline")
        if conf.training.backprop_type == "truncated_bptt":
            raise ValueError(
                "truncated_bptt is unsupported in the graph pipeline v1 "
                "— use PipelineTrainer (MLN) for windowed tBPTT or "
                "standard backprop for the graph")
        self.stages, self.boundaries = self._partition()
        self._last_real = max(i for i, st in enumerate(self.stages) if st)
        # the tied heads: head -> (the tied layer node, its stage)
        self._ties = {}
        for o in self.out_names:
            tied = getattr(conf.nodes[o].layer, "tied_to", None)
            if tied:
                self._ties[o] = (tied, next(s for s, st in
                                            enumerate(self.stages)
                                            if tied in st))
        self._shard()

    # ------------------------------------------------------------ partition
    def _partition(self):
        """Split the non-input, non-head topo nodes into S contiguous
        groups at balanced cut points. Returns (stages: list of
        node-name lists, boundaries: LIST of tensor names entering each
        stage — all network inputs for stage 0, the single crossing
        node after)."""
        conf = self.net.conf
        topo = list(conf.topological_order)
        heads = set(self.out_names)
        body = [n for n in topo
                if conf.nodes[n].kind != "input" and n not in heads]
        if not body:
            raise ValueError("no body nodes to pipeline")
        body_set = set(body)
        cuts = [(p, n) for p, n in find_graph_cut_points(conf)
                if 0 < p < len(topo) and n in body_set]

        def cost(name):
            node = conf.nodes[name]
            if node.kind != "layer":
                return 1
            return 1 + sum(int(np.prod(tuple(v.shape)))
                           for v in self.net.params[name].values())

        # map topo cut positions onto body-list boundaries, with the
        # crossing tensor's per-sample size as the cut's activation term
        topo_to_bidx = {}
        b = 0
        for p, name in enumerate(topo):
            topo_to_bidx[p + 1] = b + (1 if name in body_set else 0)
            if name in body_set:
                b += 1
        rt = conf.resolved_types
        boundaries, bound_name = [], {}
        for p, crossing in cuts:
            bidx = topo_to_bidx[p]
            if 0 < bidx < len(body):
                boundaries.append((bidx, float(_type_elems(rt[crossing]))))
                bound_name[bidx] = crossing
        costs = [cost(n) for n in body]
        n_cuts_usable = min(self.S - 1, len(boundaries))
        cut_idx = (_optimal_cuts(costs, boundaries, n_cuts_usable + 1)
                   if n_cuts_usable else None) or []
        stages, bounds = [], [list(self.in_names)]
        edges = [0] + list(cut_idx) + [len(body)]
        for i in range(len(edges) - 1):
            stages.append(body[edges[i]:edges[i + 1]])
            if i + 1 < len(edges) - 1:
                bounds.append([bound_name[edges[i + 1]]])
        # fewer cut points than stages: trailing identity stages
        while len(stages) < self.S:
            stages.append([])
            bounds.append(bounds[-1])
        return stages, bounds

    def _stage_keys(self, s: int) -> list:
        conf = self.net.conf
        keys = [n for n in self.stages[s] if conf.nodes[n].kind == "layer"]
        return keys + self.out_names if s == self.S - 1 else keys

    def _param_list(self, P):
        return [P[n] for n in self.net._layer_nodes]

    def _layer_list(self):
        conf = self.net.conf
        return [conf.nodes[n].layer for n in self.net._layer_nodes]

    # -------------------------------------------------------------- batches
    def _validate(self, batch) -> int:
        net = self.net
        if isinstance(batch, MultiDataSet):
            if any(m is not None for m in (batch.features_masks or [])) \
                    or any(m is not None
                           for m in (batch.labels_masks or [])):
                raise ValueError("masked MultiDataSets are unsupported "
                                 "in the pipeline trainers")
            if len(batch.features) != len(self.in_names) \
                    or len(batch.labels) != len(self.out_names):
                raise ValueError(
                    f"MultiDataSet arity {len(batch.features)}in/"
                    f"{len(batch.labels)}out != network "
                    f"{len(self.in_names)}in/{len(self.out_names)}out")
            rt = net.conf.resolved_types
            for name, f in zip(self.in_names, batch.features):
                want = _type_elems(rt[name])
                got = int(np.prod(tuple(f.shape[1:])))
                if got != want:
                    raise ValueError(
                        f"input {name!r}: got {got} elements/sample "
                        f"{tuple(f.shape)}, network expects {want} "
                        f"({rt[name]})")
            return int(batch.features[0].shape[0])
        if not isinstance(batch, DataSet):
            raise ValueError(
                "this pipeline trainer takes a DataSet or a MultiDataSet; "
                f"got {type(batch).__name__}")
        if batch.features_mask is not None or batch.labels_mask is not None:
            raise ValueError("masked DataSets are unsupported in the "
                             "pipeline trainers (mask threading "
                             "through the stages is future work)")
        return int(batch.features.shape[0])

    def _microbatches(self, batch, b_mb: int):
        net = self.net
        if isinstance(batch, MultiDataSet):
            feats, labels = list(batch.features), list(batch.labels)
        else:
            feats, labels = [batch.features], [batch.labels]
        rt = net.conf.resolved_types
        local = self.mesh.holds_local_rows(batch)
        xs = ys = None
        if self.p == 0:
            # each input in its declared per-sample shape
            xs = [{n: net._to_tensor(f[self._rows(m, b_mb, local)]).reshape(
                      _type_shape(rt[n], -1))
                   for n, f in zip(self.in_names, feats)}
                  for m in range(self.M)]
        if self.p == self.S - 1:
            ys = [{o: torch.as_tensor(l[self._rows(m, b_mb, local)],
                                      device=net.device)
                   for o, l in zip(self.out_names, labels)}
                  for m in range(self.M)]
        return xs, ys

    def _widths(self, names) -> List[Tuple[str, tuple]]:
        rt = self.net.conf.resolved_types
        return [(n, tuple(_type_shape(rt[n], 1)[1:])) for n in names]

    def _names_into(self, s: int) -> List[str]:
        """The tensors stage ``s`` receives (a stage past the last one
        with nodes hands the head inputs on)."""
        return (self.boundaries[s] if s <= self._last_real
                else self.head_in_names)

    def _payload(self, rows: int, timesteps: Optional[int] = None):
        def elems(names):
            return rows * sum(_numel(shp) for _, shp in self._widths(names))
        n_in = 0 if self.p == 0 else elems(self._names_into(self.p))
        return n_in, elems(self._names_into(self.p + 1)), (rows, -1)

    # ---------------------------------------------------------- the stage
    def _stage_forward(self, P, x, states, carries, rng):
        """This stage's nodes on one microbatch, as
        ``ComputationGraph._forward`` walks them. ``x``: stage 0's input
        dict, or the payload (``[rows, width]``) of the boundary tensors.
        Returns (the payload to hand on ``[rows, width]``, states, None,
        None)."""
        net, conf = self.net, self.net.conf
        stage = self.stages[self.p]
        if not stage:
            return x, states, None, None
        if self.p == 0:
            acts = dict(x)
            rows = next(iter(acts.values())).shape[0]
        else:
            rows, acts, off = x.shape[0], {}, 0
            for n, shp in self._widths(self.boundaries[self.p]):
                k = _numel(shp)
                acts[n] = x[:, off:off + k].reshape((rows,) + shp)
                off += k
        states = dict(states)
        for name in stage:
            node = conf.nodes[name]
            in_acts = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(in_acts)
                continue
            h = in_acts[0]
            if node.preprocessor is not None:
                h = node.preprocessor.transform(h, None)
            layer = node.layer
            acts[name], s = layer.apply(P[name], h, state=states[name],
                                        train=not layer.frozen, rng=rng,
                                        mask=None)
            if not layer.frozen:
                states[name] = s
        y = torch.cat([acts[n].reshape(rows, -1)
                       for n in self._names_into(self.p + 1)], dim=1)
        return y, states, None, None

    def _tie_forward(self, P):
        """The tied heads' weights: the tied stage sends its ``W`` to the
        last stage (after its microbatches, so the messages between two
        stages keep one order) and returns the send's token, whose
        backward brings the head's gradient back first; the last stage
        returns {head: the received W}. None where neither."""
        last = self.S - 1
        sent, got = [], {}
        for j, (o, (tied, s)) in enumerate(sorted(self._ties.items())):
            if s == last:
                continue
            tag = self.M + j
            if self.p == s:
                sent.append(self.mesh.send_stage(P[tied]["W"], last, tag))
            elif self.p == last:
                shape, dtype = self._meta[tied]["W"]
                got[o] = self.mesh.recv_stage(shape, dtype, s, tag)
        if self.p == last:
            return got
        return torch.stack(sent).sum() if sent else None

    def _head_loss(self, P, hs, ys, tie):
        net, conf = self.net, self.net.conf
        flat = torch.cat(hs, dim=0)
        total = 0.0
        off = 0
        slices = {}
        for n, shp in self._widths(self.head_in_names):
            slices[n] = (off, _numel(shp), shp)
            off += _numel(shp)
        for o in self.out_names:
            node = conf.nodes[o]
            start, size, shp = slices[node.inputs[0]]
            h = flat[:, start:start + size].reshape((-1,) + shp)
            if node.preprocessor is not None:
                h = node.preprocessor.transform(h, None)
            params = P[o]
            if o in self._ties:
                tied = self._ties[o][0]
                params = {**params, "W_tok": (tie or {}).get(o,
                                                             P[tied].get("W"))}
            total = total + node.layer.compute_loss(
                params, h, torch.cat([y[o] for y in ys], dim=0), mask=None)
        return total
