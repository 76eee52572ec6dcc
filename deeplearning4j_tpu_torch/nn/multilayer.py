"""MultiLayerNetwork: the sequential model container (the JAX package's
``nn/multilayer.py``): training (standard and truncated BPTT), inference
and stateful streaming.

Params are a list of per-layer dicts {param name -> tensor}, in the JAX
package's names and layouts, on the net's device. The container runs on
``cuda`` unless it is built with ``device="cpu"``; with ``device=None``
and no card it raises. As in the JAX container, the forward stops before
a final loss head: inference then applies the head without the time mask
(a masked step's output is the head on its zero activation), and training
hands the head's input to its ``compute_loss`` with the label mask, or the
feature mask for rank-3 labels.

Training (``fit_batch``, ``fit``, ``score``,
``compute_gradient_and_score``): the JAX package's ``jax.value_and_grad``
over one pure forward becomes ``torch.autograd.grad`` over the same walk
(``netcommon.value_and_grad``, under the precision policy: with
``precision("bf16")`` the params and float features are cast to bf16 at
the step boundary, the loss and the gradients come back in f32 and the
f32 masters are updated), and the update runs in place
(``nn/updater.compute_updates``). Truncated BPTT slices the time axis into
``tbptt_fwd_length`` windows, one optimizer step each, with the recurrent
carries detached between windows; with ``tbptt_bwd_length`` shorter, each
window's head runs under ``torch.no_grad()`` (the LSTMs then launch the
inference kernel K1) and still trains the output layer through its loss.
Dropout draws from one ``torch.Generator`` on the net's device, seeded
from the config. ``training.remat`` recomputes each layer's activations
in the backward (``netcommon.remat_call``). ``set_listeners`` /
``add_listener`` take the ``optimize/listeners`` API,
``set_divergence_sentinel`` guards every step, ``fit(scan_window=N)``
runs windows of N steps with one host read, ``fit`` prefetches through an
``AsyncDataSetIterator`` (``use_async``), and an ``optimization_algo``
other than SGD trains through the line-search solvers
(``optimize/solvers``). ``pretrain(iterator)`` trains each AutoEncoder,
RBM or VAE layer in turn on the stack below it (greedy layerwise, a bare
update, in place); like the JAX container, ``fit`` reads neither
``training.pretrain`` nor ``training.backprop`` (ROADMAP C33). ``evaluate``,
``evaluate_roc``, ``evaluate_roc_multi_class`` and
``evaluate_regression`` drive ``output()`` over an iterator. A
``CenterLossOutputLayer`` head's centers move by their moving average
after each update, outside the gradient.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis import steprecord
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator, ListDataSetIterator,
)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import (
    RBM, AutoEncoder, CenterLossOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.netcommon import (
    SGD_ALGOS, CostAnalysisMixin, EvalMixin, NetCommonMixin, ScanFitMixin,
    ShardCheckMixin, batch_sum_kwargs, cast_batch, compute_dtype, flat_params,
    make_pretrain_step, policy_value_and_grad, remat_call, set_flat_params,
)
from deeplearning4j_tpu_torch.nn.updater import (
    build_optimizer, l1_l2_penalty,
)
from deeplearning4j_tpu_torch.parallel import tensor as _tp
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

Tensor = torch.Tensor

#: the layers layerwise pretraining trains (the rest it walks past)
PRETRAINABLE = (RBM, AutoEncoder, VariationalAutoencoder)


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


def _window(a, lo: int, hi: int):
    """Time steps [lo, hi) of a [B, T, ...] array or mask, or None."""
    return None if a is None else a[:, lo:hi]


class MultiLayerNetwork(NetCommonMixin, EvalMixin, ScanFitMixin,
                        CostAnalysisMixin, ShardCheckMixin):
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.dtype = _dtype_of(conf.training.dtype)
        self.params: Optional[List[Dict[str, Tensor]]] = None
        self.states: Optional[List[Dict[str, Tensor]]] = None
        self.opt_state = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.last_batch_size = 0
        self.listeners: list = []
        self._tx = build_optimizer(conf.training)
        # dropout's draws: one generator on the net's device
        self._rng = torch.Generator(device=self.device).manual_seed(
            conf.training.seed)
        self._rnn_carries: Optional[List[Any]] = None  # rnn_time_step state
        self._infer_traces = 0   # CUDA-graph captures of _infer_fn

    # ------------------------------------------------------------------ init
    def init(self, params=None, states=None) -> "MultiLayerNetwork":
        """Draw params from a CPU ``torch.Generator`` seeded with the
        config's seed, layer by layer (the same weights on every device),
        or take ``params`` (e.g. ``convert.params_from_jax``), and the
        layers' initial states, or ``states``
        (``convert.states_from_jax``); either way they are moved to the
        net's device."""
        if params is None:
            gen = torch.Generator().manual_seed(self.conf.training.seed)
            params = [layer.init_params(gen, self.dtype)
                      if layer.has_params() else {} for layer in self.layers]
        if states is None:
            states = [layer.init_state() for layer in self.layers]
        self.params = [{k: t.to(self.device) for k, t in p.items()}
                       for p in params]
        self.states = [{k: t.to(self.device) for k, t in s.items()}
                       for s in states]
        self.opt_state = self._tx.init(self.params)
        return self

    def _check_init(self):
        if self.params is None:
            raise RuntimeError("Call init() before using the network")

    def num_params(self) -> int:
        self._check_init()
        return sum(t.numel() for p in self.params for t in p.values())

    def _head(self):
        """The final loss head (a layer with ``compute_loss``), or None."""
        last = self.layers[-1]
        return last if hasattr(last, "compute_loss") else None

    # ---------------------------------------------------------------- forward
    def _forward(self, params, states, x, *, train: bool = False, rng=None,
                 mask=None, carries: Optional[list] = None,
                 collect: bool = False):
        """Forward through preprocessors and layers, stopping before a
        final loss head (whose input it returns).

        ``carries``: optional per-layer RNN carry list (tBPTT,
        rnn_time_step); layers with ``supports_carry`` then run ``scan``
        from their carry, after their input dropout. ``train`` turns on
        dropout (not in frozen layers), drawn from ``rng``, and, with
        ``training.remat``, runs each layer's apply (a recurrent layer's
        sequence pass) under ``remat_call``. Returns
        (activation, per-layer activations if ``collect``, new states, new
        carries, the mask after the last layer)."""
        acts: List[Tensor] = []
        new_states: list = []
        new_carries: list = [None] * len(self.layers)
        cur_mask = mask
        in_types = self.conf.input_types
        h = x
        last = len(self.layers) - 1
        remat = train and self.conf.training.remat
        batch_sum_for = batch_sum_kwargs(self._batch_sum)
        # a step on a mesh's model / sp axes (parallel/tensor.py): `sh`
        # marks h as this rank's time shard
        mesh = _tp.step_mesh(self)
        sh = _tp.seq_split(mesh) and h.dim() == 3
        for i, layer in enumerate(self.layers):
            # whole_T: the T of a whole sequence gathered for this layer
            # (by its preprocessor, or for a layer that mixes time steps),
            # whose output goes back to this rank's steps
            whole_T = None
            if i in self.conf.preprocessors:
                if sh:
                    h, cur_mask, whole_T = _tp.whole_sequence(mesh, h,
                                                              cur_mask)
                    sh = False
                it = in_types[i] if in_types else None
                h = self.conf.preprocessors[i].transform(h, it)
                cur_mask = self.conf.preprocessors[i].transform_mask(
                    cur_mask, it)
            if i == last and hasattr(layer, "compute_loss"):
                if whole_T is not None:
                    h, cur_mask, sh = _tp.own_steps(mesh, h, cur_mask,
                                                    whole_T)
                new_states.append(states[i])
                break
            layer_train = train and not layer.frozen
            s = states[i]
            p_i = params[i] if mesh is None else _tp.layer_params(
                self, i, layer, params[i])
            if sh and not _tp.sequence_local(layer):
                h, cur_mask, whole_T = _tp.whole_sequence(mesh, h, cur_mask)
            seq_kw = _tp.seq_kwargs(layer, sh and whole_T is None)
            if carries is not None and getattr(layer, "supports_carry",
                                               False):
                c_in = carries[i]
                if c_in is None:
                    c_in = layer.initial_carry(h.shape[0], h.dtype, h.device)
                # scan() bypasses apply(): input dropout must still fire
                # so tBPTT training regularizes like standard BPTT
                h = layer._dropout_input(h, layer_train, rng)
                if remat:
                    h, new_carries[i] = remat_call(
                        lambda _, *a, _l=layer: _l.scan(*a), None,
                        p_i, h, c_in, cur_mask)
                else:
                    h, new_carries[i] = layer.scan(p_i, h, c_in, cur_mask)
            else:
                def apply_fn(r, p, hh, s_in, m, _l=layer, _t=layer_train,
                             _kw=seq_kw):
                    return _l.apply(p, hh, state=s_in, train=_t, rng=r,
                                    mask=m, **batch_sum_for(_l), **_kw)
                h, s = (remat_call(apply_fn, rng, p_i, h, s, cur_mask)
                        if remat else apply_fn(rng, p_i, h, s, cur_mask))
                if layer.frozen:
                    s = states[i]
            # layers that consume or rearrange the time axis drop the mask
            cur_mask = layer.propagate_mask(cur_mask)
            if whole_T is not None:
                h, cur_mask, sh = _tp.own_steps(mesh, h, cur_mask, whole_T)
            new_states.append(s)
            if collect:
                acts.append(h)
        return h, acts, new_states, new_carries, cur_mask

    def _apply_head(self, h):
        """The final loss head on its input, without the mask."""
        head = self._head()
        if head is None:
            return h
        return head.apply(self.params[-1], h, state=self.states[-1])[0]

    def _to_tensor(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def feed_forward(self, x) -> List[Tensor]:
        """All layer activations (ref: MultiLayerNetwork.feedForward)."""
        self._check_init()
        with torch.no_grad():
            h, acts, _, _, _ = self._forward(self.params, self.states,
                                             self._to_tensor(x), collect=True)
            if self._head() is not None:
                acts.append(self._apply_head(h))
        return acts

    def _infer_fn(self):
        """The inference forward as one function on tensors, ``(params,
        states, x, mask) -> the head's output`` (the JAX container's
        jitted ``_infer_fn`` seam, ref: MultiLayerNetwork.java:1512-1594).
        It reads nothing but its arguments, makes no host copy and no
        host sync, so the predict scheduler can capture it into a CUDA
        graph; ``output()`` runs it eagerly. ``_infer_traces`` counts
        those captures (the JAX container counts its traces)."""
        def infer(params, states, x, mask):
            h, _, _, _, _ = self._forward(params, states, x, mask=mask)
            head = self._head()
            if head is not None:
                h = head.apply(params[-1], h, state=states[-1])[0]
            return h
        return infer

    def output(self, x, mask=None) -> Tensor:
        """Final network output (ref: MultiLayerNetwork.output). ``mask``:
        a [B, T] feature mask for recurrent input."""
        self._check_init()
        mask = None if mask is None else self._to_tensor(mask)
        with torch.no_grad():
            return self._infer_fn()(self.params, self.states,
                                    self._to_tensor(x), mask)

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (ref: MultiLayerNetwork.predict)."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    # ------------------------------------------------------------------ loss
    def _batch(self, ds: DataSet):
        """(features, labels, feature mask, label mask) on the net's
        device: features and masks in the net's dtype, labels as given.
        Tensors already there (``DevicePrefetchIterator``'s) are taken as
        they are, or cast on the device."""
        opt = (lambda a: None if a is None else self._to_tensor(a))
        return (self._to_tensor(ds.features),
                torch.as_tensor(ds.labels, device=self.device),
                opt(ds.features_mask), opt(ds.labels_mask))

    def _head_loss(self, params, h, labels, lmask, cur_mask):
        """The head's loss on its input ``h``: the label mask, else the
        forward's mask when the labels are time-distributed."""
        head = self._head()
        if head is None:
            raise ValueError(
                "Last layer must be an output/loss layer for fit()")
        mask = lmask if lmask is not None else (
            cur_mask if labels.dim() > 2 else None)
        mesh = _tp.step_mesh(self)
        if mesh is None:
            return head.compute_loss(params[-1], h, labels, mask=mask)
        p = _tp.layer_params(self, len(self.layers) - 1, head, params[-1])
        return head.compute_loss(p, h, labels, mask=mask) * \
            _tp.head_scale(mesh, labels)

    def _regularized(self, params, loss, new_states):
        """``loss`` + the L1/L2 penalty + the auxiliary losses layers
        surface in their state (each counted once over a sharded step's
        ranks)."""
        mesh = _tp.step_mesh(self)
        if mesh is None:
            return (loss + l1_l2_penalty(params, self.layers)
                    + _sum_aux_losses(new_states))
        return (loss + _tp.penalty(self, mesh, list(enumerate(params)),
                                   self.layers)
                + _sum_aux_losses(new_states) * _tp.replicated_scale(mesh))

    def _loss_fn(self, params, states, features, labels, fmask, lmask, rng,
                 train: bool = True, carries: Optional[list] = None):
        """(score, (new states, new carries, the head's input)): the
        head's loss + the L1/L2 penalty + the auxiliary losses layers
        surface in their state."""
        h, _, new_states, new_carries, cur_mask = self._forward(
            params, states, features, train=train, rng=rng, mask=fmask,
            carries=carries)
        loss = self._head_loss(params, h, labels, lmask, cur_mask)
        return self._regularized(params, loss, new_states), (
            new_states, new_carries, h)

    def score(self, dataset: Optional[DataSet] = None,
              train: bool = False) -> float:
        """Mean per-example loss + regularization of ``dataset`` at the
        current params (no update); the last minibatch's without one
        (ref: MultiLayerNetwork.score)."""
        self._check_init()
        if dataset is None:
            return self.score_value
        with torch.no_grad():
            loss, _ = self._loss_fn(self.params, self.states,
                                    *self._batch(dataset), rng=None,
                                    train=train)
        return float(loss)

    # ------------------------------------------------------------- train step
    def compute_gradient_and_score(self, dataset: DataSet):
        """(gradients, score, new states) of ``dataset`` at the current
        params over the whole sequence (ref:
        MultiLayerNetwork.computeGradientAndScore), training mode (dropout
        on). Gradients mirror the params."""
        grads, loss, new_states, _ = self._gradient(self._batch(dataset))
        return grads, loss, new_states

    def _gradient(self, batch):
        """(gradients, score, new states, the head's input) of ``batch``
        (``_batch``'s tuple) at the current params, training mode, under
        the precision policy (gradients and score in f32)."""
        self._check_init()
        batch = cast_batch(self.conf.training, batch)
        loss, (new_states, _, h), grads = policy_value_and_grad(
            lambda p: self._loss_fn(p, self.states, *batch, rng=self._rng),
            self.params, self.conf.training)
        return grads, loss, new_states, h

    def _step(self, grads, new_states, loss):
        """Apply one update (guarded under a sentinel) and take the new
        layer states. Returns the step's bad flag, or None."""
        bad = self._update(grads, loss, self.layers)
        self.states = self._guard_tree(bad, self.states, new_states)
        return bad

    def _train_batch(self, dataset: DataSet):
        """One SGD-family step on ``dataset`` (the step ``fit_batch`` and
        a scan window run). Returns (loss, bad flag or None)."""
        batch = self._batch(dataset)
        grads, loss, new_states, h = self._gradient(batch)
        head = self.layers[-1]
        if isinstance(head, CenterLossOutputLayer):
            # the centers' moving average, from the params before the
            # update, outside the gradient
            with torch.no_grad():
                centers = head.updated_centers(
                    self.params[-1], h.detach().to(self.dtype), batch[1])
        bad = self._step(grads, new_states, loss)
        if isinstance(head, CenterLossOutputLayer):
            cl = self.params[-1]["cL"]
            cl.copy_(centers if bad is None
                     else torch.where(bad, cl, centers))
        self.last_grads = grads if self._collect_grads else None
        return loss, bad

    def fit_batch(self, dataset: DataSet):
        """One optimization step on one minibatch (ref: fit(DataSet)), or
        one per tBPTT window, or a line-search solver's run when
        ``optimization_algo`` is not SGD. Returns the loss at the step's
        starting params (the mean of the windows' losses under tBPTT) as a
        device scalar; reading it synchronizes, ``score_value`` is the
        last step's as a float. Listeners hear of each step, and the
        sentinel gets each step's flag."""
        self._check_init()
        if self.conf.training.optimization_algo not in SGD_ALGOS:
            from deeplearning4j_tpu_torch.optimize.solvers import (
                solver_fit_batch,
            )
            return solver_fit_batch(self, dataset)
        if self._tbptt_applies(dataset):
            return self._fit_tbptt(dataset)
        # host-side span: the step's dispatch, which is what hangs when a
        # kernel build or a transfer wedges
        with get_tracer().span("fit_batch", it=self.iteration_count + 1):
            loss, bad = self._train_batch(dataset)
        self.last_batch_size = dataset.num_examples()
        self.last_input = dataset.features
        self.score_value = loss
        self.iteration_count += 1
        self._observe_sentinel(bad)
        self._notify_iteration()
        return loss

    # ------------------------------------------------------------------ tBPTT
    def _tbptt_applies(self, dataset: DataSet) -> bool:
        """True when ``dataset`` trains by truncated BPTT: the config asks
        for it and the features are a [B, T, F] series (whose labels must
        then be time-distributed too)."""
        if (self.conf.training.backprop_type != "truncated_bptt"
                or dataset.features.ndim != 3):
            return False
        if dataset.labels.ndim != 3:
            raise ValueError(
                "truncated_bptt requires rank-3 (time-distributed) "
                f"labels; got rank-{dataset.labels.ndim}. Use "
                "backprop_type('standard') for sequence-to-one heads.")
        return True

    def _tbptt_windows(self, batch, start: int, end: int):
        """Time steps [start, end) of ``_batch``'s tuple."""
        return tuple(_window(a, start, end) for a in batch)

    def _tbptt_length(self, batch) -> int:
        """The time length of ``_batch``'s tuple."""
        return batch[0].shape[1]

    def _initial_carries(self, B: int, dtype):
        """Zero carries for a tBPTT batch of ``B`` rows."""
        return [layer.initial_carry(B, dtype, self.device)
                if getattr(layer, "supports_carry", False) else None
                for layer in self.layers]

    def _tbptt_loss(self, params, feats, labels, fmask, lmask, carries):
        """One window's (score, (new states, new carries)). With
        ``tbptt_bwd_length`` < ``tbptt_fwd_length`` the reference's
        backward visits only the window's last bwd steps
        (MultiLayerNetwork.java:1119, LSTMHelpers.java:333): the head
        [0, T - bwd) runs without a graph and its activations and carries
        stop the gradient, while its loss still counts and still trains
        the output layer; per-timestep losses sum over time, so head +
        tail is the window's loss."""
        t = self.conf.training
        fwd = t.tbptt_fwd_length
        bwd = t.tbptt_bwd_length or fwd
        T = feats.shape[1]
        split = max(T - bwd, 0) if bwd < fwd else 0
        if split == 0:
            loss, (new_states, new_carries, _) = self._loss_fn(
                params, self.states, feats, labels, fmask, lmask, self._rng,
                carries=carries)
            return loss, (new_states, new_carries)
        with torch.no_grad():
            h1, _, states1, carries1, m1 = self._forward(
                params, self.states, _window(feats, 0, split), train=True,
                rng=self._rng, mask=_window(fmask, 0, split),
                carries=carries)
        h2, _, new_states, new_carries, m2 = self._forward(
            params, states1, _window(feats, split, T), train=True,
            rng=self._rng, mask=_window(fmask, split, T), carries=carries1)
        loss = (self._head_loss(params, h1, _window(labels, 0, split),
                                _window(lmask, 0, split), m1)
                + self._head_loss(params, h2, _window(labels, split, T),
                                  _window(lmask, split, T), m2))
        return self._regularized(params, loss, new_states), (
            new_states, new_carries)

    def _fit_tbptt(self, dataset: DataSet):
        """Truncated BPTT over time windows, carrying the RNN state (ref:
        MultiLayerNetwork.doTruncatedBPTT:1119-1183): one optimizer step a
        window (the last may be short), the carries starting at zeros and
        detached between windows. They start in the training dtype, or
        under a mixed policy in the compute dtype (ROADMAP C14: the fused
        LSTM takes one dtype, and its contract rounds the carries to the
        input type every step, as the TPU kernel's scratch of that type
        would). Under a sentinel a bad window leaves the carries as they
        were too. Returns the mean of the windows' losses."""
        training = self.conf.training
        fwd = training.tbptt_fwd_length
        feats, labels, fmask, lmask = cast_batch(training,
                                                 self._batch(dataset))
        B, T = feats.shape[:2]
        carries = self._initial_carries(
            B, compute_dtype(training, self.dtype))
        self.last_grads = None   # the tBPTT step collects no gradients
        total, windows = 0.0, 0
        for start in range(0, T, fwd):
            end = min(start + fwd, T)
            # each window is a program of its own (the reference jits one
            # window); the sentinel drains its flag between two of them
            with steprecord.window(windows):
                loss, (new_states, new_carries), grads = \
                    policy_value_and_grad(
                        lambda p: self._tbptt_loss(
                            p, *(_window(a, start, end)
                                 for a in (feats, labels, fmask, lmask)),
                            carries),
                        self.params, training)
                bad = self._step(grads, new_states, loss)
                carries = self._guard_tree(bad, carries, new_carries)
                total = total + loss    # on the device: no sync per window
            windows += 1
            self.iteration_count += 1
            self.score_value = loss
            self._observe_sentinel(bad)
            self._notify_iteration()
        self.last_batch_size = dataset.num_examples()
        return total / max(windows, 1)

    # -------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1, use_async: bool = True,
            scan_window: int = 1) -> "MultiLayerNetwork":
        """Train (ref: MultiLayerNetwork.fit(DataSetIterator):947-1016) on
        a DataSetIterator, a DataSet or ``(features, labels)`` arrays, for
        ``epochs``, with a ``TrainingListener``'s epoch hooks around each.

        ``use_async``: the iterator is wrapped in an
        ``AsyncDataSetIterator`` (a producer thread reads ahead; the
        batches and their order are the same), closed when ``fit``
        returns or raises. ``scan_window > 1`` groups that many batches
        into one window (``fit_batches_scan``): the steps run back to back
        and their losses are read once, in a listener burst after the
        window (``model.last_scan_window`` carries {n, wall_s} during the
        burst); a short tail, or a window the scan cannot take (see
        ``fit_batches_scan``), trains per batch."""
        self._check_init()
        if labels is not None:
            data = DataSet(np.asarray(data), np.asarray(labels))
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        if not isinstance(data, DataSetIterator):
            raise TypeError(f"fit takes a DataSet, a DataSetIterator or "
                            f"(features, labels), not {type(data).__name__}")
        it = (AsyncDataSetIterator(data)
              if use_async and data.async_supported() else data)
        try:
            for _ in range(epochs):
                self._notify_epoch("on_epoch_start")
                if scan_window > 1:
                    self._fit_epoch_scan(it, scan_window)
                else:
                    for batch in it:  # __iter__ resets the iterator
                        self.fit_batch(batch)
                self.epoch_count += 1
                self._notify_epoch("on_epoch_end")
        finally:
            if it is not data:
                it.close()
        return self

    # --------------------------------------------------------------- pretrain
    def pretrain(self, iterator, epochs: int = 1) -> None:
        """Greedy layerwise pretraining of the AE / RBM / VAE layers (ref:
        MultiLayerNetwork.pretrain: walks the layers and trains each
        pretrainable one on the activations of the stack below it). Each
        layer gets a fresh optimizer from the config's updater and one
        bare update a batch (``netcommon.make_pretrain_step``), written
        into its tensors in place; the draws come from the net's
        generator. ``score_value`` holds the last step's loss; no listener
        hears of it, as in the JAX container."""
        self._check_init()
        for idx, layer in enumerate(self.layers):
            if not isinstance(layer, PRETRAINABLE):
                continue
            tx = build_optimizer(self.conf.training)
            layer_opt = tx.init(self.params[idx])
            step = make_pretrain_step(layer, tx)
            for _ in range(epochs):
                iterator.reset()
                for batch in iterator:
                    x = self._to_tensor(batch.features)
                    if idx > 0:
                        x = self._activate_to(idx, x)
                    self.score_value = step(self.params[idx], layer_opt, x,
                                            self._rng)

    @torch.no_grad()
    def _activate_to(self, layer_index: int, x: Tensor) -> Tensor:
        """The inference activations feeding layer ``layer_index``, its
        preprocessor applied (ref: MultiLayerNetwork.feedForwardToLayer):
        layerwise pretraining's and ``TransferLearningHelper.featurize``'s
        input."""
        h = x
        in_types = self.conf.input_types
        for i in range(layer_index):
            if i in self.conf.preprocessors:
                it = in_types[i] if in_types else None
                h = self.conf.preprocessors[i].transform(h, it)
            h, _ = self.layers[i].apply(self.params[i], h,
                                        state=self.states[i], train=False,
                                        rng=None)
        if layer_index in self.conf.preprocessors:
            it = in_types[layer_index] if in_types else None
            h = self.conf.preprocessors[layer_index].transform(h, it)
        return h

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
            h, _, _, new_carries, _ = self._forward(
                self.params, self.states, x, carries=self._rnn_carries)
            h = self._apply_head(h)
        # keep existing carries for non-RNN layers
        self._rnn_carries = [nc if nc is not None else oc
                             for nc, oc in zip(new_carries, self._rnn_carries)]
        return h[:, 0] if squeeze else h

    # ----------------------------------------------------------- param access
    def _flat_order(self) -> List[Tensor]:
        """The param tensors in the documented layer / param order."""
        return [p[name] for layer, p in zip(self.layers, self.params)
                for name in layer.param_order()]

    def params_flat(self) -> np.ndarray:
        """One flat parameter vector in the documented layer/param order
        (the coefficients.bin view, ref: MultiLayerNetwork.params());
        bf16 params come back as float32."""
        self._check_init()
        return flat_params(self._flat_order())

    def set_params_flat(self, flat: np.ndarray) -> None:
        """Write ``flat`` (``params_flat``'s order) into the params in
        place; a wrong length raises and leaves the net untouched."""
        self._check_init()
        set_flat_params(self._flat_order(), flat)

    def clone(self) -> "MultiLayerNetwork":
        """A new net on the same config and device with copies of the
        params and layer states: it shares no tensor with this one. Its
        updater state starts fresh, as the JAX package's clone's does."""
        self._check_init()
        net = MultiLayerNetwork(self.conf, device=self.device)
        return net.init(params=[{k: t.detach().clone() for k, t in p.items()}
                                for p in self.params],
                        states=[{k: t.detach().clone() for k, t in s.items()}
                                for s in self.states])
