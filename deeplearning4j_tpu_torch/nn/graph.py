"""ComputationGraph: the DAG model container (the JAX package's
``nn/graph.py``): training, inference and incremental decode.

Params are a dict keyed by node name -> {param name -> tensor}, in the
JAX package's names and layouts, on the net's device. The container runs
on ``cuda`` unless it is built with ``device="cpu"``; with ``device=None``
and no card it raises. ``rnn_time_step`` threads the (h, c) carries of
recurrent nodes between calls.

Training (``fit_batch``, ``fit``, ``score``): the JAX package's
``jax.value_and_grad`` over one pure forward walk becomes
``torch.autograd.grad`` over the same walk, with the params' tensors as
the leaves (``netcommon.value_and_grad``); the update
(``nn/updater.compute_updates``) then runs in place under
``torch.no_grad()``. Truncated BPTT slices the recurrent inputs' time
axis into windows, one step each, carrying the recurrent nodes' state
between them, as ``MultiLayerNetwork`` does. Dropout draws from one
``torch.Generator`` on the net's device, seeded from the config. The
single-card training features are those of ``MultiLayerNetwork``: the
precision policy (bf16 compute on f32 masters), ``remat``, listeners,
the divergence sentinel, ``fit(scan_window=N)``, ``fit``'s asynchronous
prefetch and the line-search solvers. ``evaluate``, ``evaluate_roc``,
``evaluate_roc_multi_class`` and ``evaluate_regression`` drive
``output()`` over an iterator. Incremental decode has the dense step
(``decode_fns``) and the block-paged one the serving engine runs
(``paged_decode_fn`` over ``init_kv_page_pool``), both updating their KV
state in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.memory import default_kv_page_len
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator, DataSetIterator, ListDataSetIterator,
)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex, LastTimeStepVertex,
)
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttentionLayer, gather_kv_pages, scatter_kv_token,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    LayerNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.shape import TimeDistributedLayer
from deeplearning4j_tpu_torch.nn.multilayer import _sum_aux_losses
from deeplearning4j_tpu_torch.nn.netcommon import (
    SGD_ALGOS, CostAnalysisMixin, EvalMixin, NetCommonMixin, ScanFitMixin,
    batch_sum_kwargs, cast_batch, check_trainable, compute_dtype, flat_params,
    policy_value_and_grad, remat_call, set_flat_params,
)
from deeplearning4j_tpu_torch.nn.updater import (
    build_optimizer, l1_l2_penalty,
)
from deeplearning4j_tpu_torch.parallel import tensor as _tp
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer

Tensor = torch.Tensor


def _dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _time_slice(d: Optional[Dict[str, Tensor]], lo: int, hi: int,
                min_ndim: int = 3,
                only: Optional[set] = None) -> Optional[Dict[str, Tensor]]:
    """Slice the time axis (dim 1) of every time-distributed tensor in a
    name -> tensor dict: ``min_ndim=3`` for features and labels ([B, T,
    ...]; static [B, F] side inputs pass through unsliced), ``min_ndim=2``
    for masks ([B, T]). ``only`` restricts the slicing to the named keys
    (the recurrent inputs)."""
    if d is None:
        return None
    return {k: (v if v is None or v.dim() < min_ndim
                or (only is not None and k not in only) else v[:, lo:hi])
            for k, v in d.items()}


class ComputationGraph(NetCommonMixin, EvalMixin, ScanFitMixin,
                       CostAnalysisMixin):
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = _dtype_of(conf.training.dtype)
        self.params: Optional[Dict[str, Dict[str, Tensor]]] = None
        self.states: Optional[Dict[str, Dict[str, Tensor]]] = None
        self.opt_state = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.last_batch_size = 0
        self.listeners: list = []
        self._tx = build_optimizer(conf.training)
        # dropout's draws: one generator on the net's device
        self._rng = torch.Generator(device=self.device).manual_seed(
            conf.training.seed)
        self._decode_fns = None
        self._paged_decode_fns: Dict[int, Any] = {}
        self._rnn_carries: Optional[Dict[str, Any]] = None
        self._infer_traces = 0   # CUDA-graph captures of _infer_fn
        self._layer_nodes = [n for n in conf.topological_order
                             if conf.nodes[n].kind == "layer"]
        # weight tying: resolve once, fail loudly at construction
        for name in self._layer_nodes:
            tied = getattr(conf.nodes[name].layer, "tied_to", None)
            if not tied:
                continue
            src = conf.nodes.get(tied)
            if src is None or src.kind != "layer":
                raise ValueError(
                    f"node {name!r}: tied_to={tied!r} does not name a "
                    "layer node in this graph")
            if "W" not in (src.layer.param_order() or []):
                raise ValueError(
                    f"node {name!r}: tied_to node {tied!r} "
                    f"({type(src.layer).__name__}) has no 'W' param to "
                    "tie to")

    # ------------------------------------------------------------------ init
    def init(self, params=None, states=None) -> "ComputationGraph":
        """Draw params from a CPU ``torch.Generator`` seeded with the
        config's seed (the same weights on every device), or take
        ``params`` (e.g. ``convert.params_from_jax``), and the layers'
        initial states, or ``states`` (``convert.states_from_jax``);
        either way they are moved to the net's device."""
        if params is None:
            gen = torch.Generator().manual_seed(self.conf.training.seed)
            params = {}
            for name in self._layer_nodes:
                layer = self.conf.nodes[name].layer
                params[name] = (layer.init_params(gen, self.dtype)
                                if layer.has_params() else {})
        if states is None:
            states = {name: self.conf.nodes[name].layer.init_state()
                      for name in self._layer_nodes}
        self.params = {n: {k: t.to(self.device) for k, t in p.items()}
                       for n, p in params.items()}
        self.states = {n: {k: t.to(self.device) for k, t in s.items()}
                       for n, s in states.items()}
        self.opt_state = self._tx.init(self.params)
        return self

    def _check_init(self):
        if self.params is None:
            raise RuntimeError("Call init() before using the network")

    def _layer_params(self, params, name: str):
        """One layer node's params, plus — for a tied head — the tied
        node's ``W`` injected as ``W_tok`` (the same tensor, not a copy)."""
        tied = getattr(self.conf.nodes[name].layer, "tied_to", None)
        if tied:
            return {**params[name], "W_tok": params[tied]["W"]}
        return params[name]

    def _shard_params(self, name: str, layer, p):
        """A layer node's params in a sharded step: its model-sharded
        leaves gathered whole where it does not consume them
        column-parallel (a tied head's embedding too)."""
        tied = getattr(layer, "tied_to", None)
        return _tp.layer_params(self, name, layer, p,
                                tied=(tied, "W_tok") if tied else None)

    def num_params(self) -> int:
        self._check_init()
        return sum(t.numel() for p in self.params.values()
                   for t in p.values())

    def _flat_order(self) -> List[Tensor]:
        """The param tensors in topological layer order, then each
        layer's ``param_order()`` (a tied head has none of its own)."""
        return [self.params[name][pname] for name in self._layer_nodes
                for pname in self.conf.nodes[name].layer.param_order()]

    def params_flat(self) -> np.ndarray:
        """Flat param vector in topological order / param order (the
        coefficients.bin contract for graphs); bf16 params come back as
        float32."""
        self._check_init()
        return flat_params(self._flat_order())

    def set_params_flat(self, flat: np.ndarray) -> None:
        """Write ``flat`` (``params_flat``'s order) into the params in
        place; a wrong length raises and leaves the net untouched."""
        self._check_init()
        set_flat_params(self._flat_order(), flat)

    def predict(self, inputs) -> np.ndarray:
        """Argmax over the first output's last axis."""
        return self.output(inputs).argmax(dim=-1).cpu().numpy()

    # ---------------------------------------------------------------- forward
    def _forward(self, params, states, inputs: Dict[str, Tensor],
                 masks: Optional[Dict[str, Tensor]] = None,
                 carries: Optional[Dict[str, Any]] = None, *,
                 train: bool = False,
                 rng: Optional[torch.Generator] = None,
                 stop_before_loss: bool = False):
        """Walk the DAG in topological order. Each node takes the mask of
        its FIRST input. Returns (activations, masks, new states).

        ``stop_before_loss``: an output node with a loss head stores its
        INPUT (the head's ``compute_loss`` consumes it), as the JAX
        container's training walk does. ``train`` turns on dropout (not in
        frozen layers), drawn from ``rng``, and, with ``training.remat``,
        runs each layer's apply (a recurrent layer's sequence pass) under
        ``remat_call``. ``carries``: optional
        per-layer-node RNN carry dict (tBPTT, rnn_time_step). When given,
        layers with ``supports_carry`` run ``scan`` from their carry, after
        their input dropout, and the new carries come back as a fourth
        value."""
        acts: Dict[str, Tensor] = {}
        out_masks: Dict[str, Optional[Tensor]] = {}
        new_states: Dict[str, Dict[str, Tensor]] = {}
        new_carries: Dict[str, Any] = {}
        output_set = set(self.conf.network_outputs)
        remat = train and self.conf.training.remat
        batch_sum_for = batch_sum_kwargs(self._batch_sum)
        # a step on a mesh's model / sp axes (parallel/tensor.py):
        # `shard[name]` marks an activation as this rank's time shard
        mesh = _tp.step_mesh(self)
        split = _tp.seq_split(mesh)
        shard: Dict[str, bool] = {}
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                acts[name] = inputs[name]
                out_masks[name] = (masks or {}).get(name)
                shard[name] = split and acts[name].dim() == 3
                continue
            in_acts = [acts[i] for i in node.inputs]
            in_mask = out_masks.get(node.inputs[0]) if node.inputs else None
            sh = bool(node.inputs) and shard[node.inputs[0]]
            if mesh is not None and any(shard[i] for i in node.inputs) and (
                    node.kind == "vertex"
                    and not isinstance(node.vertex, ElementWiseVertex)
                    or not all(shard[i] for i in node.inputs)):
                # a vertex that mixes time steps, or inputs of both kinds:
                # every input whole
                in_acts = [_tp.whole_sequence(mesh, a, None)[0]
                           if shard[i] else a
                           for i, a in zip(node.inputs, in_acts)]
                if sh and in_mask is not None:
                    in_mask = mesh.gather_seq(in_mask)
                sh = False
            shard[name] = sh
            if node.kind == "vertex":
                if isinstance(node.vertex, LastTimeStepVertex):
                    acts[name] = node.vertex.apply_masked(in_acts, in_mask)
                    out_masks[name] = None
                    continue
                ref = getattr(node.vertex, "timesteps", None)
                acts[name] = (node.vertex.apply(in_acts, acts[ref])
                              if isinstance(ref, str)
                              else node.vertex.apply(in_acts))
                out_masks[name] = in_mask
                continue
            layer = node.layer
            h = in_acts[0]
            # whole_T: the T of a whole sequence gathered for this layer
            # (by its preprocessor, or for a layer that mixes time steps),
            # whose output goes back to this rank's steps
            whole_T = None
            if node.preprocessor is not None:
                if sh:
                    h, in_mask, whole_T = _tp.whole_sequence(mesh, h,
                                                             in_mask)
                    sh = shard[name] = False
                h = node.preprocessor.transform(h, None)
                in_mask = node.preprocessor.transform_mask(in_mask, None)
            if (stop_before_loss and name in output_set
                    and hasattr(layer, "compute_loss")):
                if whole_T is not None:
                    h, in_mask, shard[name] = _tp.own_steps(
                        mesh, h, in_mask, whole_T)
                acts[name] = h          # input to the loss head
                out_masks[name] = in_mask
                new_states[name] = states[name]
                continue
            p = self._layer_params(params, name)
            if mesh is not None:
                p = self._shard_params(name, layer, p)
                if sh and not _tp.sequence_local(layer):
                    h, in_mask, whole_T = _tp.whole_sequence(mesh, h,
                                                             in_mask)
            seq_kw = _tp.seq_kwargs(layer, sh and whole_T is None)
            layer_train = train and not layer.frozen
            s = states[name]
            if carries is not None and getattr(layer, "supports_carry",
                                               False):
                c_in = carries.get(name)
                if c_in is None:
                    c_in = layer.initial_carry(h.shape[0], h.dtype, h.device)
                # scan() bypasses apply(): input dropout must still fire
                # so tBPTT training regularizes like standard BPTT
                h = layer._dropout_input(h, layer_train, rng)
                if remat:
                    acts[name], new_carries[name] = remat_call(
                        lambda _, *a, _l=layer: _l.scan(*a), None, p, h,
                        c_in, in_mask)
                else:
                    acts[name], new_carries[name] = layer.scan(p, h, c_in,
                                                               in_mask)
            else:
                def apply_fn(r, pp, hh, s_in, m, _l=layer, _t=layer_train,
                             _kw=seq_kw):
                    return _l.apply(pp, hh, state=s_in, train=_t, rng=r,
                                    mask=m, **batch_sum_for(_l), **_kw)
                acts[name], s = (remat_call(apply_fn, rng, p, h, s, in_mask)
                                 if remat else apply_fn(rng, p, h, s,
                                                        in_mask))
                if layer.frozen:
                    s = states[name]
            out_masks[name] = layer.propagate_mask(in_mask)
            if whole_T is not None:
                acts[name], out_masks[name], shard[name] = _tp.own_steps(
                    mesh, acts[name], out_masks[name], whole_T)
            new_states[name] = s
        if carries is not None:
            return acts, out_masks, new_states, new_carries
        return acts, out_masks, new_states

    def _to_tensor(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _to_input_map(self, inputs) -> Dict[str, Tensor]:
        names = self.conf.network_inputs
        if isinstance(inputs, dict):
            return {k: self._to_tensor(v) for k, v in inputs.items()}
        if isinstance(inputs, (list, tuple)):
            return {n: self._to_tensor(x) for n, x in zip(names, inputs)}
        return {names[0]: self._to_tensor(inputs)}

    def _infer_fn(self):
        """The inference forward as one function on tensors, ``(params,
        states, in_map, masks) -> [output per network output]`` (the JAX
        container's jitted ``_infer_fn`` seam, ref: CG.java:1006). It
        reads nothing but its arguments, makes no host copy and no host
        sync, so the predict scheduler can capture it into a CUDA graph;
        ``outputs()`` runs it eagerly. ``_infer_traces`` counts those
        captures (the JAX container counts its traces)."""
        def infer(params, states, in_map, masks):
            acts, _, _ = self._forward(params, states, in_map, masks)
            return [acts[o] for o in self.conf.network_outputs]
        return infer

    def outputs(self, inputs: Union[Tensor, np.ndarray, Sequence, Dict],
                mask=None) -> List[Tensor]:
        """Final activations of all output nodes (ref:
        ComputationGraph.output(...)). ``mask``: a [B, T] feature mask for
        the first input, or a name -> mask dict."""
        self._check_init()
        names = self.conf.network_inputs
        in_map = self._to_input_map(inputs)
        masks = None
        if mask is not None:
            masks = ({k: None if v is None else self._to_tensor(v)
                      for k, v in mask.items()} if isinstance(mask, dict)
                     else {names[0]: self._to_tensor(mask)})
        with torch.no_grad():
            return self._infer_fn()(self.params, self.states, in_map, masks)

    def output(self, inputs, mask=None) -> Tensor:
        return self.outputs(inputs, mask=mask)[0]

    # ------------------------------------------------------------------ loss
    def _data_loss(self, params, acts, out_masks, labels: Dict[str, Tensor],
                   label_masks) -> Tensor:
        """Sum of the output heads' losses. A head without a label mask
        takes its input's time mask when its labels are time-distributed
        (rank > 2)."""
        mesh = _tp.step_mesh(self)
        total = 0.0
        for out_name in self.conf.network_outputs:
            layer = self.conf.nodes[out_name].layer
            if not hasattr(layer, "compute_loss"):
                raise ValueError(f"Output node {out_name!r} has no loss head")
            lm = (label_masks or {}).get(out_name)
            if lm is None:
                lbl = labels[out_name]
                lm = out_masks.get(out_name) if lbl.dim() > 2 else None
            p = self._layer_params(params, out_name)
            if mesh is None:
                total = total + layer.compute_loss(
                    p, acts[out_name], labels[out_name], mask=lm)
                continue
            total = total + layer.compute_loss(
                self._shard_params(out_name, layer, p), acts[out_name],
                labels[out_name], mask=lm) * _tp.head_scale(
                    mesh, labels[out_name])
        return total

    def _regularized(self, params, data_loss, new_states):
        """The heads' losses + the L1/L2 penalty over every layer's params
        + the auxiliary losses layers surface in their state."""
        layer_list = [self.conf.nodes[n].layer for n in self._layer_nodes]
        param_list = [params[n] for n in self._layer_nodes]
        mesh = _tp.step_mesh(self)
        if mesh is None:
            return (data_loss + l1_l2_penalty(param_list, layer_list)
                    + _sum_aux_losses(new_states))
        return (data_loss
                + _tp.penalty(self, mesh, list(zip(self._layer_nodes,
                                                   param_list)), layer_list)
                + _sum_aux_losses(new_states) * _tp.replicated_scale(mesh))

    def _loss_fn(self, params, states, inputs, labels: Dict[str, Tensor],
                 masks, label_masks, rng, train=True):
        """(score, new states) of one forward walk."""
        acts, out_masks, new_states = self._forward(
            params, states, inputs, masks, train=train, rng=rng,
            stop_before_loss=True)
        total = self._data_loss(params, acts, out_masks, labels, label_masks)
        return self._regularized(params, total, new_states), new_states

    def score(self, data: Union[DataSet, MultiDataSet],
              train: bool = False) -> float:
        """The loss of ``data`` at the current params (no update)."""
        self._check_init()
        inputs, labels, masks, lmasks = self._split(data)
        with torch.no_grad():
            loss, _ = self._loss_fn(self.params, self.states, inputs, labels,
                                    masks, lmasks, rng=None, train=train)
        return float(loss)

    def _split(self, data: Union[DataSet, MultiDataSet]):
        """(inputs, labels, feature masks, label masks) name -> tensor on
        the net's device: features and masks in the net's dtype, labels
        as given. Tensors already there (``DevicePrefetchIterator``'s) are
        taken as they are, or cast on the device."""
        names_in = self.conf.network_inputs
        names_out = self.conf.network_outputs

        def label(x):
            return torch.as_tensor(x, device=self.device)

        def opt_map(names, arrays):
            if arrays is None:
                return None
            return {n: None if a is None else self._to_tensor(a)
                    for n, a in zip(names, arrays)}

        if isinstance(data, DataSet):
            return ({names_in[0]: self._to_tensor(data.features)},
                    {names_out[0]: label(data.labels)},
                    opt_map(names_in[:1], None if data.features_mask is None
                            else [data.features_mask]),
                    opt_map(names_out[:1], None if data.labels_mask is None
                            else [data.labels_mask]))
        return ({n: self._to_tensor(x)
                 for n, x in zip(names_in, data.features)},
                {n: label(x) for n, x in zip(names_out, data.labels)},
                opt_map(names_in, data.features_masks),
                opt_map(names_out, data.labels_masks))

    # ------------------------------------------------------------- train step
    def compute_gradient_and_score(self, data: Union[DataSet, MultiDataSet]
                                   ) -> Tuple[Dict[str, Dict[str, Tensor]],
                                              Tensor, Dict]:
        """(gradients, score, new states) of ``data`` at the current params
        (ref: ComputationGraph.computeGradientAndScore), training mode
        (dropout on). Gradients mirror the params; a tied head's gradient
        lands in the tied node's ``W``."""
        self._check_init()
        check_trainable(self.conf.training)
        inputs, labels, masks, lmasks = cast_batch(self.conf.training,
                                                   self._split(data))
        loss, new_states, grads = policy_value_and_grad(
            lambda p: self._loss_fn(p, self.states, inputs, labels, masks,
                                    lmasks, rng=self._rng, train=True),
            self.params, self.conf.training)
        return grads, loss, new_states

    def _step(self, grads, new_states, loss):
        """Apply one update (guarded under a sentinel) and take the new
        layer states. Returns the step's bad flag, or None."""
        layer_list = [self.conf.nodes[n].layer for n in self._layer_nodes]
        bad = self._update(grads, loss, layer_list)
        self.states = self._guard_tree(bad, self.states, new_states)
        return bad

    def _train_batch(self, data: Union[DataSet, MultiDataSet]):
        """One SGD-family step on ``data`` (the step ``fit_batch`` and a
        scan window run). Returns (loss, bad flag or None)."""
        grads, loss, new_states = self.compute_gradient_and_score(data)
        bad = self._step(grads, new_states, loss)
        self.last_grads = grads if self._collect_grads else None
        return loss, bad

    def fit_batch(self, data: Union[DataSet, MultiDataSet]):
        """One optimization step (ref: ComputationGraph.fit), or one per
        tBPTT window, or a line-search solver's run when
        ``optimization_algo`` is not SGD. Returns the loss at the step's
        starting params (the mean of the windows' losses under tBPTT) as a
        device scalar; reading it synchronizes, ``score_value`` is the
        last step's as a float. Listeners hear of each step, and the
        sentinel gets each step's flag."""
        self._check_init()
        check_trainable(self.conf.training)
        if self.conf.training.optimization_algo not in SGD_ALGOS:
            from deeplearning4j_tpu_torch.optimize.solvers import (
                solver_fit_batch,
            )
            return solver_fit_batch(self, data)
        if self._tbptt_applies(data):
            return self._fit_tbptt(data)
        # host-side span: the step's dispatch (see MultiLayerNetwork)
        with get_tracer().span("fit_batch", it=self.iteration_count + 1):
            loss, bad = self._train_batch(data)
        self.last_batch_size = data.num_examples()
        self.score_value = loss
        self.iteration_count += 1
        self._observe_sentinel(bad)
        self._notify_iteration()
        return loss

    # ------------------------------------------------------------------ tBPTT
    def _tbptt_applies(self, data: Union[DataSet, MultiDataSet]) -> bool:
        """True when ``data`` trains by truncated BPTT: the config asks for
        it, some input is a [B, T, F] series, every label is
        time-distributed and every rank-3 input a time series by its
        declared InputType. A series input that misses the rest raises."""
        if self.conf.training.backprop_type != "truncated_bptt":
            return False
        feats = ([data.features] if isinstance(data, DataSet)
                 else list(data.features))
        labels = ([data.labels] if isinstance(data, DataSet)
                  else list(data.labels))
        types = self.conf.input_types
        has_rnn_input = any(f.ndim == 3 for f in feats)
        # every label must be time-distributed, and every rank-3
        # feature a time series by its declared InputType (a CNN
        # input's [B, H, W, C] would be sliced on its height axis)
        rnn_ok = all(
            (types.get(n) is None and f.ndim == 3)
            or (types.get(n) is not None
                and (types[n].kind == "rnn" or f.ndim != 3))
            for n, f in zip(self.conf.network_inputs, feats)
            if f.ndim >= 3)
        if has_rnn_input and rnn_ok and all(y.ndim == 3 for y in labels):
            return True
        if has_rnn_input:
            raise ValueError(
                "truncated_bptt requires rank-3 (time-distributed) "
                "labels on every output and recurrent InputTypes for "
                "every rank-3 input; use backprop_type('standard') "
                "for sequence-to-one heads")
        return False

    def _tbptt_windows(self, batch, start: int, end: int):
        """Time steps [start, end) of ``_split``'s tuple (only the
        recurrent inputs are sliced)."""
        rnn = self._tbptt_rnn_inputs()
        inputs, labels, masks, lmasks = batch
        return (_time_slice(inputs, start, end, only=rnn),
                _time_slice(labels, start, end),
                _time_slice(masks, start, end, 2, rnn),
                _time_slice(lmasks, start, end, 2))

    def _tbptt_length(self, batch) -> int:
        """The time length of ``_split``'s tuple (its recurrent inputs')."""
        rnn = self._tbptt_rnn_inputs()
        return next(v.shape[1] for n, v in batch[0].items() if n in rnn)

    def _initial_carries(self, B: int, dtype):
        """Zero carries for a tBPTT batch of ``B`` rows."""
        return {name: self.conf.nodes[name].layer.initial_carry(
                    B, dtype, self.device)
                for name in self._layer_nodes
                if getattr(self.conf.nodes[name].layer, "supports_carry",
                           False)}

    def _tbptt_rnn_inputs(self) -> set:
        """Network inputs whose time axis tBPTT may slice: declared-rnn
        InputTypes, or untyped inputs (``fit_batch`` admits untyped inputs
        only when they are rank-3 time series)."""
        return {n for n in self.conf.network_inputs
                if self.conf.input_types.get(n) is None
                or self.conf.input_types[n].kind == "rnn"}

    def _tbptt_loss(self, params, inputs, labels, masks, lmasks, carries):
        """One window's (score, (new states, new carries)); with
        ``tbptt_bwd_length`` < ``tbptt_fwd_length`` the window's head runs
        without a graph and still trains the output heads through its
        loss, as ``MultiLayerNetwork._tbptt_loss`` (ref:
        ComputationGraph.doTruncatedBPTT:2042)."""
        t = self.conf.training
        fwd = t.tbptt_fwd_length
        bwd = t.tbptt_bwd_length or fwd
        rnn = self._tbptt_rnn_inputs()
        T = next(v.shape[1] for n, v in inputs.items() if n in rnn)
        split = max(T - bwd, 0) if bwd < fwd else 0
        if split == 0:
            acts, om, new_states, new_carries = self._forward(
                params, self.states, inputs, masks, carries, train=True,
                rng=self._rng, stop_before_loss=True)
            loss = self._data_loss(params, acts, om, labels, lmasks)
        else:
            with torch.no_grad():
                acts1, om1, states1, carries1 = self._forward(
                    params, self.states, _time_slice(inputs, 0, split,
                                                     only=rnn),
                    _time_slice(masks, 0, split, 2, rnn), carries,
                    train=True, rng=self._rng, stop_before_loss=True)
            acts2, om2, new_states, new_carries = self._forward(
                params, states1, _time_slice(inputs, split, T, only=rnn),
                _time_slice(masks, split, T, 2, rnn), carries1, train=True,
                rng=self._rng, stop_before_loss=True)
            # per-timestep losses sum over time: head + tail is the
            # window's loss
            loss = (self._data_loss(params, acts1, om1,
                                    _time_slice(labels, 0, split),
                                    _time_slice(lmasks, 0, split, 2))
                    + self._data_loss(params, acts2, om2,
                                      _time_slice(labels, split, T),
                                      _time_slice(lmasks, split, T, 2)))
        return (self._regularized(params, loss, new_states),
                (new_states, new_carries))

    def _fit_tbptt(self, data: Union[DataSet, MultiDataSet]):
        """Truncated BPTT over time windows, carrying per-node RNN state
        (ref: ComputationGraph.doTruncatedBPTT:2042-2103): one optimizer
        step a window, the carries starting at zeros in the training dtype
        (the compute dtype under a mixed policy, ROADMAP C14; see
        ``MultiLayerNetwork._fit_tbptt``) and detached between windows, a
        bad window under a sentinel leaving them as they were. Returns the
        mean of the windows' losses."""
        training = self.conf.training
        fwd = training.tbptt_fwd_length
        inputs, labels, masks, lmasks = cast_batch(training,
                                                   self._split(data))
        batch = (inputs, labels, masks, lmasks)
        T = self._tbptt_length(batch)
        B = next(iter(inputs.values())).shape[0]
        carries = self._initial_carries(
            B, compute_dtype(training, self.dtype))
        self.last_grads = None   # the tBPTT step collects no gradients
        total, windows = 0.0, 0
        for start in range(0, T, fwd):
            end = min(start + fwd, T)
            loss, (new_states, new_carries), grads = policy_value_and_grad(
                lambda p: self._tbptt_loss(
                    p, *self._tbptt_windows(batch, start, end), carries),
                self.params, training)
            bad = self._step(grads, new_states, loss)
            carries = self._guard_tree(bad, carries, new_carries)
            total = total + loss    # on the device: no sync per window
            windows += 1
            self.iteration_count += 1
            self.score_value = loss
            self._observe_sentinel(bad)
            self._notify_iteration()
        self.last_batch_size = data.num_examples()
        return total / max(windows, 1)

    def fit(self, data, epochs: int = 1, use_async: bool = True,
            scan_window: int = 1) -> "ComputationGraph":
        """(ref: ComputationGraph.fit(DataSetIterator):701-771). ``data``:
        a DataSet, a MultiDataSet or a DataSetIterator, for ``epochs``;
        ``use_async`` and ``scan_window`` as in
        ``MultiLayerNetwork.fit``."""
        self._check_init()
        if isinstance(data, MultiDataSet):
            for _ in range(epochs):
                self.fit_batch(data)
            return self
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        if not isinstance(data, DataSetIterator):
            raise TypeError(f"fit takes a DataSet, a MultiDataSet or a "
                            f"DataSetIterator, not {type(data).__name__}")
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

    # ------------------------------------------------------- rnn statefulness
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, inputs):
        """Stateful streaming inference (ref: ComputationGraph.rnnTimeStep
        — keeps per-vertex carries between calls). Inputs as in
        ``outputs()``; [B, F] inputs are one timestep and are squeezed
        back. Returns the single output activation, or a list for
        multi-output graphs."""
        self._check_init()
        in_map = self._to_input_map(inputs)
        squeeze = all(v.dim() == 2 for v in in_map.values())
        if squeeze:
            in_map = {k: v[:, None, :] for k, v in in_map.items()}
        if self._rnn_carries is None:
            B = next(iter(in_map.values())).shape[0]
            self._rnn_carries = {
                name: self.conf.nodes[name].layer.initial_carry(
                    B, self.dtype, self.device)
                for name in self._layer_nodes
                if getattr(self.conf.nodes[name].layer, "supports_carry",
                           False)}
        with torch.no_grad():
            acts, _, _, new_carries = self._forward(
                self.params, self.states, in_map, carries=self._rnn_carries)
        self._rnn_carries = {**self._rnn_carries, **new_carries}
        outs = [acts[o] for o in self.conf.network_outputs]
        if squeeze:
            outs = [o[:, 0] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    # ----------------------------------------------------- incremental decode
    # Token-level serving: per-request KV caches of static
    # [rows, H, max_len, D] shape are threaded through the step; every row
    # masks its own prefix.

    def kv_cache_nodes(self) -> List[str]:
        """Layer nodes that thread a KV cache (causal attention)."""
        return [n for n in self._layer_nodes
                if getattr(self.conf.nodes[n].layer,
                           "supports_kv_cache", False)]

    def decode_max_len(self) -> int:
        """Static cache length: the learned position table's capacity."""
        for n in self._layer_nodes:
            ml = getattr(self.conf.nodes[n].layer, "max_timesteps", 0)
            if ml:
                return int(ml)
        for t in self.conf.input_types.values():
            if t is not None and t.kind == "rnn" and t.timesteps:
                return int(t.timesteps)
        raise ValueError(
            "decode needs a static max sequence length (a "
            "PositionalEmbeddingLayer max_timesteps or a recurrent "
            "InputType with fixed timesteps)")

    def decode_vocab(self) -> int:
        t = self.conf.input_types.get(self.conf.network_inputs[0])
        if t is None or t.kind != "rnn":
            raise ValueError("decode needs a recurrent input type")
        return int(t.size)

    def _check_decodable(self) -> None:
        """Fail loudly when the graph is not an incremental decoder:
        single input/output, every time-mixing layer a causal attention
        (KV cache) or the positional embedding, the rest per-timestep."""
        if len(self.conf.network_inputs) != 1 \
                or len(self.conf.network_outputs) != 1:
            raise ValueError("incremental decode supports single-input/"
                             "single-output graphs")
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "vertex":
                if not isinstance(node.vertex, ElementWiseVertex):
                    raise ValueError(
                        f"vertex {name!r} ({type(node.vertex).__name__}) "
                        "is not per-timestep-local; cannot decode "
                        "incrementally")
                continue
            if node.kind != "layer":
                continue
            layer = node.layer
            if isinstance(layer, SelfAttentionLayer):
                if not layer.supports_kv_cache:
                    raise ValueError(
                        f"attention node {name!r} is not causal — "
                        "incremental decode would change its output")
                continue
            ok = (hasattr(layer, "decode_step")
                  or isinstance(layer, (LayerNormalization,
                                        TimeDistributedLayer,
                                        RnnOutputLayer)))
            if not ok:
                raise ValueError(
                    f"node {name!r} ({type(layer).__name__}) is not "
                    "known to be per-timestep-local; cannot decode "
                    "incrementally")

    def init_decode_cache(self, rows: int, max_len: Optional[int] = None
                          ) -> Dict[str, Dict[str, Tensor]]:
        """Fresh zeroed KV caches for a ``rows``-row decode bucket — one
        {k, v} pair per causal-attention node, on the net's device."""
        if max_len is None:
            max_len = self.decode_max_len()
        out = {}
        for n in self.kv_cache_nodes():
            shape = self.conf.nodes[n].layer.cache_shape(rows, max_len)
            out[n] = {kv: torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
                      for kv in ("k", "v")}
        return out

    def decode_cache_bytes(self, rows: int,
                           max_len: Optional[int] = None) -> int:
        """Device footprint of a ``rows``-row bucket's KV caches — what
        the serving engine budgets eviction against."""
        if max_len is None:
            max_len = self.decode_max_len()
        itemsize = torch.tensor([], dtype=self.dtype).element_size()
        total = 0
        for n in self.kv_cache_nodes():
            shape = self.conf.nodes[n].layer.cache_shape(rows, max_len)
            total += 2 * int(np.prod(shape)) * itemsize
        return total

    def _incremental_forward(self, params, states, x, caches, positions,
                             lengths=None):
        """One DAG walk shared by prefill (``lengths`` given, x the padded
        [B, T, V] prompt block) and decode (x the [B, 1, V] current token,
        ``positions`` each row's position). Caches are updated in place.
        Returns (output activation, caches)."""
        acts: Dict[str, Tensor] = {self.conf.network_inputs[0]: x}
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            in_acts = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(in_acts)
                continue
            layer = node.layer
            h = in_acts[0]
            if node.preprocessor is not None:
                h = node.preprocessor.transform(h, None)
            p = self._layer_params(params, name)
            if getattr(layer, "supports_kv_cache", False):
                cache = caches[name]
                if lengths is not None:
                    h, _, _ = layer.prefill(p, h, cache["k"], cache["v"],
                                            lengths)
                else:
                    h, _, _ = layer.decode_step(p, h, cache["k"],
                                                cache["v"], positions)
            elif lengths is None and hasattr(layer, "decode_step"):
                h = layer.decode_step(p, h, positions)
            else:
                h, _ = layer.apply(p, h, state=states[name], mask=None)
            acts[name] = h
        return acts[self.conf.network_outputs[0]], caches

    def decode_fns(self):
        """The two step functions of token-level serving:

        - ``prefill(params, states, caches, x, lengths)`` -> ``(probs
          [B, V] at each row's last prompt position, caches)`` — x is the
          pow2-padded one-hot prompt block [B, T, V];
        - ``decode(params, states, caches, x, positions)`` -> ``(probs
          [B, V], caches)`` — x is the [B, 1, V] one-hot of each row's
          current token.

        Both update ``caches`` in place and return it."""
        if self._decode_fns is None:
            self._check_decodable()

            @torch.no_grad()
            def prefill(params, states, caches, x, lengths):
                out, caches = self._incremental_forward(
                    params, states, x, caches, None, lengths=lengths)
                rows = torch.arange(x.shape[0], device=x.device)
                return out[rows, lengths - 1], caches

            @torch.no_grad()
            def decode(params, states, caches, x, positions):
                out, caches = self._incremental_forward(
                    params, states, x, caches, positions)
                return out[:, 0, :], caches

            self._decode_fns = (prefill, decode)
        return self._decode_fns

    # ------------------------------------------------- block-paged decode
    # The serving engine stores KV state as a fixed pool of
    # [n_pages, H, page_len, D] pages per attention node plus a per-row
    # page table. The paged step gathers each row's pages into the EXACT
    # dense [rows, H, max_len, D] shape the unmodified decode path
    # expects (page_len must divide max_len), runs it, and scatters the
    # one new K/V token per row back into its write page, in place.

    def kv_page_len(self, page_len: Optional[int] = None) -> int:
        """Resolve (and validate) the KV page length: must divide the
        static ``decode_max_len`` so pages tile a row exactly."""
        ml = self.decode_max_len()
        if page_len is None:
            return default_kv_page_len(ml)
        page_len = int(page_len)
        if page_len < 1 or ml % page_len:
            raise ValueError(
                f"kv_page_len={page_len} must divide the static decode "
                f"max_len {ml} (pages must tile a cache row exactly)")
        return page_len

    def init_kv_page_pool(self, n_pages: int, page_len: int
                          ) -> Dict[str, Dict[str, Tensor]]:
        """Fresh zeroed page pool on the net's device — one {k, v} pair
        of ``[n_pages, H, page_len, D]`` tensors per causal-attention
        node. A physical page id addresses ONE page group: the same slot
        across every node's k and v tensors."""
        out = {}
        for n in self.kv_cache_nodes():
            shape = self.conf.nodes[n].layer.cache_shape(n_pages, page_len)
            out[n] = {kv: torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
                      for kv in ("k", "v")}
        return out

    def kv_page_group_bytes(self, page_len: int) -> int:
        """Device footprint of ONE page group (k + v, ``page_len``
        positions, across every causal-attention node) — the eviction
        granularity the paged serving engine budgets against."""
        return self.decode_cache_bytes(1, page_len)

    def paged_decode_fn(self, page_len: Optional[int] = None):
        """The paged decode step the serving engine captures per row
        bucket:

        ``paged_decode(params, states, pool, x, positions, page_table)
        -> (probs [rows, V], pool)`` — ``page_table`` ``[rows, max_len //
        page_len]`` int64, ``positions`` ``[rows]`` int64. Gather -> the
        dense ``decode`` -> scatter of each row's one new K/V token keeps
        the attention math untouched. The pool is updated IN PLACE (the
        JAX step donates it and returns a new one): the returned pool is
        the same tensors."""
        page_len = self.kv_page_len(page_len)
        cached = self._paged_decode_fns.get(page_len)
        if cached is not None:
            return cached
        _, decode = self.decode_fns()   # validates decodability

        @torch.no_grad()
        def paged_decode(params, states, pool, x, positions, page_table):
            caches = {n: {k: gather_kv_pages(v, page_table)
                          for k, v in kv.items()}
                      for n, kv in pool.items()}
            probs, new_caches = decode(params, states, caches, x,
                                       positions)
            rows = torch.arange(x.shape[0], device=x.device)
            for n, kv in pool.items():
                for k, v in kv.items():
                    scatter_kv_token(v, new_caches[n][k][rows, :, positions],
                                     page_table, positions)
            return probs, pool

        self._paged_decode_fns[page_len] = paged_decode
        return paged_decode
