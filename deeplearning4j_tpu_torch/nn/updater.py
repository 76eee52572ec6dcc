"""Updaters: gradient post-processing and update rules (the JAX package's
``nn/updater.py``), with optax's update formulas written out in torch.

The pipeline is the JAX package's: frozen-layer mask -> gradient
normalization/clipping (:func:`normalize_gradients`) -> the update rule
(:func:`build_optimizer`) -> per-layer learning-rate scaling -> ``params +
updates``. L1/L2 enters through the loss (:func:`l1_l2_penalty`), so the
gradient already carries it. Learning-rate policies are
:func:`make_lr_schedule`.

The update rules follow optax 0.2.6 term by term, not ``torch.optim``:
Adam's bias correction divides each moment (``m / (1 - b1^t)``) and eps
sits outside the square root; RMSProp puts eps *inside* it
(``g / sqrt(nu + eps)``, optax's ``eps_in_sqrt``); Adagrad's accumulator
starts at 0.1; Adadelta runs at a fixed learning rate of 1.0; every
schedule reads the count of updates already taken (the first update uses
``lr(0)``). ``minimize=False`` negates the gradient first.

Gradients, params and optimizer state are nested containers of tensors:
a dict node -> param name -> tensor (``ComputationGraph``) or a list of
per-layer dicts (``MultiLayerNetwork``). The state is a dict
``{"count": updates taken, <slot>: a container mirroring the params}``.
Unlike the JAX package, which returns new trees, :func:`compute_updates`
updates the params and the state **in place** under ``torch.no_grad()``,
so a step holds no second copy of either. ``Updater.optax_leaves`` /
``load_optax_leaves`` map the state to and from optax's flattened leaves,
the layout of a checkpoint's ``updaterState.bin``.

Mixed precision is the JAX package's policy: :class:`PrecisionPolicy`
names the compute and master dtypes, :func:`cast_floats` casts a
container's float tensors, and :func:`precision_value_and_grad` folds the
step's cast seams into the gradient: params cast to the compute dtype at
the step boundary, the loss cast back to f32 before it leaves the loss
function (and scaled by ``loss_scale`` around the differentiation), the
gradients cast to f32 the moment autograd returns them. The f32 masters
stay the tensors :func:`compute_updates` updates in place. The fp32
preset adds no cast: its step is the plain ``value_and_grad``.

The step count is a host int, so an unguarded step reads no device
value. Under a divergence sentinel it is an int32 device scalar instead
(:meth:`Updater.device_count`): a guarded step that went non-finite
must not advance it, and the host learns that only ``lag`` steps later,
so the count, the learning-rate schedule and the bias corrections are
then computed on the device and the guard restores the count in place
with the params and moments.

The ZeRO helpers (:class:`ZeroLayout`, :func:`shard_updater_state`,
:func:`gather_updater_state`, :func:`compute_updates_sharded`) serve the
parallel trainers' ``weight_update_sharding="zero1"/"zero2"``: each
state leaf becomes this rank's row of its flattened, pad-to-divisible
``(dp, chunk)`` view, and the update runs on those rows with the values
:func:`compute_updates` computes on the whole tensors (every rule is
elementwise; the clipping norms are sums of squares all-reduced over the
rows).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from deeplearning4j_tpu_torch.nn.conf.builder import (
    TrainingConfig, UpdaterConfig,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# containers of tensors
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a dict/list container (and the matching
    leaves of ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Tensor]:
    """The leaves in JAX's order (dict keys sorted), so sums over them
    run in the JAX package's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# precision policy
# ---------------------------------------------------------------------------

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


@dataclass(frozen=True)
class PrecisionPolicy:
    """The matmul/update precision policy. ``compute_dtype`` is what the
    forward and backward run in, ``params_dtype`` the master weights'
    (and the gradients' and the loss's), ``loss_scale`` an optional
    static scale of the loss around the differentiation."""

    compute_dtype: str = "float32"
    params_dtype: str = "float32"
    loss_scale: Optional[float] = None

    #: accepted shorthand -> (compute_dtype, params_dtype)
    PRESETS = {
        "fp32": ("float32", "float32"),
        "float32": ("float32", "float32"),
        "bf16": ("bfloat16", "float32"),
        "bfloat16": ("bfloat16", "float32"),
        "fp16": ("float16", "float32"),
        "float16": ("float16", "float32"),
    }

    def __post_init__(self):
        for field_name in ("compute_dtype", "params_dtype"):
            dt = getattr(self, field_name)
            if dt not in _FLOAT_DTYPES:
                raise ValueError(
                    f"precision {field_name} must be a float dtype, "
                    f"got {dt!r}")
        if self.loss_scale is not None and not self.loss_scale > 0:
            raise ValueError(
                f"loss_scale must be positive, got {self.loss_scale!r}")

    @property
    def mixed(self) -> bool:
        """True when the step needs cast seams (compute != master)."""
        return (self.compute_dtype != self.params_dtype
                or self.compute_dtype != "float32")

    @staticmethod
    def parse(value: Union["PrecisionPolicy", str, None],
              loss_scale: Optional[float] = None) -> "PrecisionPolicy":
        """None / "fp32" / "bf16" / a dtype name / an instance."""
        if value is None:
            return PrecisionPolicy(loss_scale=loss_scale)
        if isinstance(value, PrecisionPolicy):
            return value
        key = str(value).lower()
        compute, params = PrecisionPolicy.PRESETS.get(key, (key, "float32"))
        return PrecisionPolicy(compute_dtype=compute, params_dtype=params,
                               loss_scale=loss_scale)

    @staticmethod
    def of(training: TrainingConfig) -> "PrecisionPolicy":
        """The policy ``training.precision`` and ``training.loss_scale``
        name."""
        return PrecisionPolicy.parse(training.precision,
                                     loss_scale=training.loss_scale)


def torch_dtype(name: str) -> torch.dtype:
    """A float dtype's name -> the torch dtype."""
    return getattr(torch, name)


def cast_floats(tree, dtype):
    """Every floating tensor of ``tree`` cast to ``dtype``; integer and
    bool tensors (labels as ids, step counts) and None pass through."""
    dtype = torch_dtype(dtype) if isinstance(dtype, str) else dtype

    def cast(x):
        if isinstance(x, Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


def precision_value_and_grad(loss_fn, params, policy: PrecisionPolicy,
                             value_and_grad):
    """``value_and_grad(loss_fn, params)`` with the policy's cast seams
    folded in: ``loss_fn(leaves) -> (loss, aux)`` runs on the params cast
    to the compute dtype, its loss is cast to the master dtype before it
    leaves (so the backward's seed, the reported loss and the sentinel
    see f32), the loss is multiplied by ``loss_scale`` for the
    differentiation, and the gradients come back in the master dtype,
    divided by the scale. Returns ``(loss, aux, grads)``.

    A pure-fp32 policy calls ``value_and_grad`` as it is: no cast, the
    step bitwise the one before the policy existed."""
    if not policy.mixed:
        return value_and_grad(loss_fn, params)
    cdt = torch_dtype(policy.compute_dtype)
    pdt = torch_dtype(policy.params_dtype)
    scale = policy.loss_scale
    reported = []

    def seamed(leaves):
        loss, aux = loss_fn(leaves)
        loss = loss.to(pdt)
        reported.append(loss.detach())
        return (loss * scale if scale else loss), aux

    _, aux, grads = value_and_grad(seamed, cast_floats(params, cdt))
    grads = cast_floats(grads, pdt)
    if scale:
        grads = tree_map(lambda g: g / scale, grads)
    return reported[-1], aux, grads


# ---------------------------------------------------------------------------
# learning-rate policies and update rules
# ---------------------------------------------------------------------------

def make_lr_schedule(u: UpdaterConfig) -> Callable:
    """updates taken -> learning rate (DL4J's LearningRatePolicy). The
    count is a host int (a Python float comes back) or an int32 device
    scalar under a guard (an f64 device scalar comes back, computed as the
    host computes it and without a host read)."""
    base = u.learning_rate
    policy = (u.lr_policy or "none").lower()
    rate, power, steps = (u.lr_policy_decay_rate, u.lr_policy_power,
                          u.lr_policy_steps)
    if policy == "none":
        return lambda step: base
    if policy == "exponential":
        return lambda step: base * rate ** _f64(step)
    if policy == "inverse":
        return lambda step: base / (1.0 + rate * _f64(step)) ** power
    if policy == "poly":
        def poly(step):
            left = 1.0 - _f64(step) / max(steps, 1.0)
            left = (left.clamp(min=0.0) if isinstance(left, Tensor)
                    else max(left, 0.0))
            return base * left ** power
        return poly
    if policy == "sigmoid":
        def sigmoid(step):
            z = -rate * (_f64(step) - steps)
            return base / (1.0 + (torch.exp(z) if isinstance(z, Tensor)
                                  else math.exp(z)))
        return sigmoid
    if policy == "step":
        def stepwise(step):
            n = _f64(step) / steps
            return base * rate ** (torch.floor(n) if isinstance(n, Tensor)
                                   else math.floor(n))
        return stepwise
    if policy == "schedule":
        sched = sorted((u.lr_schedule or {}).items())
        if not sched:
            return lambda step: base
        bounds = [k for k, _ in sched]
        values = [base] + [v for _, v in sched]

        def scheduled(step):
            if not isinstance(step, Tensor):
                return values[bisect.bisect_right(bounds, step)]
            # values[number of bounds <= step], as bisect_right counts
            lr = torch.full((), base, dtype=torch.float64,
                            device=step.device)
            for k, v in sched:
                lr = torch.where(step >= k, v, lr)
            return lr
        return scheduled
    raise ValueError(f"Unknown lr policy {policy!r}")


def _f64(step):
    """A device count as f32 (JAX's int32 count promotes so); a host int
    as it is."""
    return step.float() if isinstance(step, Tensor) else step


def _moment(t: Tensor, g: Tensor, decay: float) -> Tensor:
    """optax's ``(1 - decay) * g + decay * t``, into ``t``."""
    return t.mul_(decay).add_((1 - decay) * g)


def _bias_correction(decay: float, count) -> Tensor:
    """``1 - decay ** count``, taken in f32 as optax takes it, once a step:
    on the host (a CPU scalar) for an int count, on the device for a
    device count."""
    if isinstance(count, Tensor):
        # the host's f32 power: ATen squares and cubes by products, and
        # otherwise rounds the power (taken here in f64) to f32
        base = torch.full((), decay, dtype=torch.float32,
                          device=count.device)
        power = (base.double() ** count.double()).float()
        power = torch.where(count == 2, base * base, torch.where(
            count == 3, base * base * base, power))
        return 1 - power
    return 1 - torch.tensor(decay, dtype=torch.float32) ** count


def _bias_corrected(t: Tensor, corr: Tensor) -> Tensor:
    """``t`` over a moment's bias correction (``_bias_correction``)."""
    return t / corr.to(t.dtype)


class Updater:
    """One update rule: ``init(params)`` -> state, ``update(grads, state)``
    -> updates (the state is advanced in place)."""

    SLOTS = {"sgd": (), "none": (), "nesterovs": ("trace",),
             "adam": ("mu", "nu"), "adamax": ("mu", "nu"),
             "adagrad": ("sum_of_squares",), "adadelta": ("e_g", "e_x"),
             "rmsprop": ("nu",)}

    def __init__(self, u: UpdaterConfig, minimize: bool = True):
        self.name = u.name.lower()
        if self.name not in self.SLOTS:
            raise ValueError(f"Unknown updater {u.name!r}")
        self.u = u
        self.minimize = minimize
        self.lr = make_lr_schedule(u)

    def init(self, params) -> Dict:
        fill = 0.1 if self.name == "adagrad" else 0.0
        state = {"count": 0}
        for slot in self.SLOTS[self.name]:
            state[slot] = tree_map(lambda p: torch.full_like(p, fill), params)
        return state

    @staticmethod
    def device_count(state: Dict, device) -> None:
        """Hold ``state``'s count as an int32 scalar on ``device`` (a
        guarded step's), in place of a host int."""
        if not isinstance(state["count"], Tensor):
            state["count"] = torch.full((), state["count"],
                                        dtype=torch.int32, device=device)

    @staticmethod
    def host_count(state: Dict) -> None:
        """Hold ``state``'s count as a host int again (reads the device
        once)."""
        if isinstance(state["count"], Tensor):
            state["count"] = int(state["count"])

    def update(self, grads, state: Dict):
        """The updates to add to the params for ``grads``. A device count
        is advanced in place, so a guard that restores it restores the
        schedule's position too."""
        u, count = self.u, state["count"]
        # adadelta runs at lr 1.0 and takes no schedule, as optax.adadelta
        # with learning_rate=1.0 does
        step = -1.0 if self.name == "adadelta" else -self.lr(count)
        if isinstance(count, Tensor):
            count = count + 0        # this step's count, before the advance
            state["count"].add_(1)
        else:
            state["count"] = count + 1
        slots = [state[s] for s in self.SLOTS[self.name]]
        if self.name in ("adam", "adamax"):   # once a step, not a tensor
            corr1 = _bias_correction(u.beta1, count + 1)
        if self.name == "adam":
            corr2 = _bias_correction(u.beta2, count + 1)

        def leaf(g, *st):
            if not self.minimize:
                g = g * -1.0
            if self.name == "nesterovs":
                (tr,) = st
                tr.mul_(u.momentum).add_(g)
                g = g + u.momentum * tr
            elif self.name == "adam":
                mu, nu = st
                _moment(mu, g, u.beta1)
                _moment(nu, g ** 2, u.beta2)
                g = _bias_corrected(mu, corr1) / (
                    torch.sqrt(_bias_corrected(nu, corr2))
                    + u.epsilon)
            elif self.name == "adamax":
                mu, nu = st
                _moment(mu, g, u.beta1)
                torch.maximum(g.abs() + u.epsilon, u.beta2 * nu, out=nu)
                g = _bias_corrected(mu, corr1) / nu
            elif self.name == "adagrad":
                (sos,) = st
                sos.add_(g * g)
                g = torch.where(sos > 0, torch.rsqrt(sos + u.epsilon),
                                0.0) * g
            elif self.name == "adadelta":
                e_g, e_x = st
                _moment(e_g, g ** 2, u.rho)
                g = (torch.sqrt(e_x + u.epsilon)
                     / torch.sqrt(e_g + u.epsilon)) * g
                _moment(e_x, g ** 2, u.rho)
            elif self.name == "rmsprop":
                (nu,) = st
                _moment(nu, g ** 2, u.rho)
                g = g * torch.rsqrt(nu + u.epsilon)
            return step * g

        return tree_map(leaf, grads, *slots)


    # ------------------------------------------------ optax's leaf order
    def optax_layout(self) -> List[str]:
        """The state's entries in the order ``jax.tree_util`` flattens the
        JAX package's optax state (optax 0.2.6): ``"count"`` for each
        int32 step count, a slot name for each moment tree. Adam and
        Adamax keep their own count before the moments, and every
        schedule's ``scale_by_learning_rate`` keeps one after them;
        Adadelta runs at a float learning rate of 1.0, so it keeps no
        count. ``minimize=False``'s ``scale(-1.0)`` adds no leaf."""
        if self.name in ("adam", "adamax"):
            return ["count", "mu", "nu", "count"]
        if self.name == "adadelta":
            return ["e_g", "e_x"]
        return [*self.SLOTS[self.name], "count"]

    def optax_paths(self) -> List[str]:
        """Each ``optax_layout`` entry's path in the JAX package's optax
        state, as its sharded checkpoint keys them (``parallel/
        checkpoint.py``'s ``_leaf_key``): the chain element, then the
        state field. ``minimize=False`` chains ``scale(-1.0)`` in front,
        so every path moves under element 1."""
        if self.name in ("adam", "adamax"):
            paths = ["0/.count", "0/.mu", "0/.nu", "1/.count"]
        elif self.name == "adadelta":
            paths = ["1/.e_g", "1/.e_x"]
        else:
            paths = [f"0/.{slot}" for slot in self.SLOTS[self.name]]
            paths.append("1/.count")
        return paths if self.minimize else ["1/" + p for p in paths]

    def optax_leaves(self, state: Dict) -> List[Tensor]:
        """``state`` as optax's leaves: each count an int32 scalar (a
        device count is copied to the host), each moment tree's tensors in
        ``tree_leaves`` order (dict keys sorted at every level)."""
        out = []
        for entry in self.optax_layout():
            if entry == "count":
                out.append(torch.as_tensor(state["count"]).to(
                    "cpu", torch.int32).reshape(()))
            else:
                out.extend(tree_leaves(state[entry]))
        return out

    @torch.no_grad()
    def load_optax_leaves(self, state: Dict, leaves: List[Tensor]) -> None:
        """The inverse of :meth:`optax_leaves`: the moments are written
        into ``state``'s tensors in place, and ``state["count"]`` is read
        from the first count leaf (0 where the layout keeps none; a device
        count is written in place). The leaf count and every leaf's size
        are checked before anything is written."""
        targets = []
        for entry in self.optax_layout():
            targets.extend([None] if entry == "count"
                           else tree_leaves(state[entry]))
        if len(leaves) != len(targets):
            raise ValueError(f"{self.name}: {len(leaves)} updater leaves, "
                             f"the state has {len(targets)}")
        for leaf, dst in zip(leaves, targets):
            want = 1 if dst is None else dst.numel()
            if leaf.numel() != want:
                raise ValueError(f"{self.name}: an updater leaf of "
                                 f"{leaf.numel()} values where the state "
                                 f"has {want}")
        counts = [int(leaf.reshape(())) for leaf, dst in zip(leaves, targets)
                  if dst is None]
        for leaf, dst in zip(leaves, targets):
            if dst is not None:
                dst.copy_(leaf.reshape(dst.shape))
        count = counts[0] if counts else 0
        if isinstance(state["count"], Tensor):
            state["count"].fill_(count)
        else:
            state["count"] = count


def build_optimizer(training: TrainingConfig) -> Updater:
    """UpdaterConfig -> the update rule (sgd, nesterovs, adam, adamax,
    adagrad, adadelta, rmsprop, none = sgd), ascending the objective when
    ``training.minimize`` is False."""
    return Updater(training.updater, minimize=training.minimize)


# ---------------------------------------------------------------------------
# gradient post-processing
# ---------------------------------------------------------------------------

def _global_norm(tree) -> Tensor:
    return torch.sqrt(sum((l * l).sum() for l in tree_leaves(tree)) + 1e-12)


def normalize_gradients(grads, training: TrainingConfig):
    """Gradient normalization/clipping before the update rule (DL4J's
    GradientNormalization). For a list of per-layer dicts the "per layer"
    kinds act per layer; for a graph's dict they act on the whole tree,
    as in the JAX package."""
    kind = (training.gradient_normalization or "none").lower()
    t = training.gradient_normalization_threshold
    if kind in ("none", ""):
        return grads

    def per_layer(fn):
        if isinstance(grads, list):
            return [fn(g) for g in grads]
        return fn(grads)

    if kind == "renormalizel2perlayer":
        def renorm_layer(g):
            n = _global_norm(g)
            return tree_map(lambda x: x / n, g)
        return per_layer(renorm_layer)
    if kind == "renormalizel2perparamtype":
        return tree_map(lambda x: x / torch.sqrt((x * x).sum() + 1e-12),
                        grads)
    if kind == "clipelementwiseabsolutevalue":
        return tree_map(lambda x: x.clamp(-t, t), grads)
    if kind == "clipl2perlayer":
        def clip_layer(g):
            n = _global_norm(g)
            scale = torch.where(n > t, t / n, 1.0)
            return tree_map(lambda x: x * scale, g)
        return per_layer(clip_layer)
    if kind == "clipl2perparamtype":
        def clip_param(x):
            n = torch.sqrt((x * x).sum() + 1e-12)
            return x * torch.where(n > t, t / n, 1.0)
        return tree_map(clip_param, grads)
    raise ValueError(f"Unknown gradient normalization {kind!r}")


def l1_l2_penalty(params, layers):
    """Score regularization: the sum over layers of 0.5 l2 ||W||^2 +
    l1 |W| (``params`` a list of per-layer dicts aligned with
    ``layers``). 0.0 when no layer regularizes."""
    total = 0.0
    for layer, p in zip(layers, params):
        if not p:
            continue
        reg = layer.regularization()
        for name, arr in p.items():
            l1, l2 = reg.get(name, (0.0, 0.0))
            if l2:
                total = total + 0.5 * l2 * (arr * arr).sum()
            if l1:
                total = total + l1 * arr.abs().sum()
    return total


def _zip_layers(tree, layers):
    """Pair each layer with its per-layer subtree: ``tree`` is a list
    aligned with ``layers`` or a dict keyed by the layer's node name."""
    if isinstance(tree, dict):
        by_name = {l.name: l for l in layers}
        return [(by_name[k], k, v) for k, v in tree.items()]
    return [(l, i, v) for i, (l, v) in enumerate(zip(layers, tree))]


def mask_frozen(grads, layers):
    """Zero frozen layers' gradients before clipping and updating (so they
    neither skew a global norm nor accumulate optimizer moments)."""
    if not any(l.frozen for l in layers):
        return grads
    out = {} if isinstance(grads, dict) else [None] * len(layers)
    for layer, key, g in _zip_layers(grads, layers):
        out[key] = tree_map(torch.zeros_like, g) if layer.frozen else g
    return out


def per_layer_lr_scale(updates, layers, base_lr: float):
    """Per-layer learning-rate override: scale each layer's update by
    layer.learning_rate / base_lr (every supported rule is linear in lr)."""
    if not any(l.learning_rate is not None for l in layers):
        return updates
    scaled = {} if isinstance(updates, dict) else [None] * len(layers)
    for layer, key, upd in _zip_layers(updates, layers):
        if layer.learning_rate is not None and base_lr > 0:
            s = layer.learning_rate / base_lr
            upd = tree_map(lambda x: x * s, upd)
        scaled[key] = upd
    return scaled


@torch.no_grad()
def compute_updates(tx: Updater, grads, opt_state, params, layers,
                    training: TrainingConfig):
    """The post-gradient pipeline every training path uses: freeze-mask ->
    gradient normalization/clipping -> update rule -> per-layer LR
    scaling -> ``params += updates``. Updates ``params`` and ``opt_state``
    in place and returns them."""
    grads = mask_frozen(grads, layers)
    grads = normalize_gradients(grads, training)
    updates = tx.update(grads, opt_state)
    updates = per_layer_lr_scale(updates, layers,
                                 training.updater.learning_rate)
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params, opt_state


# ---------------------------------------------------------------------------
# ZeRO-1/2 weight-update sharding (the parallel trainers' zero1 / zero2)
# ---------------------------------------------------------------------------

class ZeroLayout:
    """Where each leaf of a params-shaped container lives in this rank's
    row: leaf ``i`` (in ``tree_leaves`` order) is flattened, padded to
    ``n * chunk_i`` and viewed as ``(n, chunk_i)`` (``parallel/mesh.
    zero1_shard_leaf``); rank ``r`` owns row ``r`` of every leaf, and its
    rows lie side by side in one ``row``-element buffer. A ``(n, row)``
    packing of every rank's rows is what one reduce-scatter turns into
    this rank's row, and one all-gather of the rows gives every leaf
    back."""

    def __init__(self, tree, n: int, rank: int):
        from deeplearning4j_tpu_torch.parallel.mesh import zero1_chunk
        self.n, self.rank = int(n), int(rank)
        self.shapes = [tuple(t.shape) for t in tree_leaves(tree)]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.chunks = [zero1_chunk(s, self.n) for s in self.sizes]
        self.offsets = [sum(self.chunks[:i])
                        for i in range(len(self.chunks))]
        self.row = sum(self.chunks)

    def pack(self, tree, out: Optional[Tensor] = None) -> Tensor:
        """Every rank's rows of ``tree``: a ``(n, row)`` tensor (written
        into ``out`` when given), the padding zeros."""
        from deeplearning4j_tpu_torch.parallel.mesh import zero1_shard_leaf
        parts = [zero1_shard_leaf(t, self.n) for t in tree_leaves(tree)]
        if out is None:
            return torch.cat(parts, dim=1)
        return torch.cat(parts, dim=1, out=out)

    def take_row(self, tree) -> Tensor:
        """This rank's row of ``tree`` (a copy)."""
        parts = []
        for t, size, chunk in zip(tree_leaves(tree), self.sizes,
                                  self.chunks):
            lo = min(self.rank * chunk, size)
            piece = t.reshape(-1)[lo:min(lo + chunk, size)]
            if piece.numel() < chunk:
                piece = torch.nn.functional.pad(
                    piece, (0, chunk - piece.numel()))
            parts.append(piece)
        return torch.cat(parts)

    def views(self, row: Tensor, like) -> Any:
        """``like``'s structure with each leaf replaced by its ``[1,
        chunk]`` view into ``row`` (writes land in ``row``)."""
        index = {id(t): i for i, t in enumerate(tree_leaves(like))}

        def view(t):
            i = index[id(t)]
            o, c = self.offsets[i], self.chunks[i]
            return row[o:o + c].view(1, c)
        return tree_map(view, like)

    def whole_leaves(self, gathered: Tensor) -> List[Tensor]:
        """Each leaf, whole, from the all-gathered rows (``n * row``
        elements in rank order), the padding dropped."""
        full = gathered.view(self.n, self.row)
        return [full[:, o:o + c].reshape(-1)[:size].reshape(shape)
                for o, c, size, shape in zip(self.offsets, self.chunks,
                                             self.sizes, self.shapes)]

    @torch.no_grad()
    def unpack_into(self, gathered: Tensor, tree) -> None:
        """Write the all-gathered rows into ``tree``'s leaves in place."""
        for t, v in zip(tree_leaves(tree), self.whole_leaves(gathered)):
            t.copy_(v)


def _slots(opt_state: Dict) -> List[str]:
    return [k for k in opt_state if k != "count"]


def shard_updater_state(opt_state: Dict, mesh_ctx, axis=None):
    """Re-lay an updater state into the ZeRO layout: every moment leaf
    becomes this rank's ``[1, chunk]`` row of its flattened,
    pad-to-divisible view (the count stays as it is; the accumulated
    moments are kept). Returns ``(sharded_state, template)``: the template
    (a :class:`ZeroLayout`, None for a state without moments) is what
    :func:`gather_updater_state` needs to restore the whole tensors."""
    slots = _slots(opt_state)
    if not slots:
        return dict(opt_state), None
    layout = ZeroLayout(opt_state[slots[0]], mesh_ctx.zero1_shards(axis),
                        mesh_ctx.rank)
    out = {"count": opt_state["count"]}
    for slot in slots:
        out[slot] = layout.views(layout.take_row(opt_state[slot]),
                                 opt_state[slot])
    return out, layout


def gather_updater_state(opt_state: Dict, template: Optional[ZeroLayout],
                         mesh_ctx) -> Dict:
    """Inverse of :func:`shard_updater_state`: every rank's rows
    all-gathered (one collective per moment tree, so every rank calls it
    together) and each leaf restored to its whole shape."""
    if template is None:
        return dict(opt_state)
    out = {"count": opt_state["count"]}
    for slot in _slots(opt_state):
        row = torch.cat([v.reshape(-1)
                         for v in tree_leaves(opt_state[slot])])
        whole = iter(template.whole_leaves(mesh_ctx.all_gather(row)))
        out[slot] = tree_map(lambda _t: next(whole), opt_state[slot])
    return out


_NORM_KINDS = ("renormalizel2perlayer", "clipl2perlayer",
               "renormalizel2perparamtype", "clipl2perparamtype")


def normalize_gradients_sharded(fgrads, training: TrainingConfig, mesh_ctx):
    """:func:`normalize_gradients` on this rank's rows: the elementwise
    clip as it is, and every norm the square root of a sum of squares
    all-reduced over the ranks (one collective for all of them; the
    padding adds zeros). Those sums run in another order than on the
    whole tensors, so a norm-based kind agrees within rounding, not bit
    for bit."""
    kind = (training.gradient_normalization or "none").lower()
    if kind not in _NORM_KINDS:
        return normalize_gradients(fgrads, training)
    t = training.gradient_normalization_threshold
    per_layer = kind.endswith("perlayer")
    if not per_layer:
        groups = [[x] for x in tree_leaves(fgrads)]
    elif isinstance(fgrads, list):
        groups = [tree_leaves(g) for g in fgrads]
    else:
        groups = [tree_leaves(fgrads)]
    zero = torch.zeros((), device=mesh_ctx.device)
    sums = torch.stack([sum(((x * x).sum() for x in g), zero)
                        for g in groups])
    norms = torch.sqrt(mesh_ctx.all_reduce_(sums) + 1e-12)
    if kind.startswith("renormalize"):
        def apply(x, i):
            return x / norms[i]
    else:
        scale = torch.where(norms > t, t / norms, 1.0)

        def apply(x, i):
            return x * scale[i]
    if not per_layer:
        index = {id(x): i for i, x in enumerate(tree_leaves(fgrads))}
        return tree_map(lambda x: apply(x, index[id(x)]), fgrads)
    if isinstance(fgrads, list):
        return [tree_map(lambda x, i=i: apply(x, i), g)
                for i, g in enumerate(fgrads)]
    return tree_map(lambda x: apply(x, 0), fgrads)


@torch.no_grad()
def compute_updates_sharded(tx: Updater, fgrads, opt_state, params, layers,
                            training: TrainingConfig, mesh_ctx,
                            layout: ZeroLayout,
                            bad: Optional[Tensor] = None):
    """The ZeRO counterpart of :func:`compute_updates`. ``fgrads`` mirrors
    the params with this rank's ``[1, chunk]`` rows of the reduced
    gradient; ``opt_state``'s moments live in the same layout. The
    pipeline (freeze-mask, normalization, update rule, per-layer lr
    scale) runs on this rank's row of the params, and the updated rows
    are all-gathered into ``params`` in place. Under a sentinel (``bad``,
    the step's flag, the same on every rank) the row, the moments and the
    count are guarded (``resilience/sentinel.guarded_in_place``) before
    the gather, so a bad step gathers the old rows back. Returns
    ``(params, opt_state)``."""
    row = layout.take_row(params)
    fparams = layout.views(row, params)

    def update():
        g = mask_frozen(fgrads, layers)
        g = normalize_gradients_sharded(g, training, mesh_ctx)
        updates = tx.update(g, opt_state)
        updates = per_layer_lr_scale(updates, layers,
                                     training.updater.learning_rate)
        tree_map(lambda p, u: p.add_(u), fparams, updates)

    if bad is None:
        update()
    else:
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            guarded_in_place,
        )
        written = [row, opt_state["count"]] + [
            t for slot in _slots(opt_state)
            for t in tree_leaves(opt_state[slot])]
        guarded_in_place(bad, written, update)
    layout.unpack_into(mesh_ctx.all_gather(row), params)
    return params, opt_state
