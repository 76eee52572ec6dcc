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

``PrecisionPolicy`` is ported as ``parse`` and the fp32 path: a bf16 or
fp16 policy is read and validated, and the containers refuse to train
under it (ROADMAP A2). The ZeRO helpers wait for the parallel trainers
(ROADMAP A6).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

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
# precision policy (the fp32 path)
# ---------------------------------------------------------------------------

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


@dataclass(frozen=True)
class PrecisionPolicy:
    """The matmul/update precision policy. ``compute_dtype`` is what the
    forward and backward run in, ``params_dtype`` the master weights'.
    The port trains only the pure-fp32 policy (``mixed`` False)."""

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


# ---------------------------------------------------------------------------
# learning-rate policies and update rules
# ---------------------------------------------------------------------------

def make_lr_schedule(u: UpdaterConfig) -> Callable[[int], float]:
    """updates taken -> learning rate (DL4J's LearningRatePolicy)."""
    base = u.learning_rate
    policy = (u.lr_policy or "none").lower()
    rate, power, steps = (u.lr_policy_decay_rate, u.lr_policy_power,
                          u.lr_policy_steps)
    if policy == "none":
        return lambda step: base
    if policy == "exponential":
        return lambda step: base * rate ** step
    if policy == "inverse":
        return lambda step: base / (1.0 + rate * step) ** power
    if policy == "poly":
        return lambda step: base * max(1.0 - step / max(steps, 1.0),
                                       0.0) ** power
    if policy == "sigmoid":
        return lambda step: base / (1.0 + math.exp(-rate * (step - steps)))
    if policy == "step":
        return lambda step: base * rate ** math.floor(step / steps)
    if policy == "schedule":
        sched = sorted((u.lr_schedule or {}).items())
        if not sched:
            return lambda step: base
        bounds = [k for k, _ in sched]
        values = [base] + [v for _, v in sched]
        return lambda step: values[bisect.bisect_right(bounds, step)]
    raise ValueError(f"Unknown lr policy {policy!r}")


def _moment(t: Tensor, g: Tensor, decay: float) -> Tensor:
    """optax's ``(1 - decay) * g + decay * t``, into ``t``."""
    return t.mul_(decay).add_((1 - decay) * g)


def _bias_corrected(t: Tensor, decay: float, count: int) -> Tensor:
    """``t / (1 - decay ** count)``, the correction taken in f32 as optax
    takes it."""
    corr = 1 - torch.tensor(decay, dtype=torch.float32) ** count
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

    def update(self, grads, state: Dict):
        """The updates to add to the params for ``grads``."""
        u, count = self.u, state["count"]
        # adadelta runs at lr 1.0 and takes no schedule, as optax.adadelta
        # with learning_rate=1.0 does
        step = -1.0 if self.name == "adadelta" else -self.lr(count)
        state["count"] = count + 1
        slots = [state[s] for s in self.SLOTS[self.name]]

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
                g = _bias_corrected(mu, u.beta1, count + 1) / (
                    torch.sqrt(_bias_corrected(nu, u.beta2, count + 1))
                    + u.epsilon)
            elif self.name == "adamax":
                mu, nu = st
                _moment(mu, g, u.beta1)
                torch.maximum(g.abs() + u.epsilon, u.beta2 * nu, out=nu)
                g = _bias_corrected(mu, u.beta1, count + 1) / nu
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

    def optax_leaves(self, state: Dict) -> List[Tensor]:
        """``state`` as optax's leaves: each count an int32 scalar, each
        moment tree's tensors in ``tree_leaves`` order (dict keys sorted
        at every level)."""
        out = []
        for entry in self.optax_layout():
            if entry == "count":
                out.append(torch.tensor(state["count"], dtype=torch.int32))
            else:
                out.extend(tree_leaves(state[entry]))
        return out

    @torch.no_grad()
    def load_optax_leaves(self, state: Dict, leaves: List[Tensor]) -> None:
        """The inverse of :meth:`optax_leaves`: the moments are written
        into ``state``'s tensors in place, and ``state["count"]`` is read
        from the first count leaf (0 where the layout keeps none). The
        leaf count and every leaf's size are checked before anything is
        written."""
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
        state["count"] = counts[0] if counts else 0


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
