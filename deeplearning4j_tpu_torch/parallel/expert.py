"""Expert parallelism: the mixture-of-experts FFN (the JAX package's
``parallel/expert.py``).

Switch-style dense dispatch: top-1 gating gives a dispatch tensor, and
token -> expert routing and the combine back are products with it. The
expert products are plain batched products, as in the JAX package (it
has no Pallas kernel there).

With an expert axis (``MeshContext.create(n_expert=n)``), each rank holds
rows ``[e0:e1]`` of the stacked expert weights ``W1`` / ``b1`` / ``W2`` /
``b2`` (:func:`expert_rows`) and the same tokens. The JAX package shards
those rows over 'ep' and GSPMD partitions the products; here each rank
gates every token (the gate ``Wg`` is replicated), runs its own experts,
and the combined output is summed over the axis. The gate's and the
tokens' gradients through the experts reach every rank by an all-reduce
(``MeshContext.copy_to``), the balancing loss's as it is on each, so
every rank holds the whole gradient of ``Wg`` and of the tokens, and the
gradient of its own expert rows.

Over the data axis (``ParallelTrainer`` at more than one replica) the
JAX step is one program over the global microbatch, so the layer's
capacity, its tokens' positions in the experts' buffers and its
balancing loss are the global tokens'. The trainer hands the layer a
``mesh.GlobalBatch`` (as it hands batch norm its sum over the ranks):
the capacity counts every rank's tokens, each expert's positions on
this rank start after the tokens the data ranks before it sent there
(an all-gather of the per-expert counts, with no gradient), and the
balancing loss takes its token fractions and mean gates over the whole
axis (the gate sums through the differentiable sum over the ranks,
whose backward all-reduces: every rank's loss holds the same term, and
the trainer's mean over the data axis counts its gradient once). Only
this rank's tokens go through the experts; the slots the other ranks'
tokens fill carry zero combine weight here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation

Tensor = torch.Tensor

#: the stacked expert weights, the rows an 'ep' rank holds
EXPERT_PARAMS = ("W1", "b1", "W2", "b2")


def moe_dispatch(gates: Tensor, capacity: int, batch=None):
    """Top-1 dispatch/combine tensors (Switch-style).

    gates: [N, E] softmax scores. Returns (dispatch [N, E, C] one-hot,
    combine [N, E, C] gate-weighted, aux_loss scalar). ``batch``: a
    ``mesh.GlobalBatch`` whose data axis splits the global tokens; each
    expert's positions then start after the tokens the ranks before this
    one sent it, and the balancing loss is the global tokens'."""
    N, E = gates.shape
    expert_idx = gates.argmax(dim=-1)                             # [N]
    onehot = F.one_hot(expert_idx, E).to(gates.dtype)             # [N, E]
    # position of each token within its expert's buffer
    pos = torch.cumsum(onehot, dim=0) - 1.0                       # [N, E]
    if batch is not None:
        before, counts = batch.token_counts(onehot.sum(dim=0))
        pos = pos + before.to(gates.dtype)
    pos = pos * onehot
    keep = (pos < capacity).to(gates.dtype) * onehot
    pos_clipped = torch.clamp(pos, max=capacity - 1).to(torch.int64)
    pos_onehot = F.one_hot(pos_clipped, capacity).to(gates.dtype)
    dispatch = keep[..., None] * pos_onehot                       # [N, E, C]
    gate_val = (gates * onehot).sum(dim=-1, keepdim=True)         # [N, 1]
    combine = dispatch * gate_val[..., None]
    # Switch load-balancing loss: E * sum_e (fraction_tokens_e * mean_gate_e)
    if batch is None:
        frac = onehot.mean(dim=0)
        mean_gate = gates.mean(dim=0)
    else:
        n = batch.n_tokens(N)
        frac = counts.to(gates.dtype) / n
        mean_gate = batch.token_sum(gates.sum(dim=0)) / n
    aux = E * (frac * mean_gate).sum()
    return dispatch, combine, aux


def expert_span(n_experts: int, mesh) -> slice:
    """The expert rows this rank of ``mesh``'s 'ep' axis holds."""
    n = mesh.n_expert
    if n_experts % n:
        raise ValueError(
            f"n_experts={n_experts} is not divisible by the expert-parallel "
            f"axis (ep={n}): the stacked expert weights cannot shard evenly")
    per = n_experts // n
    return slice(mesh.expert_index * per, (mesh.expert_index + 1) * per)


def expert_rows(params: Params, mesh) -> Params:
    """``params`` with this rank's rows of the stacked expert weights (a
    copy); the gate ``Wg`` whole."""
    span = expert_span(params["Wg"].shape[-1], mesh)
    return {k: (v[span].clone() if k in EXPERT_PARAMS else v)
            for k, v in params.items()}


def moe_ffn(params: Params, x: Tensor, activation: str = "relu",
            capacity_factor: float = 1.25, mesh=None, batch=None):
    """x: [N, F] tokens. params: Wg [F, E]; W1 [E, F, H]; b1 [E, H];
    W2 [E, H, F]; b2 [E, F]. Returns ([N, F], aux_loss). ``mesh``: a mesh
    with an 'ep' axis whose ranks each hold their rows of the expert
    weights (:func:`expert_rows`) and the same tokens. ``batch``: a
    ``mesh.GlobalBatch`` whose data ranks each hold their part of the
    global tokens (:func:`moe_dispatch`)."""
    N, Fdim = x.shape
    E = params["Wg"].shape[-1]
    n = N if batch is None else batch.n_tokens(N)
    capacity = max(1, int(capacity_factor * n / E))
    gates = torch.softmax(x @ params["Wg"], dim=-1)
    dispatch, combine, aux = moe_dispatch(gates, capacity, batch)
    sharded = mesh is not None and mesh.n_expert > 1
    if sharded:
        # what the experts see of the replicated tokens and gates: each
        # rank's gradient covers its experts, all-reduced to the whole
        span = expert_span(E, mesh)
        x = mesh.copy_to(x, "ep")
        dispatch = dispatch[:, span]
        combine = mesh.copy_to(combine, "ep")[:, span]
    expert_in = torch.einsum("nec,nf->ecf", dispatch, x)         # [E, C, F]
    act = get_activation(activation)
    h = act(torch.einsum("ecf,efh->ech", expert_in, params["W1"])
            + params["b1"][:, None, :])
    expert_out = (torch.einsum("ech,ehf->ecf", h, params["W2"])
                  + params["b2"][:, None, :])                    # [E, C, F]
    out = torch.einsum("nec,ecf->nf", combine, expert_out)       # [N, F]
    if sharded:
        out = mesh.sum_value(out, "ep")
    return out, aux


@register_layer
@dataclass
class MoELayer(BaseLayerConf):
    """Mixture-of-experts FFN layer over [B, F] (or [B, T, F] flattened to
    tokens). Stacked expert weights carry a leading expert axis, whose
    rows an 'ep' axis shards (:func:`moe_ffn`). The balancing loss,
    times ``aux_loss_weight``, surfaces in the layer's state as
    ``aux_loss``, which both containers add to the objective inside the
    gradient. In a data-parallel step the containers hand ``apply`` the
    step's ``mesh.GlobalBatch`` as ``batch_sum``, over whose data axis the
    capacity, the positions and the balancing loss are taken
    (:func:`moe_dispatch`)."""
    n_experts: int = 8
    hidden: int = 0           # expert FFN hidden width; default 4*F
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2

    #: the containers hand ``apply`` the net's ``batch_sum``
    takes_batch_sum = True

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = (in_type.size if in_type.kind == "rnn"
                     else in_type.flat_size())
        if not self.hidden:
            self.hidden = 4 * self.n_in

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return ["Wg", "W1", "b1", "W2", "b2"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        Fdim, E, H = self.n_in, self.n_experts, self.hidden
        return {
            "Wg": self._init_w(gen, (Fdim, E), Fdim, E, dtype),
            "W1": self._init_w(gen, (E, Fdim, H), Fdim, H, dtype),
            "b1": torch.zeros((E, H), dtype=dtype),
            "W2": self._init_w(gen, (E, H, Fdim), H, Fdim, dtype),
            "b2": torch.zeros((E, Fdim), dtype=dtype),
        }

    def apply(self, params, x, *, state, train=False,
              rng: Optional[torch.Generator] = None, mask=None,
              batch_sum=None):
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])
        out, aux = moe_ffn(params, tokens, self.activation or "relu",
                           self.capacity_factor, batch=batch_sum)
        # the balancing loss surfaces through state for the container
        new_state = dict(state)
        new_state["aux_loss"] = aux * self.aux_loss_weight
        return out.reshape(shape), new_state

    def init_state(self):
        return {"aux_loss": torch.zeros(())}
