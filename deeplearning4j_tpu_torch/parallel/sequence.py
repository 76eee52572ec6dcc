"""Sequence (context) parallelism: ring attention over the mesh's 'sp'
axis (the JAX package's ``parallel/sequence.py``).

Ring attention (Liu et al.): the sequence is split over the sp ranks;
each rank holds its Q/K/V shards and takes n_sp steps, attending with its
Q shard to the K/V shard it holds (``blockwise_attention``), then passing
K/V (and a padding mask's shard with them) to the next rank of the ring
(``MeshContext.ring_shift``). The flash-style running max and sum make
the steps' partial results compose exactly. The JAX ring runs inside a
``shard_map`` with ``ppermute``; here each rank is a process and runs its
own shard, and autograd through the shifts (each one's backward is the
shift the other way) gives the backward. The ring calls no flash kernel,
as the JAX ring calls no Pallas kernel: its blockwise attention is the
JAX package's plain algorithm.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.attention import (
    NEG_INF, blockwise_attention, finalize_attention,
)


class _Tie(torch.autograd.Function):
    """``out`` as it is, with ``t`` made part of its graph (a zero
    gradient), so the backward of every ring shift runs on every rank:
    a causal rank that skips its later shards would otherwise never run
    the shifts' backwards its neighbours wait on."""

    @staticmethod
    def forward(ctx, out, t):
        ctx.shape, ctx.dtype, ctx.device = t.shape, t.dtype, t.device
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.zeros(ctx.shape, dtype=ctx.dtype,
                                 device=ctx.device)


def ring_attention_sharded(q, k, v, ctx, *, causal: bool = False,
                           block_size: int = 512,
                           kv_mask: Optional[torch.Tensor] = None):
    """This rank's output shard ``[B, H, T_local, D]`` of attention over
    the whole sequence: ``q, k, v`` its shards ``[B, H, T_local, D]``
    (the global sequence is ``n_seq * T_local``), ``kv_mask`` its
    ``[B, T_local]`` key-validity shard, which travels the ring with its
    K/V. ``ctx``: the ``MeshContext`` whose sp axis carries the ring.

    K and V travel as one stacked tensor, so each step is one shift and
    the shifts form one chain, whose backwards every rank runs in the
    same order (the last shifted shard is tied to the output). Under
    ``causal`` the K/V shard of an earlier rank is fully visible, a later
    one's invisible (skipped: it would add exact zeros to the running
    sums) and this rank's own (the diagonal) is attended with the causal
    mask at its offset. The last shift is not taken: it would only bring
    each rank its own shard back."""
    n, me = ctx.n_seq, ctx.seq_index
    T_local = q.shape[2]
    q_offset = me * T_local
    out = torch.zeros_like(q)
    m = torch.full(q.shape[:3], NEG_INF, dtype=q.dtype, device=q.device)
    lse = torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device)
    kv, mask_cur = torch.stack([k, v]), kv_mask
    for i in range(n):
        src = (me - i) % n    # the rank whose K/V shard is held now
        if not (causal and src > me):
            diagonal = causal and src == me
            o_blk, m_blk, lse_blk = blockwise_attention(
                q, kv[0], kv[1], block_size=block_size, causal=diagonal,
                q_offset=q_offset - src * T_local if diagonal else 0,
                kv_mask=mask_cur)
            m_new = torch.maximum(m, m_blk)
            corr_old = torch.exp(m - m_new)
            corr_blk = torch.exp(m_blk - m_new)
            out = out * corr_old[..., None] + o_blk * corr_blk[..., None]
            lse = lse * corr_old + lse_blk * corr_blk
            m = m_new
        if i < n - 1:
            kv = ctx.ring_shift(kv)
            if mask_cur is not None:
                with torch.no_grad():
                    mask_cur = ctx.ring_shift(mask_cur)
    return finalize_attention(_Tie.apply(out, kv), lse)


def ring_self_attention(x, params, ctx, *, n_heads: int, head_dim: int,
                        causal: bool = False, block_size: int = 512,
                        mask: Optional[torch.Tensor] = None):
    """Sequence-parallel self attention on this rank's shard ``x``
    ``[B, T_local, F]`` of the sequence: local Q/K/V projections with
    whole weights, attention as a ring over ``ctx``'s sp axis, the output
    projection, and the output zeroed at masked query positions
    (``mask``: this rank's ``[B, T_local]`` shard of the padding mask,
    whose key part rides the ring). Returns ``[B, T_local, F]``."""
    B, T_l, _ = x.shape

    def split(h):
        return h.reshape(B, T_l, n_heads, head_dim).transpose(1, 2)

    q, k, v = (split(x @ params[w]) for w in ("Wq", "Wk", "Wv"))
    out = ring_attention_sharded(q, k, v, ctx, causal=causal,
                                 block_size=block_size, kv_mask=mask)
    out = out.transpose(1, 2).reshape(B, T_l, n_heads * head_dim)
    out = out @ params["Wo"]
    if mask is not None:
        out = out * mask[..., None]
    return out
