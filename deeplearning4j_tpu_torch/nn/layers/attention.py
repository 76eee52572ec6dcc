"""Attention layers (the JAX package's ``nn/layers/attention.py``).

``SelfAttentionLayer.apply`` runs attention through ``ops.flash_attention``
(on the card the Hopper kernels: the forward, and the dq and dk/dv backward
under autograd) wherever the kernels' register templates take its heads
(``head_dim <= MAX_HEAD_DIM``) or the JAX layer runs its Pallas kernel
(``flash_ok``; a head wider than 256 runs the kernels' wide template
there). Elsewhere it takes
``blockwise_attention`` + ``finalize_attention`` (``use_blockwise``, the
default) or ``attention_reference``, plain torch under autograd, as the
JAX layer does where ``flash_ok`` fails. The choice is made from the
arguments, the same on every device. The Q/K/V/O projections stay
``torch.matmul``.
Training drops out the layer's input. Incremental decode (``prefill``,
``decode_step``) and the paged-KV helpers (``gather_kv_pages``,
``scatter_kv_token``) are plain torch, as the JAX package leaves them to
XLA. The ring (sequence-parallel) path is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM, flash_attention, flash_ok,
)

NEG_INF = -1e30


def attention_reference(q, k, v, causal: bool = False,
                        mask: Optional[torch.Tensor] = None):
    """Plain softmax(QK^T/sqrt(d))V. q,k,v: [B, H, T, D]. A row with no
    valid key comes out softmax-uniform here, unlike the flash contract."""
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(cm, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False, q_offset: int = 0,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-style attention over KV blocks of ``block_size`` keys with a
    running max and sum, returning (unnormalised out, running max, running
    sum) so partial results compose across ring steps. q, k, v:
    ``[B, H, T, D]``; ``q_offset`` is the global position of query 0 (a
    sequence shard's, for causal masking); ``kv_mask`` ``[B, TK]`` marks
    valid keys (nonzero). The last block is zero-padded and its padding
    masked, as the JAX package pads it; differentiable by autograd."""
    B, H, TQ, D = q.shape
    TK = k.shape[2]
    bs = min(block_size, TK)
    n_blocks = -(-TK // bs)
    pad = n_blocks * bs - TK
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    key_ok = torch.ones((B, n_blocks * bs), dtype=torch.bool,
                        device=q.device)
    key_ok[:, TK:] = False
    if kv_mask is not None:
        key_ok[:, :TK] = kv_mask != 0
    scale = 1.0 / math.sqrt(D)
    q_pos = q_offset + torch.arange(TQ, device=q.device)
    out = torch.zeros_like(q)
    m = torch.full(q.shape[:3], NEG_INF, dtype=q.dtype, device=q.device)
    lse = torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device)
    for b in range(n_blocks):
        blk = slice(b * bs, (b + 1) * bs)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, blk]) * scale
        logits = torch.where(key_ok[:, None, None, blk], logits, NEG_INF)
        if causal:
            k_pos = torch.arange(b * bs, (b + 1) * bs, device=q.device)
            logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits,
                                 NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        out = out * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   v[:, :, blk])
        lse = lse * corr + p.sum(dim=-1)
        m = m_new
    return out, m, lse


def finalize_attention(out, lse):
    """Normalise ``blockwise_attention``'s output by its running sum."""
    return out / torch.clamp_min(lse[..., None], 1e-30)


# ---------------------------------------------------------------------------
# block-paged KV caches: the page-table indirection seam
# ---------------------------------------------------------------------------

def gather_kv_pages(pages, page_table):
    """Materialize per-row dense KV state from a block-paged pool.

    ``pages``: the pool, ``[n_pages, H, page_len, D]``. ``page_table``:
    ``[rows, pages_per_row]`` int64 physical page ids per row. Returns
    the dense ``[rows, H, pages_per_row * page_len, D]`` cache (a copy)
    the unmodified attention ``decode_step`` expects — when ``page_len``
    divides ``max_len`` this is shape- and VALUE-identical to the
    whole-row cache, so the paged decode step computes what the dense
    one does (content in unmapped or stale pages is finite and sits only
    at masked positions, where softmax contributes exact zeros)."""
    rows, ppr = page_table.shape
    _, H, page_len, D = pages.shape
    g = pages[page_table]                       # [rows, ppr, H, pl, D]
    g = g.permute(0, 2, 1, 3, 4)                # [rows, H, ppr, pl, D]
    return g.reshape(rows, H, ppr * page_len, D)


def scatter_kv_token(pages, new_kv, page_table, positions):
    """Write one decode step's K (or V) into the paged pool IN PLACE and
    return the pool (the same tensor; the JAX function returns a new
    array).

    ``new_kv``: ``[rows, H, D]`` — each row's K/V at its current write
    position. The write lands in page ``page_table[row, pos // pl]`` at
    offset ``pos % pl``. Live rows' write pages are EXCLUSIVE by
    construction (the engine only shares fully-prefilled prompt pages),
    so their targets never collide; rows without a mapped write page
    alias scratch page 0, where several writes may meet (one wins)."""
    page_len = pages.shape[2]
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    phys = page_table[rows, positions // page_len]
    pages[phys, :, positions % page_len, :] = new_kv
    return pages


@register_layer
@dataclass
class SelfAttentionLayer(BaseLayerConf):
    """Multi-head self attention over [B, T, F] with an optional causal
    mask. Params: Wq/Wk/Wv [F, H*D], Wo [H*D, F]. ``block_size`` and
    ``use_blockwise`` choose the path where neither the kernels nor the
    reference's kernel take the heads; elsewhere the kernels' own tiles
    apply."""
    n_heads: int = 8
    head_dim: int = 0          # default F // n_heads
    causal: bool = False
    block_size: int = 512
    use_blockwise: bool = True
    # the JAX layer's ring-attention switch for a sequence-parallel
    # scope; kept so configs carry across, inert until sequence
    # parallelism brings that scope (ROADMAP A6.2)
    sequence_parallel: bool = True

    @property
    def supports_kv_cache(self) -> bool:
        """Incremental decode is only meaningful for causal attention."""
        return self.causal

    def set_n_in(self, in_type: InputType) -> None:
        if in_type.kind != "rnn":
            raise ValueError(
                f"SelfAttentionLayer expects RNN input, got {in_type}")
        self.n_in = in_type.size
        if not self.head_dim:
            self.head_dim = max(1, self.n_in // self.n_heads)

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_in, in_type.timesteps)

    def param_order(self) -> List[str]:
        return ["Wq", "Wk", "Wv", "Wo"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        F = self.n_in
        HD = self.n_heads * self.head_dim
        return {
            "Wq": self._init_w(gen, (F, HD), F, HD, dtype),
            "Wk": self._init_w(gen, (F, HD), F, HD, dtype),
            "Wv": self._init_w(gen, (F, HD), F, HD, dtype),
            "Wo": self._init_w(gen, (HD, F), HD, F, dtype),
        }

    def _split_heads(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, out):
        B, H, T, D = out.shape
        return out.transpose(1, 2).reshape(B, T, H * D)

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        q = self._split_heads(x @ params["Wq"])
        k = self._split_heads(x @ params["Wk"])
        v = self._split_heads(x @ params["Wv"])
        if self.head_dim <= MAX_HEAD_DIM or flash_ok(x.shape[1],
                                                     self.head_dim):
            out = flash_attention(q, k, v, causal=self.causal, kv_mask=mask)
        elif self.use_blockwise:
            out, _, lse = blockwise_attention(
                q, k, v, block_size=self.block_size, causal=self.causal,
                kv_mask=mask)
            out = finalize_attention(out, lse)
        else:
            out = attention_reference(q, k, v, causal=self.causal, mask=mask)
        out = self._merge_heads(out) @ params["Wo"]
        if mask is not None:
            out = out * mask[..., None]
        return out, state

    # ------------------------------------------------- incremental decode
    def cache_shape(self, rows: int, max_len: int) -> Tuple[int, ...]:
        """Static per-bucket KV cache shape: [rows, H, max_len, D]."""
        return (rows, self.n_heads, max_len, self.head_dim)

    def prefill(self, params, x, k_cache, v_cache, lengths):
        """Prompt-window forward that fills the KV cache IN PLACE: ``x``
        the padded prompt block [B, T, F], ``lengths`` [B] the valid
        prompt lengths, caches [B, H, Tmax, D] (T <= Tmax). Padded
        positions write finite values that decode later overwrites or
        masks. Attention here is ``attention_reference`` with a length
        mask, as in the JAX package. Returns (out [B, T, F], k_cache,
        v_cache)."""
        if not self.causal:
            raise ValueError("prefill/decode need causal attention")
        q = self._split_heads(x @ params["Wq"])
        k = self._split_heads(x @ params["Wk"])
        v = self._split_heads(x @ params["Wv"])
        T = x.shape[1]
        kv_mask = (torch.arange(T, device=x.device)[None, :]
                   < lengths[:, None]).to(x.dtype)
        out = attention_reference(q, k, v, causal=True, mask=kv_mask)
        k_cache[:, :, :T, :] = k
        v_cache[:, :, :T, :] = v
        return self._merge_heads(out) @ params["Wo"], k_cache, v_cache

    def decode_step(self, params, x, k_cache, v_cache, positions):
        """ONE token per row: ``x`` [B, 1, F], ``positions`` [B] each
        row's sequence position. Writes this position's K/V into the
        caches IN PLACE and attends over the whole cache, positions past
        each row's own masked with NEG_INF. Returns (out [B, 1, F],
        k_cache, v_cache)."""
        if not self.causal:
            raise ValueError("prefill/decode need causal attention")
        q = self._split_heads(x @ params["Wq"])          # [B, H, 1, D]
        k_new = self._split_heads(x @ params["Wk"])[:, :, 0, :]
        v_new = self._split_heads(x @ params["Wv"])[:, :, 0, :]
        rows = torch.arange(x.shape[0], device=x.device)
        k_cache[rows, :, positions, :] = k_new
        v_cache[rows, :, positions, :] = v_new
        scale = 1.0 / math.sqrt(self.head_dim)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k_cache) * scale
        valid = (torch.arange(k_cache.shape[2], device=x.device)[None, :]
                 <= positions[:, None])                  # [B, Tmax]
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        out = torch.einsum("bhqk,bhkd->bhqd",
                           torch.softmax(logits, dim=-1), v_cache)
        return self._merge_heads(out) @ params["Wo"], k_cache, v_cache
