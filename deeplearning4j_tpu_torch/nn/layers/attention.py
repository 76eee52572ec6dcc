"""Attention layers (the JAX package's ``nn/layers/attention.py``).

``SelfAttentionLayer.apply`` runs every attention through
``ops.flash_attention`` (the Hopper kernel on the card); the Q/K/V/O
projections stay ``torch.matmul``. Incremental decode (``prefill``,
``decode_step``) is plain torch, as the JAX package leaves it to XLA.
The blockwise and ring (sequence-parallel) paths and the paged-KV helpers
are not ported yet.
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
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention

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


@register_layer
@dataclass
class SelfAttentionLayer(BaseLayerConf):
    """Multi-head self attention over [B, T, F] with an optional causal
    mask. Params: Wq/Wk/Wv [F, H*D], Wo [H*D, F]. (The JAX layer's
    ``block_size`` tiles its blockwise path, which is not ported; the
    port's kernel has fixed tiles.)"""
    n_heads: int = 8
    head_dim: int = 0          # default F // n_heads
    causal: bool = False

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

    def apply(self, params, x, *, state, mask=None):
        q = self._split_heads(x @ params["Wq"])
        k = self._split_heads(x @ params["Wk"])
        v = self._split_heads(x @ params["Wv"])
        out = flash_attention(q, k, v, causal=self.causal, kv_mask=mask)
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
