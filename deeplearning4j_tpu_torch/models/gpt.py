"""GPT-style decoder-only language model (the JAX package's
``models/gpt.py``): the config builder and the singleton greedy decode.

A pre-LN transformer decoder on the ComputationGraph container: token
embedding + learned positions (``PositionalEmbeddingLayer``), N blocks of
causal self-attention (``SelfAttentionLayer``, on the flash-attention
kernel) and a time-distributed MLP, each wrapped in a residual add
(``ElementWiseVertex``) with ``LayerNormalization`` in front, and a
weight-tied LM head (``TiedRnnOutputLayer``).

Not ported yet: ``sample_generate`` (it needs the serving engine's
``sample_token``), mixed precision and the character data path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
from deeplearning4j_tpu_torch.nn.layers.embedding import (
    PositionalEmbeddingLayer, TiedRnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    LayerNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.shape import TimeDistributedLayer


def gpt_decoder(vocab_size: int, seq_len: int, d_model: int = 128,
                n_heads: int = 4, n_layers: int = 4,
                d_ff: Optional[int] = None, seed: int = 12345,
                learning_rate: float = 3e-4, updater: str = "adam",
                dropout: Optional[float] = None,
                tie_weights: bool = True,
                dtype: str = "float32") -> ComputationGraphConfiguration:
    """Build the decoder LM config. Input: one-hot token windows
    ``[B, T=seq_len, V=vocab_size]``; output: the per-timestep next-token
    distribution ``[B, T, V]``. The JAX builder's ``precision``,
    ``loss_scale`` and ``block_size`` (training precision and the
    blockwise-attention tile) have no counterpart yet."""
    if d_ff is None:
        d_ff = 4 * d_model
    if d_model % n_heads:
        raise ValueError(f"d_model={d_model} not divisible by "
                         f"n_heads={n_heads}")
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater, learning_rate=learning_rate)
         .weight_init("xavier"))
    if dropout is not None:
        b = b.dropout(dropout)
    g = b.dtype(dtype).graph_builder().add_inputs("tokens")
    g.add_layer("embed", PositionalEmbeddingLayer(
        n_out=d_model, activation="identity"), "tokens")
    cur = "embed"
    for i in range(n_layers):
        blk = f"b{i}"
        g.add_layer(f"{blk}_ln1", LayerNormalization(), cur)
        g.add_layer(f"{blk}_attn", SelfAttentionLayer(
            n_heads=n_heads, causal=True, activation="identity"),
            f"{blk}_ln1")
        g.add_vertex(f"{blk}_res1", ElementWiseVertex(op="add"),
                     cur, f"{blk}_attn")
        g.add_layer(f"{blk}_ln2", LayerNormalization(), f"{blk}_res1")
        g.add_layer(f"{blk}_ff1", TimeDistributedLayer(
            inner=DenseLayer(n_out=d_ff, activation="gelu")),
            f"{blk}_ln2")
        g.add_layer(f"{blk}_ff2", TimeDistributedLayer(
            inner=DenseLayer(n_out=d_model, activation="identity")),
            f"{blk}_ff1")
        g.add_vertex(f"{blk}_res2", ElementWiseVertex(op="add"),
                     f"{blk}_res1", f"{blk}_ff2")
        cur = f"{blk}_res2"
    g.add_layer("ln_f", LayerNormalization(), cur)
    head = (TiedRnnOutputLayer(n_out=vocab_size, tied_to="embed",
                               activation="softmax", loss="mcxent")
            if tie_weights else
            RnnOutputLayer(n_out=vocab_size, activation="softmax",
                           loss="mcxent"))
    g.add_layer("head", head, "ln_f")
    return (g.set_outputs("head")
            .set_input_types(InputType.recurrent(vocab_size, seq_len))
            .build())


def gpt_tiny(vocab_size: int = 16, seq_len: int = 8, **kw
             ) -> ComputationGraphConfiguration:
    """Small CPU-testable decoder (the smoke/tier-1 shape)."""
    kw.setdefault("d_model", 16)
    kw.setdefault("n_heads", 2)
    kw.setdefault("n_layers", 2)
    kw.setdefault("d_ff", 32)
    return gpt_decoder(vocab_size, seq_len, **kw)


def next_pow_of_2(v: int) -> int:
    """Smallest power of two >= v."""
    return 1 if v <= 0 else 1 << (int(v - 1).bit_length())


def greedy_generate(net, prompt: Sequence[int], max_new_tokens: int
                    ) -> List[int]:
    """SINGLETON greedy decode through ``net.decode_fns()``: the prompt is
    prefilled at its pow2 length bucket, then one token per decode step.
    ``net`` is an initialized ComputationGraph (e.g. ``gpt_decoder``); the
    decode runs on the net's device."""
    prompt = list(prompt)
    V, max_len = net.decode_vocab(), net.decode_max_len()
    if not 0 < len(prompt) < max_len:
        raise ValueError(f"prompt length must be in (0, {max_len})")
    max_new = min(int(max_new_tokens), max_len - len(prompt))
    prefill, decode = net.decode_fns()
    dev = net.device
    eye = torch.eye(V, dtype=net.dtype, device=dev)
    bucket = min(next_pow_of_2(len(prompt)), max_len)
    x = torch.zeros((1, bucket, V), dtype=net.dtype, device=dev)
    x[0, :len(prompt)] = eye[torch.as_tensor(prompt, device=dev)]
    caches = net.init_decode_cache(1)
    probs, caches = prefill(net.params, net.states, caches, x,
                            torch.tensor([len(prompt)], device=dev))
    out = [int(probs[0].argmax())]
    pos = len(prompt)
    while len(out) < max_new:
        xt = eye[out[-1]][None, None, :]
        probs, caches = decode(net.params, net.states, caches, xt,
                               torch.tensor([pos], device=dev))
        out.append(int(probs[0].argmax()))
        pos += 1
    return out
