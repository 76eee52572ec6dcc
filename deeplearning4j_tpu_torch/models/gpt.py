"""GPT-style decoder-only language model (the JAX package's
``models/gpt.py``): the config builder and the singleton greedy decode.

A pre-LN transformer decoder on the ComputationGraph container: token
embedding + learned positions (``PositionalEmbeddingLayer``), N blocks of
causal self-attention (``SelfAttentionLayer``, on the flash-attention
kernel) and a time-distributed MLP, each wrapped in a residual add
(``ElementWiseVertex``) with ``LayerNormalization`` in front, and a
weight-tied LM head (``TiedRnnOutputLayer``).

The character data path (``char_vocab``, ``char_lm_batches``,
``synthetic_char_text``) is the JAX package's, in numpy: one-hot char
windows with next-char targets, the batches ``fit`` trains on. Not ported
yet: ``char_lm_sources`` (the streaming pipeline).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
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
from deeplearning4j_tpu_torch.util.math_utils import next_pow_of_2

#: default charset of the synthetic char-LM workloads
DEFAULT_CHARSET = "abcdefghijklmnopqrstuvwxyz .,;\n"


def gpt_decoder(vocab_size: int, seq_len: int, d_model: int = 128,
                n_heads: int = 4, n_layers: int = 4,
                d_ff: Optional[int] = None, seed: int = 12345,
                learning_rate: float = 3e-4, updater: str = "adam",
                dropout: Optional[float] = None,
                precision: Optional[str] = None,
                loss_scale: Optional[float] = None,
                block_size: int = 512,
                tie_weights: bool = True,
                dtype: str = "float32") -> ComputationGraphConfiguration:
    """Build the decoder LM config. Input: one-hot token windows
    ``[B, T=seq_len, V=vocab_size]``; output: the per-timestep next-token
    distribution ``[B, T, V]``. ``block_size`` tiles the blockwise
    attention of heads that neither the kernels (d_model / n_heads >
    256) nor the reference's kernel take. ``precision`` (with
    ``loss_scale``) sets the training precision policy, e.g. ``"bf16"``:
    bf16 compute over f32 master params."""
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
    if precision is not None:
        b = b.precision(precision, loss_scale=loss_scale)
    g = b.dtype(dtype).graph_builder().add_inputs("tokens")
    g.add_layer("embed", PositionalEmbeddingLayer(
        n_out=d_model, activation="identity"), "tokens")
    cur = "embed"
    for i in range(n_layers):
        blk = f"b{i}"
        g.add_layer(f"{blk}_ln1", LayerNormalization(), cur)
        g.add_layer(f"{blk}_attn", SelfAttentionLayer(
            n_heads=n_heads, causal=True, block_size=block_size,
            activation="identity"), f"{blk}_ln1")
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
    kw.setdefault("block_size", 4)
    return gpt_decoder(vocab_size, seq_len, **kw)


def _singleton_decode(net, prompt: Sequence[int], max_new_tokens: int,
                      select) -> List[int]:
    """SINGLETON decode through ``net.decode_fns()``: the prompt is
    prefilled at its pow2 length bucket, then one token per dense decode
    step; ``select(probs [V], index)`` picks each next token."""
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
    out = [select(probs[0], 0)]
    pos = len(prompt)
    while len(out) < max_new:
        xt = eye[out[-1]][None, None, :]
        probs, caches = decode(net.params, net.states, caches, xt,
                               torch.tensor([pos], device=dev))
        out.append(select(probs[0], len(out)))
        pos += 1
    return out


def greedy_generate(net, prompt: Sequence[int], max_new_tokens: int
                    ) -> List[int]:
    """SINGLETON greedy decode through ``net.decode_fns()``: the prompt is
    prefilled at its pow2 length bucket, then one token per decode step.
    ``net`` is an initialized ComputationGraph (e.g. ``gpt_decoder``); the
    decode runs on the net's device."""
    return _singleton_decode(net, prompt, max_new_tokens,
                             lambda p, _: int(p.argmax()))


def sample_generate(net, prompt: Sequence[int], max_new_tokens: int,
                    temperature: float, seed: int) -> List[int]:
    """SINGLETON seeded-sampling decode — the reference side of the
    batched == singleton gate for temperature sampling: the same steps
    as ``greedy_generate``, with next-token selection through the
    engine's own ``sample_token`` at draw index = tokens generated so
    far. A fixed seed pins the exact token stream the serving engine
    must reproduce under batching, churn, page eviction, and replay."""
    from deeplearning4j_tpu_torch.keras.generation import sample_token
    return _singleton_decode(
        net, prompt, max_new_tokens,
        lambda p, i: sample_token(p.cpu().numpy(), temperature, seed, i))


# ---------------------------------------------------------------------------
# character data path (one-hot char windows, next-char targets)
# ---------------------------------------------------------------------------

def char_vocab(text: str) -> str:
    """Sorted unique charset of ``text``: the index IS the token id."""
    return "".join(sorted(set(text)))


def char_lm_batches(text: str, seq_len: int, batch_size: int,
                    charset: Optional[str] = None,
                    max_batches: Optional[int] = None) -> List[DataSet]:
    """One-hot next-char DataSets from raw text: features ``[B, T, V]``
    are windows of ``text``, labels the same windows shifted one char
    (per-timestep MCXENT targets). Deterministic (sequential windows);
    characters outside ``charset`` are dropped."""
    cs = charset if charset is not None else char_vocab(text)
    idx = {c: i for i, c in enumerate(cs)}
    ids = np.asarray([idx[c] for c in text if c in idx], np.int32)
    window = seq_len + 1
    n_win = (len(ids) - 1) // window
    eye = np.eye(len(cs), dtype=np.float32)
    out, buf = [], []
    for w in range(n_win):
        buf.append(ids[w * window:w * window + window])
        if len(buf) == batch_size:
            arr = np.stack(buf)
            out.append(DataSet(eye[arr[:, :-1]], eye[arr[:, 1:]]))
            buf = []
            if max_batches is not None and len(out) >= max_batches:
                break
    return out


def synthetic_char_text(n_chars: int, seed: int = 0,
                        charset: str = DEFAULT_CHARSET) -> str:
    """Deterministic synthetic 'prose' with local structure (repeated
    gram draws) so a small LM has something learnable."""
    rng = np.random.default_rng(seed)
    grams = ["the ", "and ", "ing ", "ion ", "ent ", "was ", "are ",
             "of ", "to ", "in ", "he ", "she ", "it ", ". "]
    parts, n = [], 0
    while n < n_chars:
        gram = grams[int(rng.integers(0, len(grams)))]
        parts.append(gram)
        n += len(gram)
    return "".join(parts)[:n_chars]
