"""Each ported layer, vertex, activation and init scheme of the GPT
serving slice against its JAX-package counterpart, on the same inputs
(numpy, fixed seed) and the same weights (drawn by the JAX layer, carried
across with ``convert.layer_params_from_jax``).

Where trouble was expected, a test names it:
- GELU: ``jax.nn.gelu`` is the tanh approximation;
- LayerNorm: ``jnp.var`` is the population variance, eps inside rsqrt;
- the tied softmax head is ``softmax(x @ W_tok.T)`` with no bias;
- every masked layer multiplies its output by the key mask;
- prefill attends through ``attention_reference`` with a length mask, and
  decode attends over the whole cache with NEG_INF past each row's
  position.
Tolerance: atol 1e-5 in f32 (2e-5 where the flash kernel is in the path,
its own tolerance).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex as JVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import embedding as jemb
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers import shape as jshape
from deeplearning4j_tpu.nn.weights import init_weight as jinit_weight
from deeplearning4j_tpu.ops import activations as jact

from deeplearning4j_tpu_torch.convert import layer_params_from_jax
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import embedding as temb
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.layers import shape as tshape
from deeplearning4j_tpu_torch.nn.weights import WEIGHT_INITS, init_weight
from deeplearning4j_tpu_torch.ops import activations as tact

ATOL = 1e-5
B, T, F = 3, 10, 12


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _mask(seed=7):
    m = np.ones((B, T), np.float32)
    m[1, 6:] = 0.0
    m[2, 3:] = 0.0
    return m


def _pair(jlayer, tlayer, size=F, seed=0):
    """Shape both layers for [B, T, size] input; the JAX layer draws the
    weights, and they are carried into the port."""
    jlayer.set_n_in(JInputType.recurrent(size, T))
    tlayer.set_n_in(InputType.recurrent(size, T))
    jp = jlayer.init_params(jax.random.PRNGKey(seed))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    return jp, layer_params_from_jax(tlayer, np_p)


def _run_jax(layer, params, x, mask=None):
    out, _ = layer.apply(params, jnp.asarray(x), state={}, train=False,
                         rng=None,
                         mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(out)


def _run_port(layer, params, x, mask=None):
    out, _ = layer.apply(params, torch.from_numpy(x), state={},
                         mask=None if mask is None else torch.from_numpy(mask))
    return out.numpy()


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_table(name):
    x = _x(1, 4, 37, scale=4.0)
    x[0, :4] = [30.0, -30.0, 0.0, 1e-3]   # softplus / exp tails
    ref = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    got = tact.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    tanh_gelu = tact.gelu(x)
    assert torch.allclose(tanh_gelu, torch.nn.functional.gelu(
        x, approximate="tanh"))
    assert not torch.allclose(tanh_gelu, torch.nn.functional.gelu(x),
                              atol=1e-5)


@pytest.mark.parametrize("scheme", [s for s in WEIGHT_INITS
                                    if s != "distribution"])
def test_weight_init_matches_jax_distribution(scheme):
    """Distributions, not bits: mean and spread of a 200 x 300 draw agree
    with the JAX package's draw to sampling noise."""
    shape, fan_in, fan_out = (200, 300), 200.0, 300.0
    ref = np.asarray(jinit_weight(jax.random.PRNGKey(0), shape, fan_in,
                                  fan_out, scheme=scheme))
    got = init_weight(torch.Generator().manual_seed(0), shape, fan_in,
                      fan_out, scheme=scheme).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    spread = max(ref.std(), 1e-12)
    assert abs(got.mean() - ref.mean()) <= 0.02 * spread + 1e-12
    assert abs(got.std() - ref.std()) <= 0.02 * spread + 1e-12
    np.testing.assert_allclose([got.min(), got.max()],
                               [ref.min(), ref.max()],
                               rtol=0.25, atol=1e-12)


def test_input_type_matches_jax():
    for j, t in [(JInputType.recurrent(5, 7), InputType.recurrent(5, 7)),
                 (JInputType.feed_forward(9), InputType.feed_forward(9)),
                 (JInputType.convolutional(4, 5, 3),
                  InputType.convolutional(4, 5, 3))]:
        assert j.to_dict() == t.to_dict()
        assert j.flat_size() == t.flat_size()
        assert j.example_shape() == t.example_shape()


def test_dense_layer():
    jl = jcore.DenseLayer(n_out=7, activation="tanh", weight_init="xavier",
                          bias_init=0.1)
    tl = tcore.DenseLayer(n_out=7, activation="tanh", weight_init="xavier",
                          bias_init=0.1)
    jp, tp = _pair(jl, tl)
    assert tp["W"].shape == (F, 7)            # [in, out]: a copy, no transpose
    x = _x(2, B * T, F)
    np.testing.assert_allclose(_run_port(tl, tp, x), _run_jax(jl, jp, x),
                               atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_time_distributed_gelu_dense(masked):
    jl = jshape.TimeDistributedLayer(inner=jcore.DenseLayer(
        n_out=20, activation="gelu", weight_init="xavier"))
    tl = tshape.TimeDistributedLayer(inner=tcore.DenseLayer(
        n_out=20, activation="gelu", weight_init="xavier"))
    jp, tp = _pair(jl, tl)
    x, m = _x(3, B, T, F), (_mask() if masked else None)
    got = _run_port(tl, tp, x, m)
    np.testing.assert_allclose(got, _run_jax(jl, jp, x, m), atol=ATOL)
    if masked:
        assert np.all(got[2, 3:] == 0.0)


def test_layer_normalization_population_variance():
    jl, tl = jnorm.LayerNormalization(), tnorm.LayerNormalization()
    _, _ = _pair(jl, tl)
    rng = np.random.default_rng(4)
    p = {"gamma": rng.normal(size=F).astype(np.float32),
         "beta": rng.normal(size=F).astype(np.float32)}
    x = _x(5, B, T, F, scale=3.0) + 2.0
    got = _run_port(tl, layer_params_from_jax(tl, p), x)
    np.testing.assert_allclose(
        got, _run_jax(jl, {k: jnp.asarray(v) for k, v in p.items()}, x),
        atol=ATOL)
    # population variance (unbiased=False), eps inside the rsqrt
    xs = x.astype(np.float64)
    ref = (xs - xs.mean(-1, keepdims=True)) / np.sqrt(
        xs.var(-1, keepdims=True) + 1e-5) * p["gamma"] + p["beta"]
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_output_layer_softmax(masked):
    kw = dict(n_out=6, activation="softmax", loss="mcxent",
              weight_init="xavier")
    jl, tl = jrec.RnnOutputLayer(**kw), trec.RnnOutputLayer(**kw)
    jp, tp = _pair(jl, tl)
    x, m = _x(6, B, T, F), (_mask() if masked else None)
    np.testing.assert_allclose(_run_port(tl, tp, x, m),
                               _run_jax(jl, jp, x, m), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_positional_embedding_apply(masked):
    kw = dict(n_out=F, activation="identity", weight_init="xavier")
    jl = jemb.PositionalEmbeddingLayer(**kw)
    tl = temb.PositionalEmbeddingLayer(**kw)
    jp, tp = _pair(jl, tl, size=9)
    assert tl.max_timesteps == T and tp["P"].shape == (T, F)
    tokens = np.random.default_rng(8).integers(0, 9, (B, T - 2))
    x = np.eye(9, dtype=np.float32)[tokens]       # a window shorter than T
    m = _mask()[:, :T - 2] if masked else None
    np.testing.assert_allclose(_run_port(tl, tp, x, m),
                               _run_jax(jl, jp, x, m), atol=ATOL)


def test_positional_embedding_decode_step():
    kw = dict(n_out=F, activation="identity", weight_init="xavier")
    jl = jemb.PositionalEmbeddingLayer(**kw)
    tl = temb.PositionalEmbeddingLayer(**kw)
    jp, tp = _pair(jl, tl, size=9)
    x = np.eye(9, dtype=np.float32)[[2, 5, 8]][:, None, :]
    pos = np.array([0, 4, 9])
    ref = np.asarray(jl.decode_step(jp, jnp.asarray(x), jnp.asarray(pos)))
    got = tl.decode_step(tp, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_tied_head_is_softmax_of_x_times_w_tok_transposed(masked):
    kw = dict(n_out=9, tied_to="embed", activation="softmax", loss="mcxent")
    jl, tl = jemb.TiedRnnOutputLayer(**kw), temb.TiedRnnOutputLayer(**kw)
    jp, tp = _pair(jl, tl)
    assert jp == {} and tp == {}                 # owns no params, no bias
    w_tok = _x(9, 9, F)
    x, m = _x(10, B, T, F), (_mask() if masked else None)
    got = _run_port(tl, {"W_tok": torch.from_numpy(w_tok)}, x, m)
    np.testing.assert_allclose(
        got, _run_jax(jl, {"W_tok": jnp.asarray(w_tok)}, x, m), atol=ATOL)
    ref = torch.softmax(torch.from_numpy(x @ w_tok.T), -1).numpy()
    if m is not None:
        ref = ref * m[..., None]
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _attention_pair(causal=True):
    kw = dict(n_heads=3, causal=causal, activation="identity",
              weight_init="xavier")
    jl, tl = jatt.SelfAttentionLayer(**kw), tatt.SelfAttentionLayer(**kw)
    jp, tp = _pair(jl, tl)
    assert tl.head_dim == jl.head_dim == F // 3
    return jl, tl, jp, tp


@pytest.mark.parametrize("causal,masked", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_self_attention_apply_through_flash(monkeypatch, causal, masked):
    """The JAX layer through its Pallas kernel (interpret mode), the port's
    through ``flash_attention``; masked outputs are multiplied by the mask."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jl, tl, jp, tp = _attention_pair(causal)
    x, m = _x(11, B, T, F), (_mask() if masked else None)
    got = _run_port(tl, tp, x, m)
    np.testing.assert_allclose(got, _run_jax(jl, jp, x, m), atol=2e-5)
    if masked:
        assert np.all(got[1, 6:] == 0.0)


def test_self_attention_apply_calls_flash_attention(monkeypatch):
    calls = []
    real = tatt.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    _, tl, _, tp = _attention_pair()
    _run_port(tl, tp, _x(12, B, T, F), _mask())
    assert len(calls) == 1
    assert calls[0][0] == (B, 3, T, F // 3) and calls[0][1]["causal"]


def test_attention_reference_matches_jax():
    q, k, v = (_x(s, 2, 3, T, 4) for s in (13, 14, 15))
    m = _mask()[:2]
    for causal in (False, True):
        ref = jatt.attention_reference(*map(jnp.asarray, (q, k, v)),
                                       causal=causal, mask=jnp.asarray(m))
        got = tatt.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal,
                                       mask=torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_self_attention_prefill_and_decode_step():
    """prefill fills the cache (reference attention, length mask), then
    decode_step attends over the whole cache with NEG_INF past each row's
    position; outputs and caches match the JAX layer step by step."""
    jl, tl, jp, tp = _attention_pair()
    Tmax, Tp = 16, 8
    shape = tl.cache_shape(B, Tmax)
    assert shape == jl.cache_shape(B, Tmax) == (B, 3, Tmax, F // 3)
    jk = jv = jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    lengths = np.array([8, 5, 1])
    x = _x(16, B, Tp, F)
    ref, jk, jv = jl.prefill(jp, jnp.asarray(x), jk, jv,
                             jnp.asarray(lengths))
    got, tk, tv = tl.prefill(tp, torch.from_numpy(x), tk, tv,
                             torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    pos = lengths.copy()
    for step in range(3):
        xt = _x(17 + step, B, 1, F)
        ref, jk, jv = jl.decode_step(jp, jnp.asarray(xt), jk, jv,
                                     jnp.asarray(pos))
        got, tk, tv = tl.decode_step(tp, torch.from_numpy(xt), tk, tv,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        pos = pos + 1


@pytest.mark.parametrize("op", ["add", "subtract", "product", "average",
                                "max"])
def test_elementwise_vertex(op):
    a, b = _x(20, B, T, F), _x(21, B, T, F)
    ref = JVertex(op=op).apply([jnp.asarray(a), jnp.asarray(b)])
    got = ElementWiseVertex(op=op).apply([torch.from_numpy(a),
                                          torch.from_numpy(b)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
