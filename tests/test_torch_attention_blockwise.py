"""Wide attention heads: the port's ``blockwise_attention`` /
``finalize_attention``, ``SelfAttentionLayer``'s routing, heads of 256
(the kernels' widest register template), heads of 320 and 512 (their wide
template), a head-dim-256 GPT and a GPT with 2 heads of 512, against the
JAX package on the CPU.

The JAX layer runs its Pallas kernel in interpret mode
(``DL4J_TPU_PALLAS=interpret``), so it routes as it does on a TPU: the
kernel wherever ``flash_ok`` passes, else ``blockwise_attention`` +
``finalize_attention`` (``use_blockwise``, the default) or
``attention_reference``. The port runs its kernels' plain versions where
the JAX layer runs its kernel (and wherever the head fits the kernels),
and the same plain torch functions elsewhere. Inputs come from numpy with
a seed; weights are drawn by the JAX side and carried across
(``convert.layer_params_from_jax``, ``convert.params_from_jax``).
Tolerances: the forward 2e-5 and the weight gradients 5e-5, the
reference's flash-attention tolerances; losses 1e-5 relative, as the GPT
training parity holds them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.ops import pallas_attention as jpa

from deeplearning4j_tpu_torch.convert import (
    layer_params_from_jax, params_from_jax,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM, flash_ok,
)

TOL_FWD = 2e-5
TOL_GRAD = 5e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX layer routes as on a TPU, its Pallas kernel interpreted."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _holes(B, T):
    """Batch 0 keeps every key, batch 1 loses keys 3-8 and its tail,
    batch 2 has no valid key at all."""
    m = np.ones((B, T), np.float32)
    m[1, 3:9] = 0.0
    m[1, T - 4:] = 0.0
    if B > 2:
        m[2] = 0.0
    return m


# ---- the functions ---------------------------------------------------------

#: (TQ, TK, block_size, causal, q_offset, masked)
FN_CASES = {
    "causal-T20-block8": (20, 20, 8, True, 0, False),
    "full-T20-block8-holes": (20, 20, 8, False, 0, True),
    "causal-T20-block8-holes": (20, 20, 8, True, 0, True),
    "causal-shard-q_offset12": (8, 20, 8, True, 12, True),
    "causal-one-block": (16, 16, 512, True, 0, False),
}


@pytest.mark.parametrize("name", list(FN_CASES))
def test_blockwise_attention_matches_jax(name):
    """The unnormalised output, running max and running sum, and their
    normalised output, equal the JAX package's: T not a multiple of the
    block (the last block padded and masked), keys masked in holes, a row
    with no valid key, and a query shard at a ``q_offset``."""
    TQ, TK, bs, causal, q_offset, masked = FN_CASES[name]
    B, H, D = 3, 2, 16
    q = _x(1, B, H, TQ, D)
    k, v = _x(2, B, H, TK, D), _x(3, B, H, TK, D)
    mask = _holes(B, TK) if masked else None
    ref = jatt.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), block_size=bs, causal=causal,
        q_offset=q_offset,
        kv_mask=None if mask is None else jnp.asarray(mask))
    got = tatt.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), block_size=bs, causal=causal,
        q_offset=q_offset,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    for part, a, r in zip(("out", "max", "sum"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL_FWD,
                                   rtol=TOL_FWD, err_msg=part)
    np.testing.assert_allclose(
        tatt.finalize_attention(got[0], got[2]).numpy(),
        np.asarray(jatt.finalize_attention(ref[0], ref[2])), atol=TOL_FWD)


def test_blockwise_attention_equals_reference_on_rows_with_keys():
    """Normalised, the blockwise output is softmax attention: it equals
    ``attention_reference`` wherever a query row has a valid key (a row
    with none is softmax-uniform in both)."""
    B, H, T, D = 3, 2, 20, 16
    q, k, v = (torch.from_numpy(_x(s, B, H, T, D)) for s in (4, 5, 6))
    mask = torch.from_numpy(_holes(B, T))
    for causal in (False, True):
        out, _, lse = tatt.blockwise_attention(q, k, v, block_size=8,
                                               causal=causal, kv_mask=mask)
        got = tatt.finalize_attention(out, lse)
        ref = tatt.attention_reference(q, k, v, causal=causal, mask=mask)
        torch.testing.assert_close(got[:2], ref[:2], atol=TOL_FWD, rtol=0)


# ---- the layer: head dim 256, and past the reference's kernel -------------

B, T, F, HEADS = 3, 20, 512, 2
#: a head dim whose K and V panels (T = 20 padded to 128) overflow the
#: reference kernel's 6 MiB budget: both sides take the blockwise path
BLOCKWISE_D = 6272


def _layers(causal, use_blockwise, head_dim=0, n_in=F, n_heads=HEADS):
    kw = dict(n_heads=n_heads, head_dim=head_dim, causal=causal,
              block_size=8, use_blockwise=use_blockwise,
              activation="identity", weight_init="xavier")
    jl, tl = jatt.SelfAttentionLayer(**kw), tatt.SelfAttentionLayer(**kw)
    jl.set_n_in(JInputType.recurrent(n_in, T))
    tl.set_n_in(InputType.recurrent(n_in, T))
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = layer_params_from_jax(tl, {k: np.asarray(a) for k, a in jp.items()})
    return jl, tl, jp, tp


LAYER_CASES = [(c, m, u) for u in (True, False) for c in (True, False)
               for m in (False, True)]


def _layer_parity(layers, causal, masked):
    """Forward within 2e-5 and the gradients of Wq, Wk, Wv and Wo (torch
    autograd against ``jax.grad``) within 5e-5; a masked query's output is
    exactly 0."""
    jl, tl, jp, tp = layers
    n_in = tl.n_in
    x, w = _x(7, B, T, n_in), _x(8, B, T, n_in)
    mask = _holes(B, T) if masked else None
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(p):
        out, _ = jl.apply(p, jnp.asarray(x), state={}, train=False,
                          rng=None, mask=jm)
        return jnp.sum(out * w), out

    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: a.clone().requires_grad_() for k, a in tp.items()}
    out, _ = tl.apply(tp, torch.from_numpy(x), state={},
                      mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL_FWD)
    for name in tl.param_order():
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(ref_g[name]), atol=TOL_GRAD,
                                   err_msg=name)
    if masked:
        assert torch.all(out[2] == 0) and torch.all(out[1, T - 4:] == 0)


@pytest.mark.parametrize("causal,masked,use_blockwise", LAYER_CASES)
def test_wide_head_layer_matches_jax(causal, masked, use_blockwise):
    """Head dim 256, the kernels' widest template: the port's flash path
    (its plain version here) against the JAX layer's Pallas kernel, which
    ``flash_ok`` admits whatever ``use_blockwise`` says."""
    layers = _layers(causal, use_blockwise)
    assert layers[1].head_dim == 256 == MAX_HEAD_DIM and flash_ok(T, 256)
    _layer_parity(layers, causal, masked)


@pytest.mark.parametrize("head_dim", [320, 512])
@pytest.mark.parametrize("causal,masked", [(True, False), (True, True),
                                           (False, True)])
def test_wider_head_layer_matches_jax(head_dim, causal, masked):
    """Heads of 320 and 512, past the kernels' register templates, where
    the reference runs its Pallas kernel (``flash_ok``): the port's flash
    path (the kernels' wide template on the card, its plain version here)
    against the JAX layer's kernel, with and without a key mask."""
    assert head_dim > MAX_HEAD_DIM and flash_ok(T, head_dim)
    assert jpa.flash_ok(T, head_dim)
    _layer_parity(_layers(causal, True, head_dim=head_dim, n_in=64),
                  causal, masked)


@pytest.mark.parametrize("causal,masked,use_blockwise", LAYER_CASES)
def test_blockwise_layer_matches_jax(causal, masked, use_blockwise):
    """A head past the reference kernel's gate: blockwise attention over
    blocks of 8 keys (T = 20, the last block ragged), or
    ``attention_reference``, on both sides."""
    assert not flash_ok(T, BLOCKWISE_D)
    assert not jpa.flash_ok(T, BLOCKWISE_D)
    _layer_parity(_layers(causal, use_blockwise, head_dim=BLOCKWISE_D,
                          n_in=16, n_heads=1), causal, masked)


@pytest.mark.parametrize("head_dim,use_blockwise,path", [
    (64, True, "flash"), (MAX_HEAD_DIM, True, "flash"),
    (MAX_HEAD_DIM, False, "flash"), (MAX_HEAD_DIM + 1, True, "flash"),
    (BLOCKWISE_D, True, "blockwise"), (BLOCKWISE_D, False, "reference")])
def test_layer_routes_on_its_head_width(monkeypatch, head_dim,
                                        use_blockwise, path):
    """Heads the kernels' register templates take (``head_dim <=
    MAX_HEAD_DIM``) go to ``flash_attention`` (the kernels on the card);
    so do wider heads where the reference runs its kernel (``flash_ok``),
    which the kernels' wide template runs, on every device, with a finite
    result. Past ``flash_ok``, heads go to ``blockwise_attention`` or, with
    ``use_blockwise=False``, to ``attention_reference``. One call of the
    chosen path and none of the others, decided from the arguments."""
    calls = []
    for name in ("flash_attention", "blockwise_attention",
                 "attention_reference"):
        real = getattr(tatt, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(tatt, name, spy)
    layer = tatt.SelfAttentionLayer(n_heads=1, head_dim=head_dim,
                                    causal=True, use_blockwise=use_blockwise,
                                    activation="identity")
    layer.set_n_in(InputType.recurrent(8, 6))
    params = layer.init_params(torch.Generator().manual_seed(0))
    mask = torch.ones(2, 6)
    mask[1, 4:] = 0.0
    x = torch.from_numpy(_x(9, 2, 6, 8))
    out, _ = layer.apply(params, x, state={}, mask=mask)
    assert out.shape == (2, 6, 8) and torch.isfinite(out).all()
    assert calls == [{"flash": "flash_attention",
                      "blockwise": "blockwise_attention",
                      "reference": "attention_reference"}[path]]


# ---- a head-dim-256 GPT ----------------------------------------------------

V, TS, BS = 96, 16, 2
GPT = dict(vocab_size=V, seq_len=TS, d_model=512, n_heads=2, n_layers=1)


def _nets(**kw):
    jnet = JGraph(jgpt.gpt_decoder(**GPT, **kw)).init()
    conf = tgpt.gpt_decoder(**GPT, **kw)
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


def _batch(seed, masked):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (BS, TS + 1))
    eye = np.eye(V, dtype=np.float32)
    arrays = [eye[tok[:, :-1]], eye[tok[:, 1:]]]
    if masked:
        mask = np.ones((BS, TS), np.float32)
        mask[1, 9:] = 0.0
        arrays += [mask, mask]
    return arrays


@pytest.mark.parametrize("block_size", [512, 6])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_wide_head_gpt_output_matches_jax(block_size, masked):
    """``output`` of a ``gpt_decoder`` with d_model 512 over 2 heads (head
    dim 256). Both sides run their flash kernel (the port's plain version,
    the reference's interpreted), so ``block_size`` (one block of 512, or
    6, which does not divide T = 16) leaves the result as it is."""
    jnet, tnet = _nets(block_size=block_size)
    a = _batch(1, masked)
    mask = a[2] if masked else None
    ref = np.asarray(jnet.output(a[0], mask=mask))
    got = tnet.output(a[0], mask=mask).numpy()
    assert got.shape == (BS, TS, V)
    np.testing.assert_allclose(got, ref, atol=TOL_FWD)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_wide_head_gpt_fit_batch_losses_match_jax(masked):
    """Two ``fit_batch`` losses of the head-dim-256 GPT (Adam at its
    default 3e-4): the first is the loss at the carried weights, the
    second follows one step of the flash backward's gradients."""
    jnet, tnet = _nets(block_size=6)
    a = _batch(2, masked)
    ref = [float(jnet.fit_batch(JDataSet(*a))) for _ in range(2)]
    got = [float(tnet.fit_batch(DataSet(*a))) for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert got[1] != got[0]


# ---- a GPT with 2 heads of 512 ---------------------------------------------

GPT512 = dict(vocab_size=V, seq_len=TS, d_model=1024, n_heads=2, n_layers=1)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_head_dim_512_gpt_matches_jax(masked):
    """A 1-layer ``gpt_decoder`` with d_model 1024 over 2 heads (head dim
    512, where ``flash_ok`` passes at T = 16): its ``output`` within 2e-5
    and one ``fit_batch`` loss within 1e-5 relative of the JAX package's,
    which runs its Pallas kernel interpreted; the port runs the wide
    template's plain version."""
    assert flash_ok(TS, 512) and jpa.flash_ok(TS, 512)
    jnet = JGraph(jgpt.gpt_decoder(**GPT512)).init()
    conf = tgpt.gpt_decoder(**GPT512)
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    a = _batch(3, masked)
    mask = a[2] if masked else None
    got = tnet.output(a[0], mask=mask).numpy()
    assert got.shape == (BS, TS, V) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jnet.output(a[0], mask=mask)),
                               atol=TOL_FWD)
    np.testing.assert_allclose(float(tnet.fit_batch(DataSet(*a))),
                               float(jnet.fit_batch(JDataSet(*a))),
                               rtol=LOSS_RTOL)
