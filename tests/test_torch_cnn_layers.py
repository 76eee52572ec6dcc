"""The CNN slice's layers, vertices, shape layers and preprocessors against
their JAX-package counterparts, on the same inputs (numpy, fixed seed)
and the same weights and states (drawn by the JAX layer, carried across
with ``convert``): the output, the output type the builder infers, and
the gradients of a fixed random projection of the output with respect to
the input and every param.

Where trouble was expected, a test names it:
- ``same`` is XLA's asymmetric SAME (7x7/2 on an even size pads (2, 3),
  a 3x3/2 max pool on an even size (0, 1) with -inf);
- average pooling divides by the unpadded count under ``same`` and by
  ``kh * kw`` under truncate even where explicit padding adds zeros; the
  1-D pooling sums for every type but max;
- batch norm uses the population variance, keeps f32 state in a bf16
  layer and normalizes with the running state in inference;
- LRN is DL4J's formula, alpha not divided by n;
- a CNN flattens NHWC, c fastest.

Tolerances: forward 1e-5 x max(1, max |y|) in f32; in bf16 one bf16 ulp
(2^-8) x max(1, max |y|), since both sides round the same f32 value to
bf16 and may round a value near a tie apart; gradients 1e-4 of each
tensor's largest |g|; states 1e-5.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.layers import shape as jshape

from deeplearning4j_tpu_torch.convert import layer_params_from_jax
from deeplearning4j_tpu_torch.nn.conf import graph as tgraph
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.layers import pooling as tpool
from deeplearning4j_tpu_torch.nn.layers import shape as tshape

FWD_TOL = 1e-5
BF16_TOL = 2.0 ** -8
GRAD_TOL = 1e-4
STATE_TOL = 1e-5
B = 3


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _types(kind, *dims):
    make = {"cnn": "convolutional", "rnn": "recurrent",
            "ff": "feed_forward"}[kind]
    if kind == "rnn":      # dims (T, F) -> recurrent(F, T)
        dims = (dims[1], dims[0])
    return getattr(JInputType, make)(*dims), getattr(InputType, make)(*dims)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def _grad_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, what


def _check(jl, tl, kind, dims, x, *, mask=None, train=False, grads=True,
           dtype="float32", seed=0):
    """Shape both layers for ``kind`` input of per-example ``dims``, carry
    the JAX layer's params and state into the port, and hold the port's
    output type, output, new state and gradients against the JAX
    layer's. Returns (port output, port new state)."""
    jt, tt = _types(kind, *dims)
    jl.set_n_in(jt)
    tl.set_n_in(tt)
    assert (tl.infer_output_type(tt).to_dict()
            == jl.infer_output_type(jt).to_dict())
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jp = jl.init_params(jax.random.PRNGKey(seed), jdt)
    tp = layer_params_from_jax(
        tl, {k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()})
    tp = {k: v.to(tdt) for k, v in tp.items()}
    jstate = jl.init_state()
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)

    jout, jnew = jl.apply(jp, jx, state=jstate, train=train, rng=None,
                          mask=jm)
    tout, tnew = tl.apply(tp, tx, state=tstate, train=train, mask=tm)
    assert tout.dtype == tdt
    _close(_np(tout), np.asarray(jout.astype(jnp.float32)),
           FWD_TOL if dtype == "float32" else BF16_TOL, "output")
    assert tuple(tout.shape[1:]) == tl.infer_output_type(tt).example_shape() \
        or kind == "rnn"
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        assert tnew[k].dtype == torch.float32
        _close(_np(tnew[k]), np.asarray(jnew[k]), STATE_TOL, k)
    if not grads:
        return tout, tnew
    r = _x(seed + 99, *tout.shape)

    def jloss(p, xx):
        out, _ = jl.apply(p, xx, state=jstate, train=train, rng=None,
                          mask=jm)
        return jnp.sum(out.astype(jnp.float32) * r)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    txg = tx.detach().requires_grad_()
    out, _ = tl.apply(leaves, txg, state=tstate, train=train, mask=tm)
    (out.float() * torch.from_numpy(r)).sum().backward()
    _grad_close(_np(txg.grad), np.asarray(jg_x.astype(jnp.float32)), "dx")
    for k in leaves:
        _grad_close(_np(leaves[k].grad),
                    np.asarray(jg_p[k].astype(jnp.float32)), k)
    return tout, tnew


# ------------------------------------------------------------ convolution

#: (mode, size (H, W), kernel, stride, padding, dilation)
CONV_CASES = [
    ("strict", (7, 7), (3, 3), (1, 1), (0, 0), (1, 1)),
    ("strict", (9, 7), (3, 3), (2, 2), (1, 1), (1, 1)),
    ("truncate", (8, 8), (3, 3), (2, 2), (1, 1), (1, 1)),
    ("truncate", (9, 6), (3, 2), (2, 1), (0, 1), (1, 1)),
    ("same", (7, 7), (3, 3), (1, 1), (0, 0), (1, 1)),
    ("same", (8, 8), (3, 3), (2, 2), (0, 0), (1, 1)),
    ("same", (16, 16), (7, 7), (2, 2), (0, 0), (1, 1)),   # the stem: (2, 3)
    ("same", (9, 8), (4, 4), (2, 2), (0, 0), (1, 1)),
    ("same", (8, 8), (1, 1), (2, 2), (0, 0), (1, 1)),     # a projection
    ("truncate", (9, 9), (3, 3), (1, 1), (0, 0), (2, 2)),
    ("same", (8, 8), (3, 3), (1, 1), (0, 0), (2, 2)),
    ("same", (10, 9), (3, 3), (2, 2), (0, 0), (2, 2)),
]


@pytest.mark.parametrize("mode,size,k,s,p,d", CONV_CASES)
def test_convolution_layer(mode, size, k, s, p, d):
    kw = dict(n_out=5, kernel_size=k, stride=s, padding=p, dilation=d,
              convolution_mode=mode, activation="tanh",
              weight_init="xavier", bias_init=0.1)
    x = _x(1, B, *size, 3)
    _check(jconv.ConvolutionLayer(**kw), tconv.ConvolutionLayer(**kw),
           "cnn", (*size, 3), x)


def test_same_padding_is_asymmetric():
    """XLA's SAME puts the odd pad after: ResNet's 7x7/2 stem on 224 pads
    (2, 3) and its 3x3/2 pool on 112 pads (0, 1). A symmetric pad gives
    the same shape and other values."""
    assert tconv.same_pads(224, 7, 2) == (2, 3)
    assert tconv.same_pads(112, 3, 2) == (0, 1)
    assert tconv.same_pads(7, 3, 1) == (1, 1)
    x = torch.from_numpy(_x(2, 1, 16, 16, 2))
    w = torch.from_numpy(_x(3, 7, 7, 2, 4))
    ours = tconv.conv2d_nhwc(x, w, (2, 2), (0, 0), (1, 1), "same")
    sym = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
                   padding=3).permute(0, 2, 3, 1)
    assert ours.shape == sym.shape
    assert float((ours - sym).abs().max()) > 0.1


def test_strict_mode_refuses_a_ragged_size():
    with pytest.raises(ValueError, match="Strict"):
        tconv.ConvolutionLayer(n_out=2, stride=(2, 2),
                               convolution_mode="strict").infer_output_type(
            InputType.convolutional(8, 8, 1))
    with pytest.raises(ValueError, match="Strict"):
        jconv.ConvolutionLayer(n_out=2, stride=(2, 2),
                               convolution_mode="strict").infer_output_type(
            JInputType.convolutional(8, 8, 1))


def test_convolution_in_bf16_casts_the_input_to_the_kernel():
    kw = dict(n_out=4, kernel_size=(3, 3), stride=(2, 2),
              convolution_mode="same", activation="identity",
              has_bias=False)
    _check(jconv.ConvolutionLayer(**kw), tconv.ConvolutionLayer(**kw),
           "cnn", (8, 8, 3), _x(4, B, 8, 8, 3), dtype="bfloat16",
           grads=False)


@pytest.mark.parametrize("mode,t,k,s,p,d", [
    ("truncate", 11, 3, 1, 0, 1),
    ("truncate", 12, 3, 2, 1, 1),
    ("same", 12, 4, 2, 0, 1),
    ("same", 11, 3, 1, 0, 2),
    ("strict", 9, 3, 2, 0, 1),
])
def test_convolution_1d_layer(mode, t, k, s, p, d):
    kw = dict(n_out=5, kernel_size=(k, 1), stride=(s, 1), padding=(p, 0),
              dilation=(d, 1), convolution_mode=mode, activation="relu",
              bias_init=0.05)
    _check(jconv.Convolution1DLayer(**kw), tconv.Convolution1DLayer(**kw),
           "rnn", (t, 4), _x(5, B, t, 4))


# ---------------------------------------------------------------- pooling

#: (type, mode, size, kernel, stride, padding)
POOL_CASES = [
    (kind, *case) for kind in ("max", "avg", "sum", "pnorm") for case in (
        ("truncate", (8, 8), (2, 2), (2, 2), (0, 0)),
        ("truncate", (9, 7), (3, 3), (2, 2), (1, 1)),   # padded zeros count
        ("same", (8, 8), (3, 3), (2, 2), (0, 0)),       # (0, 1): the stem
        ("same", (7, 9), (3, 2), (2, 3), (0, 0)),
        ("strict", (9, 9), (3, 3), (3, 3), (0, 0)),
    )]


@pytest.mark.parametrize("kind,mode,size,k,s,p", POOL_CASES)
def test_subsampling_layer(kind, mode, size, k, s, p):
    kw = dict(pooling_type=kind, kernel_size=k, stride=s, padding=p,
              convolution_mode=mode, pnorm=3)
    x = _x(6, B, *size, 4)
    if kind == "pnorm":
        x = x + np.sign(x) * 0.1       # keep |x| ** p away from 0's kink
    _check(jconv.SubsamplingLayer(**kw), tconv.SubsamplingLayer(**kw),
           "cnn", (*size, 4), x)


def test_same_max_pool_pads_with_minus_infinity():
    """All-negative input: a zero pad would win the max at the edge."""
    x = torch.full((1, 4, 4, 1), -5.0)
    out = tconv.pool2d_nhwc(x, "max", (3, 3), (2, 2), (0, 0), "same")
    assert torch.equal(out, torch.full((1, 2, 2, 1), -5.0))


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode,t,k,s,p", [
    ("truncate", 11, 3, 2, 1),
    ("same", 10, 3, 2, 0),
])
def test_subsampling_1d_layer(kind, mode, t, k, s, p):
    kw = dict(pooling_type=kind, kernel_size=(k, 1), stride=(s, 1),
              padding=(p, 0), convolution_mode=mode)
    _check(jconv.Subsampling1DLayer(**kw), tconv.Subsampling1DLayer(**kw),
           "rnn", (t, 5), _x(7, B, t, 5))


def test_zero_padding_layer():
    kw = dict(pad=(1, 2, 0, 3))
    _check(jconv.ZeroPaddingLayer(**kw), tconv.ZeroPaddingLayer(**kw),
           "cnn", (5, 4, 2), _x(8, B, 5, 4, 2))


def _rnn_mask(t):
    m = np.ones((B, t), np.float32)
    m[1, 4:] = 0.0
    m[2, :2] = 0.0     # pre-padding
    return m


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("where", ["cnn", "rnn", "rnn_masked"])
def test_global_pooling_layer(kind, where):
    kw = dict(pooling_type=kind, pnorm=3)
    if where == "cnn":
        dims, x, mask = (5, 6, 4), _x(9, B, 5, 6, 4), None
    else:
        dims, x = (7, 4), _x(9, B, 7, 4)
        mask = _rnn_mask(7) if where == "rnn_masked" else None
    tl = tpool.GlobalPoolingLayer(**kw)
    _check(jpool.GlobalPoolingLayer(**kw), tl, where[:3], dims, x,
           mask=mask)
    assert tl.propagate_mask(torch.ones(B, 7)) is None


# ------------------------------------------------------------ batch norm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["cnn", "ff"])
def test_batch_normalization(kind, train, dtype):
    """Training: the batch's population variance normalizes and the new
    state is ``0.9 old + 0.1 batch``, f32 in a bf16 layer. Inference: the
    running state normalizes (a non-trivial one, from a training call)."""
    dims = (5, 4, 3) if kind == "cnn" else (6,)
    x = _x(10, 8, *dims, scale=2.0) + 0.5
    jl, tl = jnorm.BatchNormalization(), tnorm.BatchNormalization()
    grads = dtype == "float32"
    if train:
        _, new = _check(jl, tl, kind, dims, x, train=True, dtype=dtype,
                        grads=grads)
        assert not torch.allclose(new["var"], torch.ones_like(new["var"]))
        return
    # a non-trivial running state: the JAX layer's after two batches
    jt, _ = _types(kind, *dims)
    jl.set_n_in(jt)
    jp = jl.init_params(jax.random.PRNGKey(0))
    state = jl.init_state()
    for seed in (11, 12):
        _, state = jl.apply(jp, jnp.asarray(_x(seed, 8, *dims) * 3 - 1),
                            state=state, train=True, rng=None)
    jl.init_state = lambda: state
    tl.init_state = lambda: {k: torch.from_numpy(np.array(v))
                             for k, v in state.items()}
    _check(jl, tl, kind, dims, x, train=False, dtype=dtype, grads=grads)


def test_batch_normalization_rnn_input_and_locked_gamma_beta():
    """BN over [B, T, F] normalizes over (B, T); with ``lock_gamma_beta``
    it holds no params and scales by the constants."""
    x = _x(13, B, 6, 4)
    _check(jnorm.BatchNormalization(), tnorm.BatchNormalization(), "rnn",
           (6, 4), x, train=True)
    kw = dict(lock_gamma_beta=True, gamma=1.5, beta=-0.25)
    tl = tnorm.BatchNormalization(**kw)
    _check(jnorm.BatchNormalization(**kw), tl, "cnn", (4, 4, 3),
           _x(14, B, 4, 4, 3), train=True)
    assert tl.param_order() == [] and tl.init_params(None) == {}


def test_local_response_normalization():
    """DL4J's LRN, alpha not divided by n: at alpha 1e-2 over x of scale
    3, ``F.local_response_norm`` with the same arguments is another
    function."""
    kw = dict(k=2.0, n=5, alpha=1e-2, beta=0.75)
    x = _x(15, B, 4, 3, 9, scale=3.0)
    out, _ = _check(jnorm.LocalResponseNormalization(**kw),
                    tnorm.LocalResponseNormalization(**kw), "cnn",
                    (4, 3, 9), x)
    torch_lrn = F.local_response_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 5, alpha=1e-2, beta=0.75,
        k=2.0).permute(0, 2, 3, 1)
    assert float((out - torch_lrn).abs().max()) > 1e-2


# ---------------------------------------------------------- shape layers

@pytest.mark.parametrize("name", ["reshape", "permute", "repeat", "pad1d"])
def test_shape_layers(name):
    if name == "reshape":
        kw, kind, dims = dict(target_shape=(3, 8)), "cnn", (2, 3, 4)
        x = _x(16, B, 2, 3, 4)
    elif name == "permute":
        kw, kind, dims = dict(dims=(2, 1)), "rnn", (5, 3)
        x = _x(17, B, 5, 3)
    elif name == "repeat":
        kw, kind, dims = dict(n=4), "ff", (6,)
        x = _x(18, B, 6)
    else:
        kw, kind, dims = dict(padding=(2, 1)), "rnn", (5, 3)
        x = _x(19, B, 5, 3)
    cls = {"reshape": "ReshapeLayer", "permute": "PermuteLayer",
           "repeat": "RepeatVectorLayer", "pad1d": "ZeroPadding1DLayer"}[name]
    jl, tl = getattr(jshape, cls)(**kw), getattr(tshape, cls)(**kw)
    _check(jl, tl, kind, dims, x)
    mask = _rnn_mask(5)
    jm = jl.propagate_mask(jnp.asarray(mask))
    tm = tl.propagate_mask(torch.from_numpy(mask))
    assert (jm is None) == (tm is None)
    if tm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# ---------------------------------------------------------- preprocessors

@pytest.mark.parametrize("name", ["CnnToFeedForwardPreProcessor",
                                  "FeedForwardToCnnPreProcessor",
                                  "CnnToRnnPreProcessor",
                                  "RnnToCnnPreProcessor",
                                  "RnnToFeedForwardPreProcessor",
                                  "FeedForwardToRnnPreProcessor"])
def test_preprocessors(name):
    """Each preprocessor's transform and output type; a CNN flattens in
    NHWC order (h, w, c with c fastest), so a dense W copied from the JAX
    net reads the same feature at the same row."""
    shaped = name in ("FeedForwardToCnnPreProcessor", "RnnToCnnPreProcessor")
    args = (2, 3, 4) if shaped else ()
    jp, tp = getattr(jpre, name)(*args), getattr(tpre, name)(*args)
    src = {"Cnn": ("cnn", (2, 3, 4)), "Fee": ("ff", (24,)),
           "Rnn": ("rnn", (5, 24))}[name[:3]]
    jt, tt = _types(*src[:1], *src[1])
    x = _x(20, B, *src[1])
    got = tp.transform(torch.from_numpy(x), tt).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.transform(
        jnp.asarray(x), jt)))
    assert tp.infer_output_type(tt).to_dict() == \
        jp.infer_output_type(jt).to_dict()
    if name == "CnnToFeedForwardPreProcessor":
        # feature index (h * W + w) * C + c
        assert got[1, (1 * 3 + 2) * 4 + 3] == x[1, 1, 2, 3]


@pytest.mark.parametrize("cur,want", [
    ("cnn", "ff"), ("cnn", "rnn"), ("cnnflat", "cnn"), ("rnn", "ff"),
    ("ff", "rnn"), ("cnn", "cnn"), ("cnn", "any"), ("cnnflat", "ff")])
def test_auto_preprocessor_matches_jax(cur, want):
    make = {"cnn": ("convolutional", (4, 5, 2)),
            "cnnflat": ("convolutional_flat", (4, 5, 2)),
            "rnn": ("recurrent", (7,)), "ff": ("feed_forward", (7,))}[cur]
    jt = getattr(JInputType, make[0])(*make[1])
    tt = getattr(InputType, make[0])(*make[1])
    jp, tp = (jpre.auto_preprocessor(jt, want),
              tpre.auto_preprocessor(tt, want))
    assert type(tp).__name__ == type(jp).__name__
    if tp is not None:
        assert vars(tp) == vars(jp)


# --------------------------------------------------------------- vertices

def _vertex_inputs(name):
    if name in ("SubsetVertex", "ScaleVertex", "ShiftVertex",
                "L2NormalizeVertex", "UnstackVertex"):
        return [_x(21, 4, 6)]
    if name in ("StackVertex", "L2Vertex"):
        return [_x(22, 4, 6), _x(23, 4, 6)]
    if name == "ReshapeVertex":
        return [_x(24, 4, 12)]
    return [_x(25, 4, 5, 3)]        # LastTimeStepVertex


VERTICES = {
    "SubsetVertex": dict(from_index=1, to_index=3),
    "StackVertex": {},
    "UnstackVertex": dict(index=1, num_stacks=2),
    "L2NormalizeVertex": {},
    "L2Vertex": {},
    "ScaleVertex": dict(scale_factor=-2.5),
    "ShiftVertex": dict(shift=0.75),
    "ReshapeVertex": dict(shape=(2, 2, 3)),
    "LastTimeStepVertex": {},
}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertices(name):
    jv = getattr(jgraph, name)(**VERTICES[name])
    tv = getattr(tgraph, name)(**VERTICES[name])
    xs = _vertex_inputs(name)
    want = np.asarray(jv.apply([jnp.asarray(x) for x in xs]))
    got = tv.apply([torch.from_numpy(x) for x in xs]).numpy()
    _close(got, want, FWD_TOL, name)
    assert tv.n_inputs() == jv.n_inputs()
    shape = xs[0].shape[1:]
    if len(shape) == 1:
        jt, tt = _types("ff", *shape)
    else:
        jt, tt = _types("rnn", *shape)
    assert tv.infer_output_type([tt] * len(xs)).to_dict() == \
        jv.infer_output_type([jt] * len(xs)).to_dict()


def test_last_time_step_vertex_masked():
    """Each example's last unmasked step, post- and pre-padded."""
    x = _x(26, B, 7, 4)
    mask = _rnn_mask(7)
    want = np.asarray(jgraph.LastTimeStepVertex().apply_masked(
        [jnp.asarray(x)], jnp.asarray(mask)))
    got = tgraph.LastTimeStepVertex().apply_masked(
        [torch.from_numpy(x)], torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert math.isclose(float(got[1, 0]), float(x[1, 3, 0]))


# ------------------------------------------------------- the graph walk

def _small_graph(pkg):
    """cnn [6, 6, 2] -> conv -> dense (the builder puts a CNN flatten in
    front of it) -> softmax; a time series -> LSTM -> the last unmasked
    step (``LastTimeStepVertex``) -> merged into the dense input."""
    from deeplearning4j_tpu.nn.conf.builder import (
        NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.layers import core as jcore
    from deeplearning4j_tpu.nn.layers import recurrent as jrec
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import core as tcore
    from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
    jax_side = pkg == "jax"
    nnc, core, rec, conv, graph, it = (
        (JNNC, jcore, jrec, jconv, jgraph, JInputType) if jax_side else
        (NeuralNetConfiguration, tcore, trec, tconv, tgraph, InputType))
    g = (nnc.builder().seed(4).updater("sgd", learning_rate=0.1)
         .graph_builder().add_inputs("img", "seq"))
    g.add_layer("conv", conv.ConvolutionLayer(
        n_out=3, kernel_size=(3, 3), convolution_mode="same",
        activation="relu"), "img")
    g.add_layer("dense", core.DenseLayer(n_out=5, activation="tanh"),
                "conv")
    g.add_layer("lstm", rec.LSTM(n_out=4, activation="tanh"), "seq")
    g.add_vertex("last", graph.LastTimeStepVertex(), "lstm")
    g.add_vertex("merge", graph.MergeVertex(), "dense", "last")
    g.add_layer("out", core.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"), "merge")
    return g.set_outputs("out").set_input_types(
        it.convolutional(6, 6, 2), it.recurrent(3, 7)).build()


def test_graph_inserts_the_cnn_flatten_and_masks_the_last_step():
    """The graph builder's preprocessors (a CNN flatten before the dense
    layer, as the JAX builder puts one) and the walk's masked
    ``LastTimeStepVertex``: output and score against the JAX graph."""
    from deeplearning4j_tpu.datasets.dataset import (
        MultiDataSet as JMultiDataSet)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    jnet = JGraph(_small_graph("jax")).init()
    conf = _small_graph("torch")
    pre = {n: type(c.preprocessor).__name__ for n, c in conf.nodes.items()
           if getattr(c, "preprocessor", None) is not None}
    assert pre == {n: type(c.preprocessor).__name__
                   for n, c in jnet.conf.nodes.items()
                   if c.preprocessor is not None} == \
        {"dense": "CnnToFeedForwardPreProcessor"}
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    img, seq = _x(30, B, 6, 6, 2), _x(31, B, 7, 3)
    mask = _rnn_mask(7)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    want = np.asarray(jnet.outputs([jnp.asarray(img), jnp.asarray(seq)],
                                   mask={"seq": jnp.asarray(mask)})[0])
    got = tnet.output([img, seq], mask={"seq": mask}).numpy()
    _close(got, want, FWD_TOL, "output")
    assert tnet.score(MultiDataSet([img, seq], [y], [None, mask])) == \
        pytest.approx(jnet.score(JMultiDataSet(
            [img, seq], [y], [None, mask])), rel=1e-5)
