"""The LSTM training kernels of the port against the JAX package: the
plain versions of K2 (``lstm_fwd_train_plain``) and K3 (``lstm_bwd_plain``)
against the TPU kernels ``_run_lstm_fwd`` / ``_run_lstm_bwd`` in interpret
mode on the same numpy inputs, and the gradients of ``FusedLSTMFunction``
(through ``fused_lstm`` and the recurrent layers) against ``jax.grad``
through the JAX ``fused_lstm`` (interpret mode), as the reference's own
``tests/test_pallas_kernels.py`` holds its kernel against ``lax.scan``.

On the CPU the wrappers run their plain versions, so these tests hold the
plain versions to the TPU kernels' contract; the CUDA kernels are held
against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Sizes are small and not multiples of 8 (the JAX wrapper
pads H to 128 and B to 8; the port does not pad). Tolerances: the
reference's own, 1e-5 forward and 2e-4 for gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.ops import pallas_kernels as jpk

from deeplearning4j_tpu_torch.convert import layer_params_from_jax
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.ops import fused_lstm as tfl

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
B, T, F, H = 3, 6, 5, 5


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas LSTM kernels in interpret mode."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _core(seed, peephole, carry=True, Tn=T, Bn=B, Hn=H):
    xz = _x(seed, Tn, Bn, 4 * Hn)
    rw = _x(seed + 1, Hn, 4 * Hn, scale=0.3)
    pw = (_x(seed + 2, 3, Hn, scale=0.5) if peephole
          else np.zeros((3, Hn), np.float32))
    h0, c0 = ((_x(seed + 3, Bn, Hn, scale=0.5), _x(seed + 4, Bn, Hn))
              if carry else (np.zeros((Bn, Hn), np.float32),) * 2)
    return xz, rw, pw, h0, c0


# --------------------------------------------------- plain K2 / K3 vs JAX

@pytest.mark.parametrize("carry", [True, False], ids=["carry", "zero"])
@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "nopeep"])
def test_plain_k2_matches_jax_fwd_kernel(peephole, carry):
    """hs, the post-activation gates (i, f, g, o) and the cells against
    ``_run_lstm_fwd``, unpadded, with the forget bias."""
    args = _core(0, peephole, carry)
    ref = jpk._run_lstm_fwd(*map(jnp.asarray, args), 1.0, True)
    got = tfl.lstm_fwd_train_plain(*map(_t, args), forget_bias=1.0)
    for name, g, r in zip(("hs", "gates", "cs"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=FWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("seeds", [True, False], ids=["seeded", "zero_seed"])
@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "nopeep"])
def test_plain_k3_matches_jax_bwd_kernel(peephole, seeds):
    """dz, dh0 and dc0 against ``_run_lstm_bwd`` on the JAX forward's
    residuals, with nonzero carries and, seeded, nonzero (dh_T, dc_T);
    also through the wrapper, which takes c0 where the kernel takes
    c_prev."""
    xz, rw, pw, h0, c0 = _core(1, peephole)
    _, gates, cs = jpk._run_lstm_fwd(*map(jnp.asarray, (xz, rw, pw, h0, c0)),
                                     1.0, True)
    gates, cs = np.asarray(gates), np.asarray(cs)
    eps = _x(7, T, B, H)
    dh_T, dc_T = ((_x(8, B, H), _x(9, B, H)) if seeds
                  else (np.zeros((B, H), np.float32),) * 2)
    c_prev = np.concatenate([c0[None], cs[:-1]])
    ref = jpk._run_lstm_bwd(*map(jnp.asarray, (eps, gates, cs, c_prev, rw,
                                               pw, dh_T, dc_T)), True)
    got = tfl.lstm_bwd_plain(*map(_t, (eps, gates, cs, c_prev, rw, pw, dh_T,
                                       dc_T)))
    wrapped = tfl.lstm_bwd(*map(_t, (eps, gates, cs, c0, rw, pw, dh_T,
                                     dc_T)))
    for name, g, w, r in zip(("dz", "dh0", "dc0"), got, wrapped, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   err_msg=name)
        assert torch.equal(g, w), name


def test_plain_k2_carries_what_k1_carries():
    """K2's plain hs and c_T equal K1's bit for bit, in f32 and bf16 (the
    training forward computes what serving does; the card holds the
    kernels to the same)."""
    for dt in (torch.float32, torch.bfloat16):
        args = [_t(a).to(dt) for a in _core(2, True)]
        hs, gates, cs = tfl.lstm_fwd_train_plain(*args, forget_bias=1.0)
        hs1, hT1, cT1 = tfl.lstm_recurrence_plain(*args, forget_bias=1.0)
        assert hs.dtype == gates.dtype == cs.dtype == dt
        assert torch.equal(hs, hs1) and torch.equal(cs[-1], cT1)


def test_bf16_backward_rounds_where_the_tpu_kernel_stores():
    """bf16: dz and the (dh, dc) carries come back in bf16 and track the
    f32 sweep on the same (bf16-representable) inputs within four bf16
    ulps of 1.0, scaled by the largest magnitude."""
    xz, rw, pw, h0, c0 = (_t(a).to(torch.bfloat16) for a in _core(3, True))
    hs, gates, cs = tfl.lstm_fwd_train_plain(xz, rw, pw, h0, c0,
                                             forget_bias=1.0)
    eps, dh_T, dc_T = (_t(_x(s, *sh)).to(torch.bfloat16) for s, sh in (
        (10, (T, B, H)), (11, (B, H)), (12, (B, H))))
    got = tfl.lstm_bwd(eps, gates, cs, c0, rw, pw, dh_T, dc_T)
    ref = tfl.lstm_bwd(*(a.float() for a in (eps, gates, cs, c0, rw, pw,
                                             dh_T, dc_T)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        tol = 3.2e-2 * max(1.0, float(r.abs().max()))
        np.testing.assert_allclose(g.float().numpy(), r.numpy(), atol=tol)


@pytest.mark.parametrize("bad", ["dtype_mix", "cs_shape", "noncontig",
                                 "too_wide", "gates_rank"])
def test_bwd_inputs_outside_the_contract_raise(bad):
    xz, rw, pw, h0, c0 = map(_t, _core(4, True))
    _, gates, cs = tfl.lstm_fwd_train_plain(xz, rw, pw, h0, c0)
    args = dict(eps=torch.zeros(T, B, H), gates=gates, cs=cs, c0=c0, rw=rw,
                pw=pw, dh_T=torch.zeros(B, H), dc_T=torch.zeros(B, H))
    if bad == "dtype_mix":
        args["eps"] = args["eps"].to(torch.bfloat16)
    elif bad == "cs_shape":
        args["cs"] = cs[:-1]
    elif bad == "noncontig":
        args["rw"] = torch.zeros(4 * H, H).t()
    elif bad == "gates_rank":
        args["gates"] = gates[0]
    elif bad == "too_wide":
        Hw = tfl.MAX_HIDDEN + 1
        args = {k: torch.zeros(*s) for k, s in dict(
            eps=(1, 1, Hw), gates=(1, 1, 4 * Hw), cs=(1, 1, Hw), c0=(1, Hw),
            rw=(Hw, 4 * Hw), pw=(3, Hw), dh_T=(1, Hw), dc_T=(1, Hw)).items()}
    with pytest.raises(ValueError):
        tfl.lstm_bwd(**args)


# ------------------------------------------------ the Function's gradients

def _jax_grads(x, wrt, wy):
    """jax.grad through the JAX ``fused_lstm`` of the test loss, w.r.t.
    ``wrt`` = [W, RW, b, h0, c0] and pW when given."""
    def loss(w, rw, b, h0, c0, pw=None):
        ys, hT, cT = jpk.fused_lstm(jnp.asarray(x), w, rw, b, pw, h0, c0,
                                    forget_bias=1.0, interpret=True)
        return (ys * wy).sum() + (hT * 1.7).sum() + (cT * 0.3).sum()
    grads = jax.grad(loss, argnums=tuple(range(len(wrt))))(
        *map(jnp.asarray, wrt))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("Bn,Tn,Fn,Hn", [(3, 6, 5, 5), (6, 5, 7, 21)],
                         ids=["small", "unaligned"])
@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "nopeep"])
def test_function_grads_match_jax_grad(peephole, Bn, Tn, Fn, Hn):
    """dW, dRW, db, dh0, dc0 and dpW of a loss over ys, h_T and c_T
    through ``fused_lstm`` (K2 forward, K3 backward, as plain versions)
    against ``jax.grad`` through the JAX ``fused_lstm`` in interpret mode
    (which pads H to 128 and B to 8)."""
    x = _x(20, Bn, Tn, Fn)
    wrt = [_x(21, Fn, 4 * Hn, scale=0.4), _x(22, Hn, 4 * Hn, scale=0.3),
           _x(23, 4 * Hn, scale=0.2), _x(25, Bn, Hn, scale=0.5),
           _x(26, Bn, Hn)] + ([_x(24, 3 * Hn, scale=0.5)] if peephole
                              else [])
    wy = _x(27, Bn, Tn, Hn)
    ref = _jax_grads(x, wrt, wy)
    leaves = [_t(a).requires_grad_() for a in wrt]
    w, rw, b, h0, c0 = leaves[:5]
    ys, hT, cT = tfl.fused_lstm(_t(x), w, rw, b, leaves[5] if peephole
                                else None, h0, c0, forget_bias=1.0)
    ((ys * _t(wy)).sum() + (hT * 1.7).sum() + (cT * 0.3).sum()).backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, atol=GRAD_TOL)


def test_function_matches_finite_differences():
    """Centred differences of the Function itself (the reference's
    GradientCheckUtil pattern on the custom VJP, f32, eps = 1e-3): dRW
    and dh0 entries agree to 1e-2 relative or the f32 noise floor."""
    rng = np.random.default_rng(4)
    Bs, Ts, Hs = 2, 3, 3
    xz = torch.from_numpy(rng.normal(size=(Ts, Bs, 4 * Hs)).astype(
        np.float32))
    rw = torch.from_numpy((rng.normal(size=(Hs, 4 * Hs)) * 0.3).astype(
        np.float32))
    pw = torch.from_numpy((rng.normal(size=(3, Hs)) * 0.3).astype(
        np.float32))
    h0 = torch.full((Bs, Hs), 0.3)
    c0 = torch.full((Bs, Hs), -0.2)

    def loss(rw_, h0_):
        hs, hT, cT = tfl.lstm_recurrence(xz, rw_, pw, h0_, c0,
                                         forget_bias=1.0)
        return (hs ** 2).sum() * 0.5 + (cT * 0.7).sum()

    rw_g, h0_g = rw.clone().requires_grad_(), h0.clone().requires_grad_()
    loss(rw_g, h0_g).backward()
    eps = 1e-3
    for base, grad, idxs in ((rw, rw_g.grad, [(0, 0), (1, 5), (2, 7),
                                              (0, 3 * Hs)]),
                             (h0, h0_g.grad, [(0, 0), (1, 2)])):
        for idx in idxs:
            up, dn = base.clone(), base.clone()
            up[idx] += eps
            dn[idx] -= eps
            args = ((up, h0), (dn, h0)) if base is rw else ((rw, up),
                                                            (rw, dn))
            with torch.no_grad():
                fd = float(loss(*args[0]) - loss(*args[1])) / (2 * eps)
            g = float(grad[idx])
            rel = abs(fd - g) / max(abs(fd) + abs(g), 1e-8)
            assert rel < 1e-2 or abs(fd - g) < 2e-5, (idx, fd, g)


def _layer_pair(jcls, tcls, seed=0):
    """A JAX recurrent layer and its port twin with the same random
    params (zero-initialised b and pW overwritten too)."""
    jl, tl = jcls(n_out=H, activation="tanh"), tcls(n_out=H,
                                                    activation="tanh")
    jl.set_n_in(JInputType.recurrent(F, T))
    tl.set_n_in(InputType.recurrent(F, T))
    shapes = {k: v.shape for k, v in jl.init_params(
        jax.random.PRNGKey(seed)).items()}
    np_p = {k: _x(seed + i + 1, *s, scale=0.4)
            for i, (k, s) in enumerate(sorted(shapes.items()))}
    return jl, tl, np_p, layer_params_from_jax(tl, np_p)


LAYERS = {"LSTM": (jrec.LSTM, trec.LSTM),
          "GravesLSTM": (jrec.GravesLSTM, trec.GravesLSTM),
          "GravesBidirectionalLSTM": (jrec.GravesBidirectionalLSTM,
                                      trec.GravesBidirectionalLSTM)}


@pytest.mark.parametrize("masked", [False, True], ids=["kernel", "masked"])
@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_param_grads_match_jax(case, masked):
    """Every param's gradient of a loss over a layer's output: unmasked
    through the kernel path on both sides (the bidirectional layer's
    reverse direction on the flipped sequence), masked through the
    ``_lstm_cell`` loop (``lax.scan`` in JAX), differentiable through
    autograd."""
    jl, tl, np_p, tp = _layer_pair(*LAYERS[case])
    x, wy = _x(30, B, T, F), _x(31, B, T, H)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[1, 4:] = 0.0
        mask[2, :2] = 0.0
    if not masked and case != "GravesBidirectionalLSTM":
        assert tl._fused_kernel_ok(None)

    def jloss(p):
        ys, _ = jl.apply(p, jnp.asarray(x), state={}, train=False, rng=None,
                         mask=None if mask is None else jnp.asarray(mask))
        return (ys * wy).sum()
    ref = jax.grad(jloss)({k: jnp.asarray(v) for k, v in np_p.items()})
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    ys, _ = tl.apply(leaves, _t(x), state={},
                     mask=None if mask is None else _t(mask))
    (ys * _t(wy)).sum().backward()
    for k, r in ref.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(r),
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
def test_scan_carry_grads_match_jax(reverse):
    """Cotangents of the initial carry through ``LSTM.scan``'s kernel path
    (the tBPTT path between windows; the reference's
    ``test_fused_carry_grads``), forwards and reversed, with a loss on
    the final carry too."""
    jl, tl, np_p, tp = _layer_pair(jrec.GravesLSTM, trec.GravesLSTM, 3)
    x = _x(32, B, T, F)
    h0, c0 = _x(33, B, H, scale=0.5), _x(34, B, H)

    def jloss(h0, c0):
        ys, (hT, cT) = jl.scan({k: jnp.asarray(v) for k, v in np_p.items()},
                               jnp.asarray(x), (h0, c0), None,
                               reverse=reverse)
        return (ys ** 2).sum() + (hT * cT).sum()
    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h0), jnp.asarray(c0))
    h0_t, c0_t = _t(h0).requires_grad_(), _t(c0).requires_grad_()
    ys, (hT, cT) = tl.scan(tp, _t(x), (h0_t, c0_t), None, reverse=reverse)
    ((ys ** 2).sum() + (hT * cT).sum()).backward()
    for got, r in ((h0_t.grad, ref[0]), (c0_t.grad, ref[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=GRAD_TOL)


# ------------------------------------------------- which branch runs where

def test_the_function_picks_k1_without_grad_and_k2_k3_with(monkeypatch):
    """Spied on the CPU, where the plain versions stand in for the
    kernels: under ``torch.no_grad()``, or with no input requiring grad,
    the Function runs K1's plain version and saves nothing; with grad it
    runs K2's forward, and its backward K3's, once each. The outputs
    agree either way."""
    calls = []
    for name in ("lstm_recurrence_plain", "lstm_fwd_train_plain",
                 "lstm_bwd_plain"):
        real = getattr(tfl, name)
        monkeypatch.setattr(tfl, name, (lambda r, n: lambda *a, **k: (
            calls.append(n), r(*a, **k))[1])(real, name))
    args = [_t(a) for a in _core(5, True)]
    with torch.no_grad():
        hs0, _, c0 = tfl.lstm_recurrence(
            *[a.requires_grad_() for a in args], forget_bias=1.0)
    assert calls == ["lstm_recurrence_plain"] and hs0.grad_fn is None
    calls.clear()
    hs1, _, _ = tfl.lstm_recurrence(*[a.detach() for a in args])
    assert calls == ["lstm_recurrence_plain"] and hs1.grad_fn is None
    calls.clear()
    hs, hT, cT = tfl.lstm_recurrence(*args, forget_bias=1.0)
    assert calls == ["lstm_fwd_train_plain"]
    assert torch.equal(hs, hs0) and torch.equal(cT, c0)
    (hs.sum() + cT.sum()).backward()
    assert calls == ["lstm_fwd_train_plain", "lstm_bwd_plain"]
    assert tfl.lstm_fwd_train.launches == tfl.lstm_bwd.launches == 0
