"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips without a card (a
CUDA kernel has no CPU mode). This file imports no JAX, so it runs on the
card's machine, which has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest \
        -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets up JAX.)
"""

import ast
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.keras.generation import (
    GenerationScheduler, StepRunner,
)
from deeplearning4j_tpu_torch.models.resnet import resnet_tiny
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization, LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.netcommon import value_and_grad
from deeplearning4j_tpu_torch.nn.updater import tree_leaves, tree_map
from deeplearning4j_tpu_torch.resilience.service import Deadline
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.gpt import (
    gpt_decoder, gpt_tiny, greedy_generate,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, attention_dvec, flash_attention, flash_attention_bwd_plain,
    flash_attention_dkv, flash_attention_dq, flash_attention_plain,
)
from deeplearning4j_tpu_torch.ops import fused_lstm as fused_lstm_module
from deeplearning4j_tpu_torch.ops.fused_lstm import (
    BWD_RESIDENT_MAX_HIDDEN, MAX_HIDDEN, RESIDENT_MAX_HIDDEN, fused_lstm,
    launch_plan, lstm_bwd,
    lstm_bwd_plain, lstm_fwd_train, lstm_fwd_train_plain, lstm_recurrence,
    lstm_recurrence_plain,
)

ROOT = Path(__file__).resolve().parent.parent
#: the resident body's widest H in f32 and bf16, and the first H past it
RES_F32 = RESIDENT_MAX_HIDDEN[torch.float32]
RES_BF16 = RESIDENT_MAX_HIDDEN[torch.bfloat16]
#: K3's resident body's widest H in bf16, below K1/K2's
RES3_BF16 = BWD_RESIDENT_MAX_HIDDEN[torch.bfloat16]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,T,D,causal,dtype", [
    (2, 3, 300, 64, True, "float32"),
    (2, 3, 300, 64, True, "bfloat16"),
    (1, 2, 77, 8, False, "float32"),
    (1, 2, 130, 128, True, "float32"),
    (2, 1, 64, 40, False, "bfloat16"),
    (32, 8, 256, 64, True, "float32"),     # the GPT slice's shape
    (2, 4, 256, 128, True, "bfloat16"),    # the 128 template
    (2, 2, 99, 32, True, "float32"),       # T = 16 k + 3: a ragged mma edge
    (2, 2, 35, 6, True, "float32"),        # rows of 24 bytes: no cp.async
    (2, 2, 35, 20, False, "bfloat16"),     # rows of 40 bytes: no cp.async
    (2, 2, 200, 256, True, "float32"),     # the widest template: two
    (2, 2, 200, 256, True, "bfloat16"),    # warps share each row's o
    (1, 2, 70, 200, False, "float32"),     # a head between 128 and 256
    (2, 2, 150, 320, True, "float32"),     # the wide template: o's columns
    (2, 2, 130, 512, True, "bfloat16"),    # in chunks of 256 across blocks
    (2, 1, 128, 1024, False, "float32"),
    (2, 1, 40, 300, True, "bfloat16"),     # a ragged last chunk, no cp.async
])
def test_flash_kernel_matches_plain(card, B, H, T, D, causal, dtype):
    """Ragged T, every head-dim template (32/64/128/256 and the wide one),
    rows that cp.async cannot move, a key mask with a hole and a batch row
    with no valid key (exact zeros, NEG_INF lse). Two launches are bitwise
    equal."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(T + D)
    q, k, v = (torch.randn(B, H, T, D, generator=g).to(card, dt)
               for _ in range(3))
    mask = torch.ones(B, T)
    mask[:, T // 3: T // 2] = 0.0
    mask[0] = 0.0
    mask = mask.to(card)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         kv_mask=mask)
    # f32: reduction order only; bf16: O rounds to bf16 on both sides,
    # so two bf16 ulps of 1.0
    tol = 2e-5 if dt == torch.float32 else 1.6e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert torch.all(out[0] == 0) and torch.all(lse[0] == NEG_INF)
    out2, lse2 = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                 return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_skips_padded_key_tiles(card, dtype):
    """Padded rows (lengths 64-256 of 256): whole key tiles are invalid
    and K4 skips them by a block vote. O and lse match the plain forward,
    and every row has a valid key, so none is zero."""
    dt = getattr(torch, dtype)
    B, H, T, D = 4, 2, 256, 64
    g = torch.Generator().manual_seed(22)
    q, k, v = (torch.randn(B, H, T, D, generator=g).to(card, dt)
               for _ in range(3))
    lengths = [256, 64, 100, 190]
    mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]
            ).float().to(card)
    for causal in (True, False):
        out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                   return_lse=True)
        ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                             kv_mask=mask)
        tol = 2e-5 if dt == torch.float32 else 1.6e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        assert bool(torch.all(lse > NEG_INF / 2))


def _bwd_inputs(card, B, H, T, D, causal, dt):
    """q, k, v, dO and a key mask with a hole and a batch row with no
    valid key; the forward's out and lse from the K4 kernel."""
    g = torch.Generator().manual_seed(T * D + B)
    q, k, v, d_out = (torch.randn(B, H, T, D, generator=g).to(card, dt)
                      for _ in range(4))
    mask = torch.ones(B, T)
    mask[:, T // 3: T // 2] = 0.0
    mask[0] = 0.0
    mask = mask.to(card)
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    return q, k, v, d_out, mask, out, lse


@pytest.mark.parametrize("B,H,T,D,causal,dtype", [
    (2, 3, 300, 64, True, "float32"),
    (2, 3, 300, 64, True, "bfloat16"),
    (1, 2, 77, 8, False, "float32"),
    (1, 2, 130, 128, True, "float32"),
    (2, 1, 64, 40, False, "bfloat16"),
    (32, 8, 256, 64, True, "float32"),     # the GPT training slice's shape
    (2, 4, 256, 128, True, "float32"),     # the 128 template
    (2, 4, 256, 128, True, "bfloat16"),
    (2, 2, 99, 32, True, "float32"),       # T = 16 k + 3: a ragged mma edge
    (2, 2, 35, 6, True, "float32"),        # rows of 24 bytes: no cp.async
    (2, 2, 35, 20, False, "bfloat16"),     # rows of 40 bytes: no cp.async
    (2, 2, 200, 256, True, "float32"),     # the widest template: warps
    (2, 2, 200, 256, True, "bfloat16"),    # share rows (dq) or keys (dk/dv)
    (1, 2, 70, 200, False, "float32"),     # a head between 128 and 256
    (2, 2, 150, 320, True, "float32"),     # the wide template: dq, dk, dv
    (2, 2, 130, 512, True, "bfloat16"),    # in column chunks of 256
    (2, 1, 128, 1024, False, "float32"),
    (2, 1, 40, 300, True, "bfloat16"),     # a ragged last chunk, no cp.async
])
def test_flash_bwd_kernels_match_plain(card, B, H, T, D, causal, dtype):
    """K5 (dq) and K6 (dk, dv) against the plain FA2 backward: ragged T,
    every head-dim template, a masked hole, and a batch row with no valid
    key, whose dq, dk and dv are exactly 0. Two launches on the same
    inputs are bitwise equal (no atomics)."""
    dt = getattr(torch, dtype)
    q, k, v, d_out, mask, out, lse = _bwd_inputs(card, B, H, T, D, causal,
                                                 dt)
    dvec = attention_dvec(d_out, out)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq = flash_attention_dq(q, k, v, d_out, lse, dvec, causal=causal,
                            kv_mask=mask)
    dk, dv = flash_attention_dkv(q, k, v, d_out, lse, dvec, causal=causal,
                                 kv_mask=mask)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = flash_attention_bwd_plain(q, k, v, d_out, out, lse, causal=causal,
                                    kv_mask=mask)
    # f32: the reference's own grad tolerance; bf16: the grads round to
    # bf16 on both sides, two bf16 ulps; both scaled by the largest |g|
    rel = 5e-5 if dt == torch.float32 else 1.6e-2
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dt and torch.isfinite(got).all()
        tol = rel * max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
        assert torch.all(got[0] == 0)
    again = flash_attention_dq(q, k, v, d_out, lse, dvec, causal=causal,
                               kv_mask=mask)
    dk2, dv2 = flash_attention_dkv(q, k, v, d_out, lse, dvec, causal=causal,
                                   kv_mask=mask)
    assert torch.equal(again, dq) and torch.equal(dk2, dk) \
        and torch.equal(dv2, dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_skip_padded_key_tiles(card, dtype):
    """Padded rows, as serving batches have them (lengths 64-256 of 256):
    whole 64-key tiles are invalid, which K5 skips and K6 answers with
    zeros. The grads match the plain backward, the padded keys' dk and dv
    are exactly 0, and two launches are bitwise equal."""
    dt = getattr(torch, dtype)
    B, H, T, D = 4, 2, 256, 64
    g = torch.Generator().manual_seed(21)
    q, k, v, d_out = (torch.randn(B, H, T, D, generator=g).to(card, dt)
                      for _ in range(4))
    lengths = [256, 64, 100, 190]
    mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]
            ).float().to(card)
    out, lse = flash_attention(q, k, v, causal=True, kv_mask=mask,
                               return_lse=True)
    dvec = attention_dvec(d_out, out)
    kw = dict(causal=True, kv_mask=mask)
    dq = flash_attention_dq(q, k, v, d_out, lse, dvec, **kw)
    dk, dv = flash_attention_dkv(q, k, v, d_out, lse, dvec, **kw)
    ref = flash_attention_bwd_plain(q, k, v, d_out, out, lse, **kw)
    rel = 5e-5 if dt == torch.float32 else 1.6e-2
    for got, want in zip((dq, dk, dv), ref):
        tol = rel * max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
    for b, n in enumerate(lengths):
        assert torch.all(dk[b, :, n:] == 0) and torch.all(dv[b, :, n:] == 0)
    assert torch.equal(dq, flash_attention_dq(q, k, v, d_out, lse, dvec,
                                              **kw))
    dk2, dv2 = flash_attention_dkv(q, k, v, d_out, lse, dvec, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_attention_on_card_is_differentiable(card):
    """Grad-requiring inputs give an output with a grad_fn, and backward
    runs one K5 and one K6 launch whose grads equal the CPU's."""
    g = torch.Generator().manual_seed(9)
    cpu = [torch.randn(2, 2, 70, 16, generator=g) for _ in range(4)]
    got, want = [], []
    for dev, out_grads in ((card, got), ("cpu", want)):
        q, k, v = (t.to(dev).requires_grad_() for t in cpu[:3])
        out = flash_attention(q, k, v, causal=True)
        assert out.grad_fn is not None
        before = (flash_attention_dq.launches, flash_attention_dkv.launches)
        (out * cpu[3].to(dev)).sum().backward()
        launched = (flash_attention_dq.launches - before[0],
                    flash_attention_dkv.launches - before[1])
        assert launched == ((1, 1) if dev == card else (0, 0))
        out_grads.extend(t.grad.cpu() for t in (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)


def test_gpt_tiny_on_card_matches_cpu(card):
    """The whole slice at a tiny size: output() through the kernel (one
    launch per attention layer), greedy tokens equal to the CPU net's."""
    conf = gpt_tiny(vocab_size=16, seq_len=16)
    gpu = ComputationGraph(conf, device=card).init()
    cpu = ComputationGraph(gpt_tiny(vocab_size=16, seq_len=16),
                           device="cpu").init()
    rng = np.random.default_rng(0)
    x = np.eye(16, dtype=np.float32)[rng.integers(0, 16, (3, 16))]
    mask = np.ones((3, 16), np.float32)
    mask[1, 9:] = 0.0
    before = flash_attention.launches
    got = gpu.output(x, mask=mask)
    assert flash_attention.launches == before + 2
    torch.testing.assert_close(got.cpu(), cpu.output(x, mask=mask),
                               atol=1e-5, rtol=0)
    for prompt in ([1], [3, 4, 5], list(range(9))):
        assert greedy_generate(gpu, prompt, 6) == \
            greedy_generate(cpu, prompt, 6)


def test_wide_head_gpt_on_card_matches_cpu(card):
    """Heads of dim 256 (d_model 512 over 2 heads) run the kernels' widest
    template: output() launches K4 once, within 1e-5 of the CPU net's;
    one gradient and one fit_batch launch K4, K5 and K6 once each, every
    gradient within 1e-4 of its largest |g| of the CPU's, the fit_batch
    loss within 1e-5 relative."""
    kw = dict(vocab_size=16, seq_len=16, d_model=512, n_heads=2,
              n_layers=1, block_size=6)
    gpu = ComputationGraph(gpt_decoder(**kw), device=card).init()
    cpu = ComputationGraph(gpt_decoder(**kw), device="cpu").init()
    rng = np.random.default_rng(2)
    eye = np.eye(16, dtype=np.float32)
    tok = rng.integers(0, 16, (3, 17))
    x, y = eye[tok[:, :-1]], eye[tok[:, 1:]]
    mask = np.ones((3, 16), np.float32)
    mask[1, 9:] = 0.0
    before = (flash_attention.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    got = gpu.output(x, mask=mask)
    grads, _, _ = gpu.compute_gradient_and_score(DataSet(x, y))
    loss = float(gpu.fit_batch(DataSet(x, y)))
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == (before[0] + 3, before[1] + 2,
                                              before[2] + 2)
    torch.testing.assert_close(got.cpu(), cpu.output(x, mask=mask),
                               atol=1e-5, rtol=0)
    cpu_grads, _, _ = cpu.compute_gradient_and_score(DataSet(x, y))
    for node, p in cpu_grads.items():
        for name, want in p.items():
            torch.testing.assert_close(
                grads[node][name].cpu(), want, rtol=0,
                atol=1e-4 * float(want.abs().max()))
    assert loss == pytest.approx(float(cpu.fit_batch(DataSet(x, y))),
                                 rel=1e-5)


def test_head_dim_512_gpt_on_card_matches_cpu(card):
    """Heads of 512 (d_model 1024 over 2 heads) run the kernels' wide
    template: output() launches K4 once, within 1e-5 of the CPU net's; one
    gradient and one fit_batch launch K4, K5 and K6 once each, every
    gradient within 1e-4 of its largest |g| of the CPU's, the fit_batch
    loss within 1e-5 relative."""
    kw = dict(vocab_size=16, seq_len=16, d_model=1024, n_heads=2,
              n_layers=1)
    gpu = ComputationGraph(gpt_decoder(**kw), device=card).init()
    cpu = ComputationGraph(gpt_decoder(**kw), device="cpu").init()
    rng = np.random.default_rng(4)
    eye = np.eye(16, dtype=np.float32)
    tok = rng.integers(0, 16, (3, 17))
    x, y = eye[tok[:, :-1]], eye[tok[:, 1:]]
    mask = np.ones((3, 16), np.float32)
    mask[1, 9:] = 0.0
    before = (flash_attention.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    got = gpu.output(x, mask=mask)
    grads, _, _ = gpu.compute_gradient_and_score(DataSet(x, y))
    loss = float(gpu.fit_batch(DataSet(x, y)))
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == (before[0] + 3, before[1] + 2,
                                              before[2] + 2)
    torch.testing.assert_close(got.cpu(), cpu.output(x, mask=mask),
                               atol=1e-5, rtol=0)
    cpu_grads, _, _ = cpu.compute_gradient_and_score(DataSet(x, y))
    for node, p in cpu_grads.items():
        for name, want in p.items():
            torch.testing.assert_close(
                grads[node][name].cpu(), want, rtol=0,
                atol=1e-4 * float(want.abs().max()))
    assert loss == pytest.approx(float(cpu.fit_batch(DataSet(x, y))),
                                 rel=1e-5)


def test_gpt_tiny_training_on_card_matches_cpu(card):
    """The training slice at a tiny size: each step launches K4, K5 and K6
    once per attention layer (and no LSTM kernel); the step-1 gradients
    are within 1e-4 of each tensor's largest |g| of the CPU net's (f32
    GEMMs in another order, TF32 off) and 3 Adam steps' losses within
    1e-5 relative."""
    gpu = ComputationGraph(gpt_tiny(vocab_size=16, seq_len=16),
                           device=card).init()
    cpu = ComputationGraph(gpt_tiny(vocab_size=16, seq_len=16),
                           device="cpu").init()
    rng = np.random.default_rng(1)
    eye = np.eye(16, dtype=np.float32)
    tok = rng.integers(0, 16, (3, 17))
    mask = np.ones((3, 16), np.float32)
    mask[1, 9:] = 0.0
    ds = DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]], mask, mask)
    got, loss, _ = gpu.compute_gradient_and_score(ds)
    want, cpu_loss, _ = cpu.compute_gradient_and_score(ds)
    assert float(loss) == pytest.approx(float(cpu_loss), rel=1e-5)
    for node, p in want.items():
        for name, w in p.items():
            tol = 1e-4 * max(float(w.abs().max()), 1e-30)
            torch.testing.assert_close(got[node][name].cpu(), w, atol=tol,
                                       rtol=0)
    wrappers = (flash_attention, flash_attention_dq, flash_attention_dkv,
                lstm_recurrence)
    for _ in range(3):
        before = [f.launches for f in wrappers]
        a = float(gpu.fit_batch(ds))
        assert [f.launches - b for f, b in zip(wrappers, before)] == \
            [2, 2, 2, 0]
        assert a == pytest.approx(float(cpu.fit_batch(ds)), rel=1e-5)


@pytest.mark.parametrize("T,B,H,dtype,peephole,carry", [
    (7, 3, 100, "float32", True, True),      # ragged B and H, nonzero carry
    (1, 32, 256, "float32", True, True),     # the streaming step
    (64, 32, 256, "bfloat16", True, False),   # see the tolerance note
    (64, 32, 256, "float32", False, False),  # plain LSTM: pw = 0
    (5, 201, 64, "float32", True, True),     # more rows than SMs, ragged
    (2, 2, MAX_HIDDEN, "float32", True, True),  # the widest H
    (1, 1, 256, "float32", True, True),      # one row: one cluster, 7 idle
    (9, 11, RES_F32, "float32", True, True),      # the resident body's
    (9, 11, RES_BF16, "bfloat16", True, True),    # widest H, and just
    (9, 11, RES_F32 + 1, "float32", True, True),  # past it (streaming)
])
def test_lstm_kernel_matches_plain(card, T, B, H, dtype, peephole, carry):
    args = _lstm_args(card, T, B, H, getattr(torch, dtype), peephole, carry)
    before = lstm_recurrence.launches
    got = lstm_recurrence(*args, forget_bias=1.0)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    ref = lstm_recurrence_plain(*args, forget_bias=1.0)
    _assert_lstm_close(got, ref)


def _lstm_args(card, T, B, H, dt, peephole, carry):
    g = torch.Generator().manual_seed(T * B + H)
    xz = torch.randn(T, B, 4 * H, generator=g)
    rw = torch.randn(H, 4 * H, generator=g) * H ** -0.5
    pw = (torch.randn(3, H, generator=g) * 0.3 if peephole
          else torch.zeros(3, H))
    h0, c0 = ((torch.randn(B, H, generator=g) * 0.5,
               torch.randn(B, H, generator=g)) if carry
              else (torch.zeros(B, H), torch.zeros(B, H)))
    return [a.to(card, dt).contiguous() for a in (xz, rw, pw, h0, c0)]


def _assert_lstm_close(got, ref):
    """f32: summation order only (the JAX package's forward tolerance);
    bf16: the carry rounds to bf16 on both sides, so a one-ulp flip can
    feed back: four bf16 ulps of 1.0. c is not bounded by 1: its
    tolerance scales with its largest magnitude."""
    dt = ref[0].dtype
    tol = 1e-5 if dt == torch.float32 else 3.2e-2
    tol_c = tol * max(1.0, float(ref[2].float().abs().max()))
    for a, b, t in zip(got, ref, (tol, tol, tol_c)):
        assert a.dtype == dt
        torch.testing.assert_close(a.float(), b.float(), atol=t, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_kernel_equals_its_own_steps(card, dtype):
    """One launch over 64 steps equals 64 one-step launches chained
    through their carries bit for bit (the carry lives in the input type
    both ways), and each one-step launch is within the tolerance of the
    plain step from the same carry. A rounding flip that a unit with its
    forget gate near 1 keeps can grow over many bf16 steps; held step by
    step, it cannot hide a fault."""
    xz, rw, pw, h0, c0 = _lstm_args(card, 64, 32, 256, getattr(torch, dtype),
                                    True, False)
    hs, _, cT = lstm_recurrence(xz, rw, pw, h0, c0, forget_bias=1.0)
    h, c = h0, c0
    for t in range(xz.shape[0]):
        step = lstm_recurrence(xz[t:t + 1], rw, pw, h, c, forget_bias=1.0)
        _assert_lstm_close(step, lstm_recurrence_plain(
            xz[t:t + 1], rw, pw, h, c, forget_bias=1.0))
        assert torch.equal(step[0][0], hs[t])
        _, h, c = step
    assert torch.equal(c, cT)


def _assert_body_follows_the_limit(name, limits):
    """The C entry of ``name`` runs the resident body (clusters of 8 CTAs,
    one per 4 batch rows) up to ``limits``, else the streaming body, and
    the card holds at least 8 clusters at once."""
    for B, H, dt in ((32, 256, torch.float32), (1, 256, torch.float32),
                     (64, 256, torch.bfloat16), (200, 256, torch.float32),
                     (32, RES_F32, torch.float32),
                     (32, RES_BF16, torch.bfloat16),
                     (32, RES3_BF16, torch.bfloat16),
                     (32, RES3_BF16 + 1, torch.bfloat16),
                     (32, RES_F32 + 1, torch.float32),
                     (32, MAX_HIDDEN, torch.float32)):
        plan = launch_plan(name, B, H, dt)
        resident = H <= limits[dt]
        assert plan["body"] == ("resident" if resident else "streaming"), \
            (B, H, dt, plan)
        assert plan["rows_per_cluster"] == (4 if resident else 0)
        if resident:
            clusters = -(-B // 4)
            assert plan["cluster"] == 8 and plan["blocks"] == 8 * clusters
            assert plan["max_active_clusters"] >= min(clusters, 8)
        else:
            assert plan["blocks"] == B


@pytest.mark.parametrize("name", ["lstm_fwd_infer", "lstm_fwd_train"])
def test_lstm_fwd_kernels_pick_their_body_from_h_and_dtype(card, name):
    """K1 and K2: resident up to ``RESIDENT_MAX_HIDDEN``."""
    _assert_body_follows_the_limit(name, RESIDENT_MAX_HIDDEN)


def test_lstm_bwd_kernel_picks_its_body_from_h_and_dtype(card):
    """K3: resident up to ``BWD_RESIDENT_MAX_HIDDEN`` (312 in f32, as
    K1/K2; 420 in bf16, below their 424)."""
    _assert_body_follows_the_limit("lstm_bwd", BWD_RESIDENT_MAX_HIDDEN)


def test_lstm_bwd_is_resident_only_where_every_cta_owns_a_unit(card):
    """K3's resident body holds each CTA to the others' pace by the
    partials it receives every step; a CTA that owns no unit receives
    none, ran ahead into a receive buffer not yet read and trapped (H = 7
    and 33, after ``chip_smoke.py`` on the same card), so such H take the
    streaming body. Every H up to 64 takes the body that rule gives, and
    100 launches at H = 7, 8, 33 and 36 (the last CTA owning none, one,
    none and one unit) each equal the first, within 2e-4 of the plain
    sweep."""
    for H in range(1, 65):
        resident = 7 * -(-H // 8) < H
        assert launch_plan("lstm_bwd", 5, H, torch.float32)["body"] == (
            "resident" if resident else "streaming"), H
    for H in (7, 8, 33, 36):
        xz, rw, pw, h0, c0 = _lstm_args(card, 6, 5, H, torch.float32, True,
                                        True)
        _, gates, cs = lstm_fwd_train(xz, rw, pw, h0, c0, forget_bias=1.0)
        g = torch.Generator().manual_seed(H)
        eps, dh_T, dc_T = (torch.randn(*s, generator=g).to(card)
                           for s in ((6, 5, H), (5, H), (5, H)))
        args = (eps, gates, cs, c0, rw, pw, dh_T, dc_T)
        first = lstm_bwd(*args)
        for _ in range(100):
            again = lstm_bwd(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), H
        c_prev = torch.cat([c0[None], cs[:-1]])
        for got, want in zip(first, lstm_bwd_plain(
                eps, gates, cs, c_prev, rw, pw, dh_T, dc_T)):
            _scaled_close(got, want, 2e-4)


def test_lstm_kernel_refuses_a_hidden_size_past_its_shared_memory(card):
    """The wrapper's check stops H > MAX_HIDDEN on every device; past it
    the kernel's shared memory outgrows a block's default, so the launch
    itself fails and the wrapper raises rather than returning garbage."""
    args = _lstm_args(card, 1, 1, MAX_HIDDEN + 1, torch.float32, True, True)
    with pytest.raises(ValueError):
        lstm_recurrence(*args)
    before = lstm_recurrence.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_lstm_module._launch(*args, 0.0)
    assert lstm_recurrence.launches == before


def test_fused_lstm_wrapper_on_card_matches_cpu(card):
    """The batch-major wrapper (input GEMM, transposes, kernel) on the
    card against the same call on the CPU."""
    g = torch.Generator().manual_seed(5)
    B, T, F, H = 5, 9, 17, 40
    cpu = [torch.randn(*s, generator=g) * 0.4 for s in (
        (B, T, F), (F, 4 * H), (H, 4 * H), (4 * H,), (3 * H,), (B, H),
        (B, H))]
    before = lstm_recurrence.launches
    got = fused_lstm(*[a.to(card) for a in cpu], forget_bias=1.0)
    assert lstm_recurrence.launches == before + 1
    want = fused_lstm(*cpu, forget_bias=1.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def test_char_rnn_tiny_on_card_matches_cpu(card):
    """The char-RNN slice at a tiny size: output() through the kernel (one
    launch per LSTM layer), the masked output through the step loop (no
    launch), and rnn_time_step (one launch per layer and step), all equal
    to the CPU net."""
    V = 13
    gpu = MultiLayerNetwork(char_rnn_lstm(V, hidden=24, layers=2),
                            device=card).init()
    cpu = MultiLayerNetwork(char_rnn_lstm(V, hidden=24, layers=2),
                            device="cpu").init()
    rng = np.random.default_rng(0)
    B, T = 3, 11
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    mask = np.ones((B, T), np.float32)
    mask[1, 6:] = 0.0
    before = lstm_recurrence.launches
    got = gpu.output(x)
    assert lstm_recurrence.launches == before + 2
    torch.testing.assert_close(got.cpu(), cpu.output(x), atol=1e-5, rtol=0)
    got_m = gpu.output(x, mask=mask)
    assert lstm_recurrence.launches == before + 2
    torch.testing.assert_close(got_m.cpu(), cpu.output(x, mask=mask),
                               atol=1e-5, rtol=0)
    steps = [gpu.rnn_time_step(x[:, t]) for t in range(T)]
    assert lstm_recurrence.launches == before + 2 + 2 * T
    torch.testing.assert_close(torch.stack(steps, 1).cpu(), got.cpu(),
                               atol=1e-5, rtol=0)


def _scaled_close(got, want, rel):
    """Within ``rel`` times max(1, max |want|) (c, dz and the carries are
    not bounded by 1)."""
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    tol = rel * max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("T,B,H,dtype,peephole,carry", [
    (7, 3, 100, "float32", True, True),      # ragged B and H, carries, seeds
    (50, 32, 256, "float32", True, False),   # the char-RNN's tBPTT window
    (14, 32, 256, "float32", True, True),    # the short last window
    (50, 32, 256, "bfloat16", True, False),
    (50, 32, 256, "float32", False, False),  # plain LSTM: pw = 0
    (5, 201, 64, "float32", True, True),     # more rows than SMs, ragged
    (3, 2, MAX_HIDDEN, "float32", True, True),  # the widest H: K3 raises
                                                # its shared-memory limit
    (9, 11, RES_F32, "float32", True, True),      # the resident body's
    (9, 11, RES_BF16, "bfloat16", True, True),    # widest H, and just
    (9, 11, RES_F32 + 1, "float32", True, True),  # past it (streaming)
    (9, 11, RES3_BF16, "bfloat16", True, True),      # K3's widest resident
    (9, 11, RES3_BF16 + 1, "bfloat16", True, True),  # H in bf16 and past it
    (6, 5, 7, "float32", True, True),    # CTAs that own no unit: K1/K2
    (4, 9, 33, "float32", True, True),   # resident, K3 streaming
])
def test_lstm_train_kernels_match_plain(card, T, B, H, dtype, peephole,
                                        carry):
    """K2 against its plain version, and its hs and c_T against K1's bit
    for bit; K3, seeded with nonzero (dh_T, dc_T), against its plain
    version on K2's residuals. Two launches of each are bitwise equal (no
    atomics). Tolerances: f32 the reference's own (forward 1e-5, backward
    2e-4); bf16 four bf16 ulps of 1.0; each scaled by max(1, max |x|)."""
    dt = getattr(torch, dtype)
    xz, rw, pw, h0, c0 = _lstm_args(card, T, B, H, dt, peephole, carry)
    before = (lstm_fwd_train.launches, lstm_bwd.launches,
              lstm_recurrence.launches)
    hs, gates, cs = lstm_fwd_train(xz, rw, pw, h0, c0, forget_bias=1.0)
    torch.cuda.synchronize()
    f32 = dt == torch.float32
    for got, want in zip((hs, gates, cs), lstm_fwd_train_plain(
            xz, rw, pw, h0, c0, forget_bias=1.0)):
        _scaled_close(got, want, 1e-5 if f32 else 3.2e-2)
    with torch.no_grad():
        hs1, _, cT1 = lstm_recurrence(xz, rw, pw, h0, c0, forget_bias=1.0)
    assert torch.equal(hs, hs1) and torch.equal(cs[-1], cT1)
    g = torch.Generator().manual_seed(T + H)
    eps, dh_T, dc_T = (torch.randn(*s, generator=g).to(card, dt)
                       for s in ((T, B, H), (B, H), (B, H)))
    got = lstm_bwd(eps, gates, cs, c0, rw, pw, dh_T, dc_T)
    torch.cuda.synchronize()
    c_prev = torch.cat([c0[None], cs[:-1]])
    for a, b in zip(got, lstm_bwd_plain(eps, gates, cs, c_prev, rw, pw,
                                        dh_T, dc_T)):
        _scaled_close(a, b, 2e-4 if f32 else 3.2e-2)
    again = lstm_bwd(eps, gates, cs, c0, rw, pw, dh_T, dc_T)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(
        (hs, gates, cs), lstm_fwd_train(xz, rw, pw, h0, c0,
                                        forget_bias=1.0)))
    assert (lstm_fwd_train.launches, lstm_bwd.launches,
            lstm_recurrence.launches) == (before[0] + 2, before[1] + 2,
                                          before[2] + 1)


def test_lstm_train_kernels_refuse_past_the_widest_hidden_size(card):
    args = _lstm_args(card, 1, 1, MAX_HIDDEN + 1, torch.float32, True, True)
    with pytest.raises(ValueError):
        lstm_fwd_train(*args)
    H = MAX_HIDDEN + 1
    with pytest.raises(ValueError):
        lstm_bwd(*(torch.zeros(*s, device=card) for s in (
            (1, 1, H), (1, 1, 4 * H), (1, 1, H), (1, H), (H, 4 * H), (3, H),
            (1, H), (1, H))))


def test_fused_lstm_on_card_is_differentiable(card):
    """Grad-requiring inputs run K2 forward and K3 backward once each (and
    no K1); every gradient, W, RW, b, pW, h0 and c0, equals the CPU's
    within 1e-4 of its largest |g|. Under no_grad the call runs K1."""
    g = torch.Generator().manual_seed(11)
    B, T, F, H = 5, 9, 17, 40
    cpu = [torch.randn(*s, generator=g) * 0.4 for s in (
        (B, T, F), (F, 4 * H), (H, 4 * H), (4 * H,), (3 * H,), (B, H),
        (B, H))]
    w_out = torch.randn(B, T, H, generator=g)
    grads = []
    for dev in (card, "cpu"):
        x, *params = (a.to(dev) for a in cpu)
        params = [p.requires_grad_() for p in params]
        before = (lstm_fwd_train.launches, lstm_bwd.launches,
                  lstm_recurrence.launches)
        ys, hT, cT = fused_lstm(x, *params, forget_bias=1.0)
        assert ys.grad_fn is not None
        ((ys * w_out.to(dev)).sum() + (hT * 1.7).sum()
         + (cT * 0.3).sum()).backward()
        launched = (lstm_fwd_train.launches - before[0],
                    lstm_bwd.launches - before[1],
                    lstm_recurrence.launches - before[2])
        assert launched == ((1, 1, 0) if dev == card else (0, 0, 0))
        grads.append([p.grad.cpu() for p in params])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    before = (lstm_fwd_train.launches, lstm_recurrence.launches)
    with torch.no_grad():
        fused_lstm(*[a.to(card) for a in cpu], forget_bias=1.0)
    assert (lstm_fwd_train.launches, lstm_recurrence.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.parametrize("bwd", [6, 3], ids=["bwd_eq_fwd", "bwd_lt_fwd"])
def test_char_rnn_tiny_tbptt_on_card_matches_cpu(card, bwd):
    """The LSTM training slice at a tiny size: a [3, 14] batch in tBPTT
    windows of 6 (6 + 6 + 2): per window 2 K2 and 2 K3 launches (one per
    LSTM layer), plus 2 K1 for each window's head when bwd < fwd; the
    step-1 gradients within 1e-4 of each tensor's largest |g| of the CPU
    net's, and 2 fit_batch calls' mean losses within 1e-5 relative."""
    V = 13
    conf = char_rnn_lstm(V, hidden=24, layers=2, tbptt_length=6)
    conf.training.tbptt_bwd_length = bwd
    gpu = MultiLayerNetwork(conf, device=card).init()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(2)
    eye = np.eye(V, dtype=np.float32)
    tok = rng.integers(0, V, (3, 15))
    ds = DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]])
    got, loss, _ = gpu.compute_gradient_and_score(ds)
    want, cpu_loss, _ = cpu.compute_gradient_and_score(ds)
    assert float(loss) == pytest.approx(float(cpu_loss), rel=1e-5)
    for p, q in zip(got, want):
        for name, w in q.items():
            torch.testing.assert_close(p[name].cpu(), w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()))
    wrappers = (lstm_fwd_train, lstm_bwd, lstm_recurrence, flash_attention)
    for _ in range(2):
        before = [f.launches for f in wrappers]
        a = float(gpu.fit_batch(ds))
        assert [f.launches - b for f, b in zip(wrappers, before)] == \
            [6, 6, 0 if bwd == 6 else 4, 0]
        assert a == pytest.approx(float(cpu.fit_batch(ds)), rel=1e-5)


# ------------------------------------------------- the CNN slice's layers
# cuDNN's convolution and pooling and PyTorch's batch norm on the card
# against the same port code on the CPU (TF32 off). f32: 1e-5 x max(1,
# max |y|), gradients 1e-4 of each tensor's largest |g|; bf16: two bf16
# ulps (2^-7) x max(1, max |y|), since both sides round sums taken in
# another order to bf16.

def _layer_on_card_and_cpu(card, layer, in_type, x, dtype, train=False,
                           state=None):
    """``layer`` shaped for ``in_type`` on [B, ...] input ``x``: its
    output (and new state) on the card and on the CPU, and for f32 the
    gradients of a fixed projection with respect to the input and every
    param on each."""
    layer.set_n_in(in_type)
    dt = getattr(torch, dtype)
    params = {k: v.to(dt) for k, v in layer.init_params(
        torch.Generator().manual_seed(3), torch.float32).items()}
    if isinstance(layer, BatchNormalization):      # not the identity init
        g = torch.Generator().manual_seed(4)
        params = {k: (torch.rand(v.shape, generator=g) + 0.5).to(dt)
                  for k, v in params.items()}
    state = state if state is not None else layer.init_state()
    out = {}
    for dev in (card, torch.device("cpu")):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xx = torch.from_numpy(x).to(dev, dt).requires_grad_()
        y, new = layer.apply(p, xx, state={k: v.to(dev)
                                           for k, v in state.items()},
                             train=train)
        r = torch.randn(y.shape, generator=torch.Generator().manual_seed(6))
        (y.float() * r.to(dev)).sum().backward()
        out[dev.type] = (y.detach().float().cpu(),
                         {k: v.cpu() for k, v in new.items()},
                         {"x": xx.grad.float().cpu(),
                          **{k: v.grad.float().cpu() for k, v in p.items()}})
    return out["cuda"], out["cpu"]


def _assert_layer_close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    (y, s, g), (y0, s0, g0) = got, want
    torch.testing.assert_close(y, y0, rtol=0,
                               atol=tol * max(1.0, float(y0.abs().max())))
    for k in s0:
        assert s[k].dtype == torch.float32
        torch.testing.assert_close(s[k], s0[k], rtol=0, atol=1e-5 * max(
            1.0, float(s0[k].abs().max())))
    if dtype == "float32":
        for k in g0:
            torch.testing.assert_close(g[k], g0[k], rtol=0, atol=1e-4 * max(
                float(g0[k].abs().max()), 1e-30), msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["stem_7x7s2_224", "3x3s2_56", "1x1s2_56",
                                  "3x3_dilated_truncate"])
def test_conv_on_card_matches_cpu(card, case, dtype):
    """ResNet-50's stem (7x7/2 ``same`` on 224: XLA pads (2, 3)), its
    3x3/2 and 1x1/2 convolutions at 56, and a dilated truncate one."""
    k, s, size, cin, cout, mode, d = {
        "stem_7x7s2_224": (7, 2, 224, 3, 64, "same", 1),
        "3x3s2_56": (3, 2, 56, 32, 32, "same", 1),
        "1x1s2_56": (1, 2, 56, 32, 64, "same", 1),
        "3x3_dilated_truncate": (3, 1, 30, 16, 24, "truncate", 2)}[case]
    layer = ConvolutionLayer(n_out=cout, kernel_size=(k, k), stride=(s, s),
                             dilation=(d, d), convolution_mode=mode,
                             activation="identity", weight_init="relu",
                             has_bias=case.endswith("truncate"))
    x = np.random.default_rng(7).random((2, size, size, cin),
                                        dtype=np.float32)
    got, want = _layer_on_card_and_cpu(
        card, layer, InputType.convolutional(size, size, cin), x, dtype)
    _assert_layer_close(got, want, dtype)


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_same_pool_on_card_matches_cpu(card, kind):
    """ResNet-50's 3x3/2 ``same`` pool on 112 (pads (0, 1): -inf for max,
    the unpadded count for avg)."""
    layer = SubsamplingLayer(pooling_type=kind, kernel_size=(3, 3),
                             stride=(2, 2), convolution_mode="same")
    x = np.random.default_rng(8).normal(size=(2, 112, 112, 16)).astype(
        np.float32)
    got, want = _layer_on_card_and_cpu(
        card, layer, InputType.convolutional(112, 112, 16), x, "float32")
    _assert_layer_close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_batch_norm_on_card_matches_cpu(card, train, dtype):
    """Training: the batch's population variance and the new f32 state;
    inference: a non-trivial running state."""
    layer = BatchNormalization()
    g = torch.Generator().manual_seed(9)
    state = {"mean": torch.randn(64, generator=g),
             "var": torch.rand(64, generator=g) + 0.5}
    x = (np.random.default_rng(10).normal(size=(8, 28, 28, 64)) * 2 + 0.5
         ).astype(np.float32)
    got, want = _layer_on_card_and_cpu(
        card, layer, InputType.convolutional(28, 28, 64), x, dtype,
        train=train, state=state)
    _assert_layer_close(got, want, dtype)


def test_lrn_on_card_matches_cpu(card):
    layer = LocalResponseNormalization(k=2.0, n=5, alpha=1e-2, beta=0.75)
    x = (np.random.default_rng(11).normal(size=(2, 13, 13, 96)) * 3
         ).astype(np.float32)
    got, want = _layer_on_card_and_cpu(
        card, layer, InputType.convolutional(13, 13, 96), x, "float32")
    _assert_layer_close(got, want, "float32")


def _f64_gradient(net, x, y, device):
    """The loss, gradients and new BN states of ``net`` with its params,
    states and the batch cast to f64 on ``device``."""
    p64 = tree_map(lambda t: t.to(device, torch.float64), net.params)
    s64 = tree_map(lambda t: t.to(device, torch.float64), net.states)
    loss, states, grads = value_and_grad(lambda p: net._loss_fn(
        p, s64, {"in": torch.from_numpy(x).to(device, torch.float64)},
        {"out": torch.from_numpy(y).to(device, torch.float64)}, None, None,
        None), p64)
    return float(loss), params_to_numpy(grads), params_to_numpy(states)


def test_resnet_tiny_on_card_matches_cpu(card):
    """The full-depth ResNet-50 body at 64x64 (batch 4): ``output()``;
    in f64 (params, states and batch cast) the card's loss, every
    gradient and the BN states against the CPU's within 1e-9; in f32 the
    loss and the BN states of a step within 1e-4 and the gradients within
    10% relative L2 and a cosine of 0.99 of each tensor's f64 one (53 BN
    layers in training mode at random init leave f32 gradients on the
    card and on the CPU alike a few percent from f64: chip_smoke.py's
    ResNet-50 twin, ROADMAP C7); then ``output()`` with the running
    states the step left."""
    conf = resnet_tiny(height=64, width=64)
    gpu = ComputationGraph(conf, device=card).init()
    cpu = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(12)
    x = rng.random((4, 64, 64, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    ds = DataSet(x, y)
    torch.testing.assert_close(gpu.output(x).cpu(), cpu.output(x), rtol=0,
                               atol=1e-5)
    loss64, ref, ref_states = _f64_gradient(cpu, x, y, "cpu")
    card64, got64, states64 = _f64_gradient(gpu, x, y, card)
    assert card64 == pytest.approx(loss64, rel=1e-9)
    for node in ref:
        for name, w in ref[node].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got64[node][name], w, rtol=0,
                                       atol=1e-9 * scale)
    for node in ref_states:
        for name, w in ref_states[node].items():
            np.testing.assert_allclose(states64[node][name], w, rtol=0,
                                       atol=1e-9)
    got, loss, states = gpu.compute_gradient_and_score(ds)
    assert float(loss) == pytest.approx(loss64, rel=1e-4)
    got = params_to_numpy(got)
    num = sum(float(((got[n][k] - w) ** 2).sum())
              for n in ref for k, w in ref[n].items())
    den = sum(float((w ** 2).sum()) for n in ref for w in ref[n].values())
    assert (num / den) ** 0.5 <= 0.1
    for node in ref:
        for name, w in ref[node].items():
            g = got[node][name].astype(np.float64)
            cos = (g * w).sum() / max(np.sqrt((g * g).sum() * (w * w).sum()),
                                      1e-300)
            assert cos >= 0.99, (node, name, cos)
    states = params_to_numpy(states)
    for node in ref_states:
        for name, w in ref_states[node].items():
            np.testing.assert_allclose(states[node][name], w, rtol=0,
                                       atol=1e-4 * max(1.0,
                                                       np.abs(w).max()))
    assert float(gpu.fit_batch(ds)) == pytest.approx(
        float(cpu.fit_batch(ds)), rel=1e-4)
    torch.testing.assert_close(gpu.output(x).cpu(), cpu.output(x), rtol=0,
                               atol=1e-4)


# ------------------------------------------- the serving engine's graphs

SERVE_V, SERVE_T, SERVE_NEW = 13, 16, 6


def _serving_net(card, **kw):
    return ComputationGraph(gpt_tiny(vocab_size=SERVE_V, seq_len=SERVE_T,
                                     **kw), device=card).init()


def _serving_prompts(seed=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SERVE_V, k).tolist() for k in (3, 7, 2, 5, 4, 6)]


def _serve(sched, net, prompts, lock=None):
    results, res_lock = {}, threading.Lock()

    def one(i):
        r = sched.submit("m", net, lock or threading.Lock(), prompts[i],
                         SERVE_NEW, Deadline(120))
        with res_lock:
            results[i] = r["tokens"]

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    return [results[i] for i in range(len(prompts))]


def _clone_pool(pool):
    return {n: {k: v.clone() for k, v in kv.items()} for n, kv in pool.items()}


def _restore_pool(pool, snapshot):
    for n, kv in pool.items():
        for k, v in kv.items():
            v.copy_(snapshot[n][k])


def _pools_equal(a, b):
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def test_graphed_steps_equal_eager_steps_bitwise(card):
    """For every decode bucket (1, 2, 4, 8 rows) and every prefill bucket
    (1 to 16 positions): the CUDA-graph runner's probabilities and the
    pool (or the prefill's cache) it leaves are bitwise equal to the
    eager step's from the same state. Each decode bucket maps distinct
    pages per row, a row without pages aliasing scratch page 0."""
    net = _serving_net(card)
    pl = net.kv_page_len()
    ppr = SERVE_T // pl
    gen = torch.Generator(device=card).manual_seed(0)
    pool = net.init_kv_page_pool(8 * ppr + 1, pl)
    for kv in pool.values():
        for v in kv.values():
            v.copy_(torch.randn(v.shape, generator=gen, device=card))
    snapshot = _clone_pool(pool)
    step = net.paged_decode_fn(pl)
    rng = np.random.default_rng(4)
    eye = np.eye(SERVE_V, dtype=np.float32)
    for rows in (1, 2, 4, 8):
        runner = StepRunner(net, "decode", rows, pl, pool=pool)
        assert runner.graphed and runner.nbytes > 0
        table = rng.permutation(np.arange(1, 8 * ppr + 1))[:rows * ppr] \
            .reshape(rows, ppr).astype(np.int64)
        if rows > 1:
            table[-1] = 0
        positions = rng.integers(0, SERVE_T, rows).astype(np.int64)
        x = eye[rng.integers(0, SERVE_V, rows)][:, None, :]
        eager = _clone_pool(snapshot)
        probs_e, _ = step(net.params, net.states, eager,
                          torch.from_numpy(x).to(card),
                          torch.from_numpy(positions).to(card),
                          torch.from_numpy(table).to(card))
        _restore_pool(pool, snapshot)      # undo the warm-up's page-0 write
        probs_g, out = runner(net.params, net.states, pool, x, positions,
                              table)
        assert out is pool
        assert np.array_equal(probs_g, probs_e.cpu().numpy()), rows
        assert _pools_equal(pool, eager), rows
        _restore_pool(pool, snapshot)
    prefill, _ = net.decode_fns()
    for bucket in (1, 2, 4, 8, 16):
        runner = StepRunner(net, "prefill", bucket, pl)
        L = max(1, bucket - 1)
        x = np.zeros((1, bucket, SERVE_V), np.float32)
        x[0, :L] = eye[rng.integers(0, SERVE_V, L)]
        lengths = np.asarray([L], np.int64)
        probs_e, caches_e = prefill(
            net.params, net.states, net.init_decode_cache(1),
            torch.from_numpy(x).to(card), torch.from_numpy(lengths).to(card))
        probs_g, caches_g = runner(net.params, net.states, x, lengths)
        assert np.array_equal(probs_g, probs_e.cpu().numpy()), bucket
        assert _pools_equal(caches_g, caches_e), bucket


def test_engine_serves_new_weights_after_fit_batch_and_reinit(card):
    """A ``fit_batch`` between two waves updates the params in place: the
    graphs read the new weights without a capture, and the second wave's
    tokens are the card's singleton references on them. Params REPLACED
    by ``init(params=...)`` move to new addresses: the next call of each
    bucket re-captures (counted), never replays the old weights. Each
    wave brings new prompts (the prompt registry keeps prefills of the
    old weights, ROADMAP C9). The decode loop is kept alive between the
    waves (the first ``fit_batch`` builds the kernels): a retired loop's
    engine leaves with its pool, and a new pool is new addresses, which
    the decode graphs would rightly capture again."""
    net = _serving_net(card, learning_rate=0.05)
    waves = [[[(t + s) % SERVE_V for t in p] for p in _serving_prompts()]
             for s in range(3)]
    sched = GenerationScheduler(max_rows=8, prewarm_decode_ladder=True,
                                idle_thread_s=600.0)
    try:
        assert _serve(sched, net, waves[0]) == \
            [greedy_generate(net, p, SERVE_NEW) for p in waves[0]]
        compiles = sched.stats()["compiles"]
        old = [greedy_generate(net, p, SERVE_NEW) for p in waves[1]]
        rng = np.random.default_rng(5)
        tok = rng.integers(0, SERVE_V, (4, SERVE_T + 1))
        eye = np.eye(SERVE_V, dtype=np.float32)
        for _ in range(3):
            net.fit_batch(DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]]))
        new = [greedy_generate(net, p, SERVE_NEW) for p in waves[1]]
        assert new != old
        assert _serve(sched, net, waves[1]) == new
        assert sched.stats()["compiles"] == compiles
        net.init(params={n: {k: v.cpu() * 1.5 for k, v in p.items()}
                         for n, p in net.params.items()})
        assert _serve(sched, net, waves[2]) == \
            [greedy_generate(net, p, SERVE_NEW) for p in waves[2]]
        assert sched.stats()["compiles"] > compiles
        assert max(sched.stats()["bucket_compiles"].values()) == 2
    finally:
        sched.stop()


def test_capture_while_another_thread_holds_the_model_lock(card):
    """The engine captures its graphs on its own thread, outside the
    model lock: while another thread holds that lock and keeps the card
    busy on the default stream, the first request's buckets are captured
    (thread-local capture on a side stream), and the request completes
    with its singleton tokens once the lock is free."""
    net = _serving_net(card)
    other = _serving_net(card)
    prompt = _serving_prompts()[1]
    ref = greedy_generate(net, prompt, SERVE_NEW)
    x = np.eye(SERVE_V, dtype=np.float32)[np.zeros((8, SERVE_T), int)]
    lock = threading.Lock()
    release = threading.Event()
    held = threading.Event()

    def hold():
        with lock:
            held.set()
            while not release.is_set():
                other.output(x)
                torch.cuda.current_stream().synchronize()

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    assert held.wait(30.0)
    sched = GenerationScheduler(max_rows=2)
    out = {}
    try:
        client = threading.Thread(target=lambda: out.setdefault(
            "r", sched.submit("m", net, lock, prompt, SERVE_NEW,
                              Deadline(120))), daemon=True)
        client.start()
        t_end = time.monotonic() + 60.0
        while sched.stats()["compiles"] < 1 and time.monotonic() < t_end:
            time.sleep(0.01)
        captured_while_held = sched.stats()["compiles"]
        assert "r" not in out             # still waiting for the lock
        release.set()
        holder.join(60.0)
        client.join(120.0)
        assert not holder.is_alive() and not client.is_alive()
        assert captured_while_held >= 1
        assert out["r"]["tokens"] == ref
    finally:
        release.set()
        sched.stop()


# ------------------------------------------------- predict CUDA graphs

def _predict_case(card, which):
    """A small char-RNN (its LSTMs launch K1) or the 2-layer GPT (its
    attention launches K4) on the card, the K1/K4 wrapper, the kernel
    launches of one forward, and a feature row shape."""
    if which == "char_rnn":
        net = MultiLayerNetwork(char_rnn_lstm(16, 32, 2),
                                device=card).init()
        return net, lstm_recurrence, 2, (8, 16)
    return _serving_net(card), flash_attention, 2, (SERVE_T, SERVE_V)


@pytest.mark.parametrize("which", ["char_rnn", "gpt"])
def test_predict_graphs_equal_eager_output_bitwise(card, which):
    """Each predict bucket's CUDA graph (1, 2, 4, 8 rows) captures the
    container's ``_infer_fn()`` with K1 or K4 inside, and its replay is
    bitwise equal to an eager ``output()`` of the same padded batch. The
    wrapper's launch counter counts the capture (the warm-ups and the
    captured call), not the replays: replays add nothing to it."""
    from deeplearning4j_tpu_torch.keras.batching import PredictRunner
    net, kernel, per_call, row = _predict_case(card, which)
    rng = np.random.default_rng(11)
    eye = np.eye(row[-1], dtype=np.float32)
    for bucket in (1, 2, 4, 8):
        kernel.launches = 0
        traces = net._infer_traces
        runner = PredictRunner(net, bucket, (row, "float32"))
        assert runner.graphed and runner.nbytes > 0
        assert net._infer_traces == traces + 1
        assert kernel.launches == (PredictRunner.WARMUP + 1) * per_call
        x = eye[rng.integers(0, row[-1], (bucket, row[0]))]
        eager = net.output(x).cpu().numpy()
        kernel.launches = 0
        for _ in range(3):
            got = runner(net, x)
            assert np.array_equal(got, eager), (which, bucket)
        assert kernel.launches == 0            # replays are not counted


def test_server_fit_leaves_the_predict_graphs_current(card, tmp_path):
    """A ``KerasServer`` on the card (``device=None``): a char-RNN's
    predict bucket is captured once; a ``fit`` op (tBPTT, K2 and K3)
    updates the params in place, so the next predicts replay the same
    graph (no capture) and answer the fitted weights: bitwise the served
    net's eager ``output()`` of the same padded batch."""
    from deeplearning4j_tpu_torch.keras.server import (KerasClient,
                                                       KerasServer)
    net = MultiLayerNetwork(char_rnn_lstm(16, 32, 2, tbptt_length=4),
                            device=card).init()
    path = str(tmp_path / "rnn.zip")
    ModelSerializer.write_model(net, path)
    rng = np.random.default_rng(12)
    eye = np.eye(16, dtype=np.float32)
    fdir, ldir = tmp_path / "f", tmp_path / "l"
    fdir.mkdir()
    ldir.mkdir()
    for i in range(2):
        ids = rng.integers(0, 16, (4, 9))
        np.save(fdir / f"{i}.npy", eye[ids[:, :-1]])
        np.save(ldir / f"{i}.npy", eye[ids[:, 1:]])
    x = eye[rng.integers(0, 16, (3, 8))]
    np.save(tmp_path / "x.npy", x)
    srv = KerasServer(max_batch=8, max_wait_ms=2.0, prewarm=False)
    try:
        cli = KerasClient(srv.host, srv.port)
        before = cli.predict(str(tmp_path / "x.npy"), model=path)
        served = srv._models[path]
        compiles = srv._batcher.stats()["compiles"]
        assert served._infer_traces == 1 and compiles == 1
        lstm_fwd_train.launches = lstm_bwd.launches = 0
        cli.fit(path, str(fdir), str(ldir), nb_epoch=1)
        assert lstm_fwd_train.launches > 0 and lstm_bwd.launches > 0
        after = cli.predict(str(tmp_path / "x.npy"), model=path)
        assert srv._batcher.stats()["compiles"] == compiles
        assert served._infer_traces == 1
        padded = np.concatenate([x, np.zeros((1, 8, 16), np.float32)])
        want = served.output(padded).cpu().numpy()[:3]
        assert np.array_equal(after, want)
        assert not np.array_equal(after, before)
        cli.close()
    finally:
        srv.drain(grace_s=5.0)


# ------------------------------------------------------ the fleet

def test_fleet_on_card_answers_singletons_and_fails_over(card, tmp_path):
    """Two ``FleetReplica`` gateways on the card (``device=None``) behind
    a ``FleetRouter``: a 1-row char-RNN and a 1-row GPT predict through
    the router equal the replica's eager singleton ``output()`` bit for
    bit (the bucket-1 graph replays K1 / K4); a streamed generate whose
    replica dies at its 3rd token (every member is armed, so whichever
    the router picks dies, and the survivor streams the last token)
    resumes by re-prefill with the singleton's greedy tokens; threads
    return to their baseline after the drains and ``close()``."""
    from deeplearning4j_tpu_torch.keras.fleet import (FleetReplica,
                                                      FleetRouter)
    from deeplearning4j_tpu_torch.keras.server import KerasClient
    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule)
    rnn = MultiLayerNetwork(char_rnn_lstm(16, 32, 2), device=card).init()
    paths = {"char_rnn": str(tmp_path / "rnn.zip"),
             "gpt": str(tmp_path / "gpt.zip")}
    ModelSerializer.write_model(rnn, paths["char_rnn"])
    ModelSerializer.write_model(_serving_net(card), paths["gpt"])
    rng = np.random.default_rng(14)
    xs = {"char_rnn": np.eye(16, dtype=np.float32)[rng.integers(0, 16,
                                                               (1, 8))],
          "gpt": np.eye(SERVE_V, dtype=np.float32)[
              rng.integers(0, SERVE_V, (1, SERVE_T))]}
    for name, x in xs.items():
        np.save(tmp_path / f"{name}.npy", x)
    base = set(threading.enumerate())
    fdir = str(tmp_path / "fleet")
    router = FleetRouter(fdir, poll_s=0.1, heartbeat_timeout_s=1.5,
                         metrics_port=None, empty_pool_wait_s=60.0)
    reps = [FleetReplica(fdir, r, model=paths["gpt"], max_batch=8)
            for r in (0, 1)]
    try:
        assert router.wait_for_replicas(2, timeout_s=120.0)
        cli = KerasClient(router.host, router.port)
        try:
            for name, x in xs.items():
                got = cli.predict(str(tmp_path / f"{name}.npy"),
                                  model=paths[name])
                served = reps[0].server._models[paths[name]]
                want = served.output(x).float().cpu().numpy()
                assert np.array_equal(got, want), name
            gpt = reps[0].server._models[paths["gpt"]]
            prompt = _serving_prompts(29)[1]
            ref = greedy_generate(gpt, prompt, 4)
            for rep in reps:           # warm each engine, not routed
                direct = KerasClient(rep.host, rep.port)
                direct.generate(_serving_prompts(31)[0], 4,
                                model=paths["gpt"])
                direct.close()
            faultinject.set_schedule(FaultSchedule(
                [Fault("kill_replica", rank=r, step=3) for r in (0, 1)]))
            resp = cli.request(op="generate", tokens=prompt,
                               max_new_tokens=4, model=paths["gpt"],
                               stream=True)
        finally:
            faultinject.clear()
            cli.close()
        assert resp["tokens"] == ref and resp["failovers"] >= 1
        assert sum(not rep.alive for rep in reps) == 1
    finally:
        router.close()
        for rep in reps:
            rep.drain(grace_s=5.0)
    t_end = time.monotonic() + 15.0
    while set(threading.enumerate()) - base and time.monotonic() < t_end:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - base


def test_fleet_kill_and_capture_lock_in_both_orders(card, tmp_path):
    """Replicas in one process share ``CAPTURE_LOCK``. (1) A replica
    killed while another holds the lock (mid-capture) is torn down and
    removed without waiting for it. (2) A replica killed while its own
    dispatcher waits on the lock to capture: its ``stop(2.0)`` join times
    out and releases its cache slice; once the lock is free the capture
    ends, serves nothing and caches nothing for the dead owner. Threads
    return to their baseline."""
    from deeplearning4j_tpu_torch.keras.batching import CAPTURE_LOCK
    from deeplearning4j_tpu_torch.keras.fleet import (FleetReplica,
                                                      FleetRouter)
    from deeplearning4j_tpu_torch.keras.server import KerasClient
    from deeplearning4j_tpu_torch.resilience import faultinject
    from deeplearning4j_tpu_torch.resilience.faultinject import (
        Fault, FaultSchedule)
    net = MultiLayerNetwork(char_rnn_lstm(16, 32, 2), device=card).init()
    path = str(tmp_path / "rnn.zip")
    ModelSerializer.write_model(net, path)
    eye = np.eye(16, dtype=np.float32)
    rng = np.random.default_rng(15)
    for rows in (1, 3):
        np.save(tmp_path / f"x{rows}.npy",
                eye[rng.integers(0, 16, (rows, 8))])
    base = set(threading.enumerate())
    fdir = str(tmp_path / "fleet")
    router = FleetRouter(fdir, poll_s=0.1, heartbeat_timeout_s=1.5,
                         metrics_port=None)
    reps = [FleetReplica(fdir, r, model=path, max_batch=8, prewarm=False)
            for r in (0, 1, 2)]

    def direct(rep, rows, out):
        cli = KerasClient(rep.host, rep.port)
        try:
            out.append(cli.predict(str(tmp_path / f"x{rows}.npy"),
                                   model=path))
        except (RuntimeError, OSError, ValueError) as e:
            out.append(e)
        finally:
            cli.close()

    try:
        assert router.wait_for_replicas(3, timeout_s=120.0)
        # (1) killed while another replica holds the lock
        with CAPTURE_LOCK:
            faultinject.set_schedule(FaultSchedule(
                [Fault("kill_replica", rank=0, at_call=1)]))
            out = []
            direct(reps[0], 1, out)
            t_end = time.monotonic() + 15.0
            while 0 in router.replicas() and time.monotonic() < t_end:
                time.sleep(0.05)
            assert not reps[0].alive and 0 not in router.replicas()
        faultinject.clear()
        # (2) killed while its own capture waits on the lock
        cache = reps[1].server._batcher._compiled
        owner = reps[1].server._batcher._cache_owner
        out = []
        with CAPTURE_LOCK:
            t = threading.Thread(target=direct, args=(reps[1], 3, out),
                                 daemon=True)
            t.start()
            time.sleep(1.0)             # its dispatcher waits on the lock
            reps[1].kill()
            t.join(30.0)
            time.sleep(3.0)             # the reaper's 2 s join timed out
            assert not [k for k in cache.keys() if k[0] == owner]
        t_end = time.monotonic() + 30.0
        while (any(th.name.startswith("batch-dispatch")
                   for th in threading.enumerate())
               and time.monotonic() < t_end):
            time.sleep(0.05)
        assert isinstance(out[0], Exception)
        assert not [k for k in cache.keys() if k[0] == owner]
        # the survivor still serves, through the router
        cli = KerasClient(router.host, router.port)
        try:
            cli.predict(str(tmp_path / "x3.npy"), model=path)
        finally:
            cli.close()
        assert router.replicas() == [2]
    finally:
        faultinject.clear()
        router.close()
        for rep in reps:
            rep.drain(grace_s=5.0)
    t_end = time.monotonic() + 15.0
    while set(threading.enumerate()) - base and time.monotonic() < t_end:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - base


# ---------------------------------------------------- zip checkpoints

def test_gpt_checkpoint_round_trip_on_card_is_bitwise(card, tmp_path):
    """A GPT trained on the card, written and restored onto the card
    (``device=None``): its outputs, its next step's loss and params and
    its updater state equal the source's bit for bit, and the restored
    net launches K4/K5/K6 as often as the source."""
    net = _serving_net(card, learning_rate=0.05)
    rng = np.random.default_rng(9)
    eye = np.eye(SERVE_V, dtype=np.float32)

    def batch(seed):
        tok = np.random.default_rng(seed).integers(0, SERVE_V,
                                                   (4, SERVE_T + 1))
        return DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]])

    for s in range(2):
        net.fit_batch(batch(s))
    path = tmp_path / "gpt.zip"
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore_model(path)
    ModelSerializer.verify(path)
    assert back.device.type == "cuda"
    x = eye[rng.integers(0, SERVE_V, (4, SERVE_T))]
    assert torch.equal(back.output(x), net.output(x))
    kernels = (flash_attention, flash_attention_dq, flash_attention_dkv)
    launches, losses = [], []
    for n in (net, back):
        for fn in kernels:
            fn.launches = 0
        losses.append(n.fit_batch(batch(5)))
        launches.append([fn.launches for fn in kernels])
    assert launches[0] == launches[1] and min(launches[0]) > 0
    assert torch.equal(losses[0], losses[1])
    assert np.array_equal(back.params_flat(), net.params_flat())
    assert back.opt_state["count"] == net.opt_state["count"]
    for a, b in zip(back._tx.optax_leaves(back.opt_state),
                    net._tx.optax_leaves(net.opt_state)):
        assert torch.equal(a, b)


def test_set_params_flat_keeps_every_tensor_address(card, tmp_path):
    """``set_params_flat`` and ``restore_weights`` write in place on the
    card: every param tensor keeps its ``data_ptr``."""
    net = _serving_net(card)
    ptrs = [t.data_ptr() for t in net._flat_order()]
    flat = np.random.default_rng(2).normal(
        size=net.num_params()).astype(np.float32)
    net.set_params_flat(flat)
    assert [t.data_ptr() for t in net._flat_order()] == ptrs
    assert np.array_equal(net.params_flat(), flat)
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(_serving_net(card), path)
    ModelSerializer.restore_weights(path, net)
    assert [t.data_ptr() for t in net._flat_order()] == ptrs
    assert np.array_equal(net.params_flat(),
                          _serving_net(card).params_flat())


# ------------------------------------------ single-card training features

def _prefetch_batches(n=3, B=4, T=16, V=16, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        tok = rng.integers(0, V, (B, T + 1))
        out.append(DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]],
                           np.ones((B, T), np.float32), None))
    return out


def test_prefetch_stream_stages_batches_on_the_card(card):
    """``DevicePrefetchIterator`` copies from pinned memory on its own
    stream from the producer thread: each batch arrives on the card equal
    to its host arrays (floats cast to bf16 on the host first, masks
    not), the consumer's stream waits on the copy, and a step on it
    trains bitwise as the pageable batch."""
    from deeplearning4j_tpu_torch.datasets import (
        DevicePrefetchIterator, ListDataSetIterator,
    )
    batches = _prefetch_batches()
    it = DevicePrefetchIterator(ListDataSetIterator(batches),
                                dtype="bfloat16")
    got = []
    while it.has_next():
        ds = it.next()
        # read at once on the consumer's stream: the copy must be there
        got.append((ds.features.float().cpu(), ds.labels.dtype,
                    ds.features_mask.dtype, ds.features.device.type))
    it.close()
    for (feats, ldt, mdt, dev), ref in zip(got, batches):
        assert dev == "cuda" and ldt == torch.bfloat16
        assert mdt == torch.float32
        assert torch.equal(feats, torch.from_numpy(ref.features))
    a = ComputationGraph(gpt_tiny(vocab_size=16, seq_len=16),
                         device=card).init()
    b = ComputationGraph(gpt_tiny(vocab_size=16, seq_len=16),
                         device=card).init()
    plain = [DataSet(x.features, x.labels) for x in batches]
    a.fit(ListDataSetIterator(plain), use_async=False)
    b.fit(DevicePrefetchIterator(ListDataSetIterator(plain)))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_bf16_training_launches_bf16_kernels(card):
    """Under ``precision("bf16")`` the GPT's step launches K4, K5 and K6
    once per layer each (K4 twice under remat) and the char-RNN's tBPTT
    step K2 and K3 once per layer and window (K2 twice under remat), on
    bf16 inputs; the gradients are f32 and within bf16 tolerances of the
    same net on the CPU."""
    ds = _prefetch_batches(1)[0]
    ds = DataSet(ds.features, ds.labels)
    for remat in (False, True):
        conf = gpt_tiny(vocab_size=16, seq_len=16, precision="bf16")
        conf.training.remat = remat
        net = ComputationGraph(conf, device=card).init()
        before = (flash_attention.launches, flash_attention_dq.launches,
                  flash_attention_dkv.launches)
        grads, loss, _ = net.compute_gradient_and_score(ds)
        torch.cuda.synchronize()
        L = 2
        assert (flash_attention.launches - before[0],
                flash_attention_dq.launches - before[1],
                flash_attention_dkv.launches - before[2]) == (
            (2 if remat else 1) * L, L, L)
        cpu = ComputationGraph(conf, device="cpu").init()
        cgrads, closs, _ = cpu.compute_gradient_and_score(ds)
        assert abs(float(loss) - float(closs)) <= 1.6e-2 * abs(float(closs))
        for node, p in cgrads.items():
            for k, want in p.items():
                got = grads[node][k]
                assert got.dtype == torch.float32
                err = float((got.cpu() - want).abs().max())
                assert err <= 3.2e-2 * max(float(want.abs().max()), 1e-30)
    rng = np.random.default_rng(1)
    eye = np.eye(12, dtype=np.float32)
    tok = rng.integers(0, 12, (4, 13))
    cds = DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]])
    for remat in (False, True):
        conf = char_rnn_lstm(12, hidden=16, layers=2, tbptt_length=4)
        conf.training.precision = "bf16"
        conf.training.remat = remat
        net = MultiLayerNetwork(conf, device=card).init()
        before = (lstm_fwd_train.launches, lstm_bwd.launches)
        net.fit_batch(cds)
        torch.cuda.synchronize()
        assert (lstm_fwd_train.launches - before[0],
                lstm_bwd.launches - before[1]) == (
            (2 if remat else 1) * 6, 6)
        assert all(p.dtype == torch.float32
                   for p in tree_leaves(net.params))


def test_guarded_step_runs_without_a_host_sync(card):
    """Clean steps of a sentinel-guarded bf16 char-RNN on batches already
    on the card make no synchronizing call (``set_sync_debug_mode``
    "error"); a NaN window is then skipped with the params, moments and
    count bitwise unchanged."""
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        DivergenceSentinel,
    )
    conf = char_rnn_lstm(12, hidden=16, layers=2, tbptt_length=4)
    conf.training.precision = "bf16"
    net = MultiLayerNetwork(conf, device=card).init()
    sentinel = DivergenceSentinel("skip_batch", lag=1)
    net.set_divergence_sentinel(sentinel)
    rng = np.random.default_rng(2)
    eye = torch.eye(12, device=card)
    staged = []
    for _ in range(3):
        tok = torch.as_tensor(rng.integers(0, 12, (4, 13)), device=card)
        staged.append(DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]]))
    net.fit_batch(staged[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ds in staged[1:]:
            net.fit_batch(ds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sentinel.flush()
    assert sentinel.skipped_batches == 0
    def written():
        return (tree_leaves(net.params)
                + [t for k, v in net.opt_state.items() if k != "count"
                   for t in tree_leaves(v)] + [net.opt_state["count"]])

    before = [t.clone() for t in written()]
    bad = staged[0].features.clone()
    bad[1, 2, 3] = float("nan")
    net.fit_batch(DataSet(bad[:, :4], staged[0].labels[:, :4]))
    sentinel.flush()
    assert sentinel.skipped_batches == 1
    assert all(torch.equal(a, b) for a, b in zip(before, written()))


def test_parallel_trainers_at_world_1_over_nccl(card, tmp_path):
    """A world-1 NCCL group on the card (``multihost.initialize`` with
    ``device=None``): ``ParallelTrainer`` on ``gpt_tiny`` and on a tBPTT
    char-RNN equals each net's own ``fit_batch`` bit for bit, as does
    ``DelayedSyncTrainer(sync_frequency=1)``; ``ParallelWrapper``'s
    replicas average to one net; the group is gone after ``shutdown``."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import (
        DelayedSyncTrainer, MeshContext, ParallelTrainer, ParallelWrapper,
        multihost,
    )
    rng = np.random.default_rng(5)
    eye = np.eye(16, dtype=np.float32)
    tok = rng.integers(0, 16, (4, 17))
    ds = DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]])
    assert multihost.initialize(f"file://{tmp_path}/rdv", 1, 0) == "nccl"
    try:
        mesh = MeshContext.create()
        assert mesh.distributed and mesh.device.type == "cuda"
        for build in (lambda: ComputationGraph(gpt_tiny(16, 16),
                                               device=card).init(),
                      lambda: MultiLayerNetwork(char_rnn_lstm(
                          16, hidden=16, layers=2, tbptt_length=5),
                          device=card).init()):
            plain, par, dly = build(), build(), build()
            tp = ParallelTrainer(par, mesh)
            td = DelayedSyncTrainer(dly, mesh, sync_frequency=1)
            for _ in range(2):
                want = float(plain.fit_batch(ds))
                assert float(tp.fit_batch(ds)) == want
                td.fit_batch(ds)
            ref = plain.params_flat().tobytes()
            assert par.params_flat().tobytes() == ref
            if isinstance(dly, ComputationGraph):
                assert dly.params_flat().tobytes() == ref
        net = MultiLayerNetwork(char_rnn_lstm(16, hidden=16, layers=2,
                                              tbptt_length=5),
                                device=card).init()
        pw = ParallelWrapper(net, workers=2, mesh=mesh)
        pw.fit_batch(ds)
        assert pw.replica(0).params_flat().tobytes() == \
            pw.replica(1).params_flat().tobytes() == \
            net.params_flat().tobytes()
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


# --------------------------------------------------------------- imports
# (no card needed: this runs wherever the file does)

def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port, the CNN slice's, the serving engine's
    and the checkpoint's among them, and chip_smoke.py import neither JAX
    nor the JAX package."""
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("nn/layers/convolution.py", "nn/layers/pooling.py",
                   "nn/layers/normalization.py", "nn/layers/core.py",
                   "nn/layers/shape.py", "nn/conf/preprocessors.py",
                   "nn/conf/graph.py", "nn/conf/graph_builder.py",
                   "nn/netcommon.py", "convert.py", "eval/evaluation.py",
                   "datasets/mnist.py", "models/lenet.py", "models/vgg.py",
                   "models/resnet.py", "util/math_utils.py",
                   "profiling/metrics.py", "profiling/tracer.py",
                   "profiling/flightrec.py", "profiling/watchdog.py",
                   "resilience/service.py", "resilience/faultinject.py",
                   "resilience/sentinel.py", "analysis/memory.py",
                   "keras/batching.py", "keras/generation.py",
                   "resilience/atomic.py", "util/serializer.py",
                   "keras/server.py", "datasets/iris.py",
                   "datasets/iterator.py", "eval/roc.py",
                   "eval/regression.py", "optimize/listeners.py",
                   "optimize/training_stats.py", "optimize/solvers.py",
                   "keras/fleet.py", "keras/autoscale.py",
                   "resilience/elastic.py", "parallel/mesh.py",
                   "parallel/multihost.py", "parallel/trainer.py",
                   "parallel/wrapper.py", "parallel/delayed.py",
                   "parallel/strategy.py", "parallel/checkpoint.py",
                   "parallel/pipeline.py", "parallel/expert.py",
                   "analysis/graphcheck.py", "analysis/findings.py",
                   "resilience/manager.py", "resilience/trainer.py", "keras/hdf5.py",
                   "keras/keras_import.py", "nn/transferlearning.py",
                   "earlystopping/trainer.py",
                   "earlystopping/parallel_trainer.py",
                   "gradientcheck/check.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names, module
    # h5py too: the port reads HDF5 itself (keras/hdf5.py)
    banned = ("jax", "jaxlib", "deeplearning4j_tpu", "h5py")
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in banned]
    assert not bad, bad
