"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips without a card (a
CUDA kernel has no CPU mode). This file imports no JAX, so it runs on the
card's machine, which has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest \
        -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets up JAX.)
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.gpt import gpt_tiny, greedy_generate
from deeplearning4j_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_attention_plain,
)

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
])
def test_flash_kernel_matches_plain(card, B, H, T, D, causal, dtype):
    """Ragged T, every head-dim template (32/64/128), a key mask with a
    hole and a batch row with no valid key (exact zeros, NEG_INF lse)."""
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
