"""The port's serving engine against the JAX package's, on the CPU:
``gpt_tiny(vocab_size=13, seq_len=16)`` built by both packages, the JAX
net's weights carried into the port with ``convert.params_from_jax``,
and the same numpy inputs from a seed on both sides:

- ``gather_kv_pages`` / ``scatter_kv_token`` bitwise against the JAX
  functions;
- one ``paged_decode_fn`` step's probabilities (atol 1e-5, the repo's
  decode-step tolerance) and pool (atol 1e-6: the one scattered token
  per row, a K/V projection of O(1) values) against JAX's
  ``paged_decode_fn`` on the same pool, table and positions;
- ``sample_token`` bitwise against the JAX one;
- ``greedy_generate`` / ``sample_generate`` tokens against the JAX ones
  for 6 prompts;
- the port engine's tokens for those prompts against JAX's
  ``GenerationScheduler``, greedy and sampled.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.keras import generation as jgen
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import attention as jattn
from deeplearning4j_tpu.resilience.service import Deadline as JDeadline

from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.keras import generation as tgen
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import attention as tattn
from deeplearning4j_tpu_torch.resilience.service import Deadline

VOCAB, SEQ_LEN, MAX_NEW = 13, 16, 6
ATOL_PROBS, ATOL_POOL = 1e-5, 1e-6
TEMP, SEEDS = 0.8, (5, 11, 23, 2, 7, 40)


@pytest.fixture(scope="module")
def nets():
    jnet = JGraph(jgpt.gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN)).init()
    conf = tgpt.gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN)
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)))
    return jnet, tnet


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, VOCAB, k).tolist()
            for k in (3, 7, 2, 5, 4, 6)]


def _pool_case(seed, n_pages=9, H=2, pl=4, D=8, rows=3, ppr=4):
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((n_pages, H, pl, D)).astype(np.float32)
    table = rng.integers(0, n_pages, (rows, ppr)).astype(np.int32)
    return rng, pages, table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_kv_pages_bitwise(seed):
    _, pages, table = _pool_case(seed)
    ref = np.asarray(jattn.gather_kv_pages(pages, table))
    got = tattn.gather_kv_pages(torch.from_numpy(pages),
                                torch.from_numpy(table).long()).numpy()
    assert got.shape == ref.shape == (3, 2, 16, 8)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_kv_token_bitwise(seed):
    rng, pages, _ = _pool_case(seed)
    # exclusive write pages per row, as the engine guarantees
    table = rng.permutation(np.arange(1, 9))[:6].reshape(3, 2) \
        .astype(np.int32)
    table = np.concatenate([table, np.zeros((3, 2), np.int32)], axis=1)
    positions = rng.integers(0, 8, 3).astype(np.int32)
    new_kv = rng.standard_normal((3, 2, 8)).astype(np.float32)
    ref = np.asarray(jattn.scatter_kv_token(jnp.asarray(pages), new_kv,
                                            table, positions))
    pool = torch.from_numpy(pages.copy())
    out = tattn.scatter_kv_token(pool, torch.from_numpy(new_kv),
                                 torch.from_numpy(table).long(),
                                 torch.from_numpy(positions).long())
    assert out is pool                      # in place
    assert np.array_equal(pool.numpy(), ref)


def test_paged_decode_step_matches_jax(nets):
    """One paged step over a pool of random (finite) pages: each row's
    chain maps distinct pages, positions land mid-page and on a page's
    first slot, and an unmapped row aliases scratch page 0."""
    jnet, tnet = nets
    pl = tnet.kv_page_len()
    assert pl == jnet.kv_page_len() == 4
    ppr, rows = SEQ_LEN // pl, 4
    n_pages = 3 * ppr + 1
    rng = np.random.default_rng(9)
    jpool = jnet.init_kv_page_pool(n_pages, pl)
    pool_np = {n: {k: rng.standard_normal(np.asarray(v).shape)
                   .astype(np.float32) for k, v in kv.items()}
               for n, kv in jpool.items()}
    chains = rng.permutation(np.arange(1, n_pages))[:3 * ppr]
    table = np.zeros((rows, ppr), np.int32)
    table[:3] = chains.reshape(3, ppr)     # row 3 unmapped: page 0
    positions = np.asarray([5, 8, 15, 0], np.int32)
    x = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, rows)][
        :, None, :]
    jprobs, jnew = jnet.paged_decode_fn(pl)(
        jnet.params, jnet.states,
        jax.tree.map(jnp.asarray, pool_np), x, positions, table)
    tpool = {n: {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
             for n, kv in pool_np.items()}
    tprobs, tnew = tnet.paged_decode_fn(pl)(
        tnet.params, tnet.states, tpool, torch.from_numpy(x),
        torch.from_numpy(positions).long(), torch.from_numpy(table).long())
    assert tnew is tpool
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               atol=ATOL_PROBS)
    for n in pool_np:
        for k in ("k", "v"):
            np.testing.assert_allclose(tpool[n][k].numpy(),
                                       np.asarray(jnew[n][k]),
                                       atol=ATOL_POOL, err_msg=f"{n}.{k}")


def test_sample_token_bitwise():
    rng = np.random.default_rng(3)
    for case in range(200):
        probs = rng.dirichlet(np.full(VOCAB, 0.5)).astype(np.float32)
        temp = float(rng.choice([0.0, 0.3, 0.8, 1.0, 2.5]))
        seed, idx = int(rng.integers(0, 1000)), int(rng.integers(0, 50))
        assert tgen.sample_token(probs, temp, seed, idx) == \
            jgen.sample_token(probs, temp, seed, idx), case


def test_singleton_generation_matches_jax(nets, prompts):
    jnet, tnet = nets
    for i, p in enumerate(prompts):
        assert tgpt.greedy_generate(tnet, p, MAX_NEW) == \
            jgpt.greedy_generate(jnet, p, MAX_NEW), p
        assert tgpt.sample_generate(tnet, p, MAX_NEW, TEMP, SEEDS[i]) == \
            jgpt.sample_generate(jnet, p, MAX_NEW, TEMP, SEEDS[i]), p


def _engine_tokens(sched, net, prompts, deadline):
    """Every prompt twice at once: greedy, and sampled with its seed."""
    out, lock = {}, threading.Lock()

    def one(i, sampled):
        r = sched.submit("m", net, threading.Lock(), prompts[i], MAX_NEW,
                         deadline(),
                         sampling=({"temperature": TEMP, "seed": SEEDS[i]}
                                   if sampled else None))
        with lock:
            out[(i, sampled)] = r["tokens"]

    threads = [threading.Thread(target=one, args=(i, s), daemon=True)
               for i in range(len(prompts)) for s in (False, True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    return out


def test_engine_tokens_match_jax_engine(nets, prompts):
    jnet, tnet = nets
    jsched = jgen.GenerationScheduler(max_rows=4)
    tsched = tgen.GenerationScheduler(max_rows=4)
    try:
        ref = _engine_tokens(jsched, jnet, prompts,
                             lambda: JDeadline(120))
        got = _engine_tokens(tsched, tnet, prompts, lambda: Deadline(120))
    finally:
        jsched.stop()
        tsched.stop()
    assert len(got) == len(ref) == 2 * len(prompts)
    assert got == ref
