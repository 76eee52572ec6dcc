"""The GPT serving slice of the port against the JAX package, end to end:
``gpt_tiny`` built by both packages, the JAX net's weights carried into
the port with ``convert.params_from_jax``, then

- ``ComputationGraph.output`` with and without a key mask (the JAX net's
  attention through its Pallas kernel in interpret mode), atol 1e-5;
- ``greedy_generate`` token equality on three prompts, and the prefill /
  decode step probabilities at atol 1e-5;

plus the port's own contracts: it imports nothing of JAX or of the JAX
package, ``device=None`` refuses to fall back to the CPU, and chip_smoke.py
fails without a card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
V, T = 16, 16


def _nets(**kw):
    jnet = JGraph(jgpt.gpt_tiny(vocab_size=V, seq_len=T, **kw)).init()
    np_params = jax.tree.map(np.asarray, jnet.params)
    conf = tgpt.gpt_tiny(vocab_size=V, seq_len=T, **kw)
    tnet = ComputationGraph(conf, device="cpu").init(
        params_from_jax(conf, np_params))
    return jnet, tnet


def _batch(seed=0, B=4):
    tok = np.random.default_rng(seed).integers(0, V, (B, T))
    return np.eye(V, dtype=np.float32)[tok]


@pytest.mark.parametrize("masked", [False, True])
def test_output_matches_jax(monkeypatch, masked):
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, tnet = _nets()
    x = _batch()
    mask = None
    if masked:
        mask = np.ones((4, T), np.float32)
        mask[1, 11:] = 0.0
        mask[2, 2:] = 0.0
        mask[3] = 0.0                     # no valid key: all-zero row
    ref = np.asarray(jnet.output(x, mask=mask))
    got = tnet.output(x, mask=mask).numpy()
    assert got.shape == (4, T, V)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if masked:
        assert np.all(got[3] == 0.0) and np.all(got[1, 11:] == 0.0)
    else:
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_output_matches_jax_untied_head_two_inputs_list(monkeypatch):
    """The untied RnnOutputLayer head, inputs passed as a list."""
    monkeypatch.setenv("DL4J_TPU_PALLAS", "interpret")
    jnet, tnet = _nets(tie_weights=False, n_layers=1)
    x = _batch(1, B=2)
    np.testing.assert_allclose(tnet.output([x]).numpy(),
                               np.asarray(jnet.output([x])), atol=ATOL)


@pytest.mark.parametrize("prompt", [[3], [1, 2, 3, 4, 5], list(range(11))],
                         ids=["len1", "len5", "len11"])
def test_greedy_generate_tokens_equal_jax(prompt):
    jnet, tnet = _nets(seed=7)
    ref = jgpt.greedy_generate(jnet, prompt, 8)
    got = tgpt.greedy_generate(tnet, prompt, 8)
    assert got == ref
    assert len(got) == min(8, T - len(prompt))


def test_prefill_and_decode_probabilities_match_jax():
    jnet, tnet = _nets(seed=3)
    jpre, jdec = jnet.decode_fns()
    tpre, tdec = tnet.decode_fns()
    lengths = np.array([5, 8, 2], np.int32)
    tok = np.random.default_rng(4).integers(0, V, (3, 8))
    x = np.eye(V, dtype=np.float32)[tok]
    jc, tc = jnet.init_decode_cache(3), tnet.init_decode_cache(3)
    ref, jc = jpre(jnet.params, jnet.states, jc, x, lengths)
    got, tc = tpre(tnet.params, tnet.states, tc, torch.from_numpy(x),
                   torch.from_numpy(lengths).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    pos = lengths.copy()
    for step in range(4):
        xt = np.eye(V, dtype=np.float32)[(tok[:, 0] + step) % V][:, None]
        ref, jc = jdec(jnet.params, jnet.states, jc, xt, pos)
        got, tc = tdec(tnet.params, tnet.states, tc, torch.from_numpy(xt),
                       torch.from_numpy(pos).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        pos = pos + 1


def test_port_init_shapes_match_jax_params():
    """The port's own seeded init draws every param the JAX init draws,
    with the same names and shapes (so carried weights line up)."""
    jnet = JGraph(jgpt.gpt_tiny(vocab_size=V, seq_len=T)).init()
    tnet = ComputationGraph(tgpt.gpt_tiny(vocab_size=V, seq_len=T),
                            device="cpu").init()
    assert set(tnet.params) == set(jnet.params)
    for node, p in jnet.params.items():
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: tuple(v.shape) for k, v in tnet.params[node].items()}
    assert tnet.num_params() == jnet.num_params()
    again = ComputationGraph(tgpt.gpt_tiny(vocab_size=V, seq_len=T),
                             device="cpu").init()
    assert all(torch.equal(again.params[n][k], t)
               for n, p in tnet.params.items() for k, t in p.items())


def test_tied_head_reads_the_embedding_tensor_itself():
    _, tnet = _nets()
    p = tnet._layer_params(tnet.params, "head")
    assert p["W_tok"] is tnet.params["embed"]["W"]


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = tgpt.gpt_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(conf)
    assert ComputationGraph(conf, device="cpu").device.type == "cpu"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("ops/flash_attention.py", "ops/losses.py",
                   "nn/updater.py", "nn/graph.py", "datasets/dataset.py",
                   "datasets/iterator.py", "convert.py",
                   "nn/conf/builder.py", "nn/conf/graph_builder.py",
                   "resilience/atomic.py", "util/serializer.py",
                   "resilience/service.py", "resilience/faultinject.py",
                   "profiling/watchdog.py", "keras/batching.py",
                   "keras/server.py", "datasets/iris.py",
                   "keras/fleet.py", "keras/autoscale.py",
                   "resilience/elastic.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/multihost.py",
                   "parallel/trainer.py", "parallel/wrapper.py",
                   "parallel/delayed.py", "parallel/strategy.py",
                   "parallel/checkpoint.py", "resilience/manager.py",
                   "resilience/trainer.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names, module
    banned = ("jax", "jaxlib", "deeplearning4j_tpu")
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in banned]
    assert not bad, bad


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """No card (this CPU box), or no port beside the script: a non-zero
    exit and no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
