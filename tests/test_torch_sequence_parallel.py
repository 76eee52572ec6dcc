"""The port's sequence parallelism (an ``sp`` mesh axis, ROADMAP A6.2a):
``parallel/sequence.py``'s ring attention and ``ParallelTrainer`` on a
mesh with an sp axis, against the JAX package on the CPU.

The cases of ``tests/test_attention_sequence.py``, ported: the port's
side runs in one group of four gloo processes for the module
(``torch_parallel_worker.run_group(..., world=4)``), its meshes ``1 x 1
x 4`` and ``2 x 1 x 2`` over the four ranks (``1 x 1 x 2`` over each
half); the JAX side runs here on one device. Held:

- the ring against single-device attention, causal and not (2e-4), with
  a padding mask, causal and not (2e-5), its weight gradients finite and
  the JAX single-device gradients' (summed over the ranks);
- the container's training step (attention + per-timestep head, SGD)
  under the sp mesh against the JAX single-device ``fit_batch``, causal
  and not and masked: loss 2e-5, ``Wq`` / ``Wo`` 1e-5;
- the opt-out flag and the routing seam (``_ring_context``), a T that
  does not divide the axis staying whole (and training to the same
  gates, the sp ranks then replicas);
- ``gpt_tiny`` at ``2 x 1 x 2`` and ``1 x 1 x 4`` (positions at each
  shard's offset) against the port's own plain ``fit_batch``, and its
  ``2 x 1 x 2`` zero2 run against the same (the JAX composed dp x sp x
  zero2 case fails in the reference, ROADMAP C1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.layers.attention import (
    SelfAttentionLayer as JAttention, attention_reference,
)

RNG = np.random.default_rng(7)
SP_LAYOUTS = {"1x1x4": (1, 1, 4), "2x1x2": (2, 1, 2)}
GPT_KW = dict(vocab_size=16, seq_len=16)
P_RTOL, P_ATOL = 2e-4, 2e-5


def _ring_inputs(B=2, H=2, T=64, D=8, F=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    arrays = dict(x=rng.normal(size=(B, T, F)).astype(np.float32), H=H, D=D)
    for k, shape in (("Wq", (F, H * D)), ("Wk", (F, H * D)),
                     ("Wv", (F, H * D)), ("Wo", (H * D, F))):
        arrays[k] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    if masked:
        lengths = rng.integers(5, T + 1, B)
        arrays["mask"] = (np.arange(T)[None] < lengths[:, None]).astype(
            np.float32)
    return arrays


RING = {
    "plain": (_ring_inputs(), 8, False),
    "masked": (_ring_inputs(B=4, T=16, F=8, seed=8, masked=True), 4, True),
}


def _jax_attention(a, causal, masked):
    """Single-device self attention of ``a`` and its weight gradients of
    sum(out**2), in JAX."""
    B, T, F = a["x"].shape
    H, D = a["H"], a["D"]
    x = jnp.asarray(a["x"])
    mask = jnp.asarray(a["mask"]) if masked else None

    def fwd(p):
        def split(h):
            return h.reshape(B, T, H, D).transpose(0, 2, 1, 3)
        out = attention_reference(split(x @ p["Wq"]), split(x @ p["Wk"]),
                                  split(x @ p["Wv"]), causal=causal,
                                  mask=mask)
        out = out.transpose(0, 2, 1, 3).reshape(B, T, H * D) @ p["Wo"]
        if mask is not None:
            out = out * mask[..., None]
        return out

    p = {k: jnp.asarray(a[k]) for k in ("Wq", "Wk", "Wv", "Wo")}
    grads = jax.grad(lambda q: jnp.sum(fwd(q) ** 2))(p)
    return np.asarray(fwd(p)), {k: np.asarray(v) for k, v in grads.items()}


def jax_attn_net(causal=False, T=16):
    """``torch_parallel_worker.attn_conf``'s container."""
    return JNet(JNNC.builder().seed(5).updater("sgd", learning_rate=0.05)
                .weight_init("xavier").list()
                .layer(JAttention(n_heads=2, causal=causal, block_size=4))
                .layer(JRnnOutput(n_out=5, activation="softmax",
                                  loss="mcxent"))
                .set_input_type(JInputType.recurrent(8, T)).build()).init()


def _container_batch(T=16, seed=21, masked=False):
    rng = np.random.default_rng(seed)
    B, F, K = 4, 8, 5
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, T))]
    if not masked:
        return [x, y]
    lengths = rng.integers(6, T + 1, B)
    m = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return [x, y, m, m]


#: the container cases: causal, T, masked
CONTAINER = {"plain": (False, 16, False), "causal": (True, 16, False),
             "masked": (False, 16, True), "masked_causal": (True, 16, True),
             "t15": (False, 15, False)}


def _cases():
    cases = []
    for name, (arrays, bs, masked) in RING.items():
        for causal in (False, True):
            for label, layout in SP_LAYOUTS.items():
                cases.append(dict(
                    name=f"ring/{name}/{causal}/{label}", fn="ring",
                    args=dict(arrays=arrays, layout=layout, causal=causal,
                              block_size=bs, masked=masked)))
    for name, (causal, T, masked) in CONTAINER.items():
        params = jax.tree.map(np.asarray,
                              jax_attn_net(causal, T).params)
        batch = _container_batch(T, masked=masked)
        for label, layout in SP_LAYOUTS.items():
            cases.append(dict(
                name=f"container/{name}/{label}", fn="mesh_train",
                args=dict(kind="attn", net_kw=dict(causal=causal, T=T),
                          params=params, batches=[batch], layout=layout)))
    gpt_batches = [[np.eye(16, dtype=np.float32)[t[:, :-1]],
                    np.eye(16, dtype=np.float32)[t[:, 1:]]]
                   for t in [RNG.integers(0, 16, (4, 17))]]
    for label, layout, mode in (("plain", (1, 1, 1), "off"),
                                ("2x1x2", (2, 1, 2), "off"),
                                ("1x1x4", (1, 1, 4), "off"),
                                ("2x1x2_zero2", (2, 1, 2), "zero2")):
        cases.append(dict(name=f"gpt/{label}", fn="mesh_train", args=dict(
            kind="gpt", net_kw=GPT_KW, params=None, batches=gpt_batches,
            layout=layout, steps=3, mode=mode)))
    tbptt = [[np.eye(12, dtype=np.float32)[t[:, :-1]],
              np.eye(12, dtype=np.float32)[t[:, 1:]]]
             for t in [RNG.integers(0, 12, (4, 13))]]
    for label, layout in (("plain", (1, 1, 1)), ("1x1x2", (1, 1, 2)),
                          ("2x1x2", (2, 1, 2))):
        cases.append(dict(name=f"tbptt/{label}", fn="mesh_train", args=dict(
            kind="char_rnn", net_kw=dict(vocab_size=12, hidden=16, layers=1,
                                         tbptt_length=5),
            params=None, batches=tbptt, layout=layout, steps=2)))
    for label, layout in (("plain", (1, 1, 1)), ("2x1x2", (2, 1, 2))):
        cases.append(dict(name=f"accum2/{label}", fn="mesh_train",
                          args=dict(kind="gpt", net_kw=GPT_KW, params=None,
                                    batches=gpt_batches, layout=layout,
                                    steps=2, accum=2)))
    cases.append(dict(name="routing", fn="scope_routing"))
    return cases


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return W.run_group(_cases(), tmp_path_factory.mktemp("sequence"),
                       world=4)


def _assemble(group, name, T):
    """The ranks' output shards put back into the whole [B, T, F]."""
    parts = {}
    for rank in range(4):
        got = W.result(group, name, rank)
        parts[(tuple(got["rows"]), tuple(got["steps"]))] = got["out"]
    B = max(r[1] for r, _ in parts)
    F = next(iter(parts.values())).shape[-1]
    out = np.full((B, T, F), np.nan, np.float32)
    for (rows, steps), v in parts.items():
        out[rows[0]:rows[1], steps[0]:steps[1]] = v
    return out


@pytest.mark.parametrize("layout", sorted(SP_LAYOUTS))
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_single_device(group, causal, layout):
    arrays = RING["plain"][0]
    want, _ = _jax_attention(arrays, causal, False)
    got = _assemble(group, f"ring/plain/{causal}/{layout}",
                    arrays["x"].shape[1])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout", sorted(SP_LAYOUTS))
@pytest.mark.parametrize("causal", [False, True])
def test_masked_ring_attention_matches_local(group, causal, layout):
    """The padding mask's key shard rides the ring with its K/V (the
    causal diagonal sees the rotated mask too); the output is zeroed at
    masked queries, as the local layer path."""
    arrays = RING["masked"][0]
    want, _ = _jax_attention(arrays, causal, True)
    got = _assemble(group, f"ring/masked/{causal}/{layout}",
                    arrays["x"].shape[1])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_attention_gradients_flow(group, name):
    """The backward through the ring's shifts: the weights' gradients,
    summed over the ranks, finite and the single-device ones."""
    arrays, _, masked = RING[name]
    _, want = _jax_attention(arrays, True, masked)
    got = W.result(group, f"ring/{name}/True/1x1x4")["grads"]
    for k, g in got.items():
        assert np.all(np.isfinite(g)), k
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("layout", sorted(SP_LAYOUTS))
@pytest.mark.parametrize("name", sorted(CONTAINER))
def test_container_sequence_parallel_loss_parity(group, name, layout):
    """The attention container trained under the sp mesh matches the
    unsharded single-device step: the loss, and the updated ``Wq`` /
    ``Wo``. ``t15``: T = 15 does not divide the axis, so the batch stays
    whole and the sp ranks train as replicas."""
    causal, T, masked = CONTAINER[name]
    jnet = jax_attn_net(causal, T)
    want = float(jnet.fit_batch(JDataSet(*_container_batch(T,
                                                           masked=masked))))
    got = W.result(group, f"container/{name}/{layout}")
    assert abs(got["losses"][0] - want) < 2e-5, (got["losses"], want)
    for k in ("Wq", "Wo"):
        np.testing.assert_allclose(got["leaves"][f"0/{k}"],
                                   np.asarray(jnet.params[0][k]),
                                   atol=1e-5, err_msg=k)


def test_sequence_parallel_opt_out_flag_and_scope(group):
    """``sequence_parallel=False`` pins local attention even inside a
    scope; a step whose batch is not split on T, or no scope at all,
    keeps the local path."""
    got = W.result(group, "routing")
    assert got["opt_out"] is None
    assert got["ring"] and got["masked_ring"]
    assert got["not_split"] is None and got["exited"] is None


def test_shard_batch_nondivisible_T_stays_whole(group):
    """A [B, 15, F] batch on an sp=4 mesh is split on rows only; a
    [B, 16, F] one on T too, each rank its 4 steps."""
    for rank in range(4):
        got = W.result(group, "routing", rank)
        assert got["spec15"] == ("data", None, None)
        assert got["spec16"] == ("data", "sp", None)
        assert got["shape15"] == (4, 15, 8)
        a16 = np.arange(4 * 16 * 8, dtype=np.float32).reshape(4, 16, 8)
        np.testing.assert_array_equal(got["piece16"],
                                      a16[:, 4 * rank:4 * rank + 4])


@pytest.mark.parametrize("label", ["2x1x2", "1x1x4", "2x1x2_zero2"])
def test_gpt_on_an_sp_mesh_matches_the_plain_step(group, label):
    """gpt_tiny, 3 steps: each rank's positional embedding adds its
    shard's positions, attention runs as a ring, the LayerNorms and MLP
    on its tokens; losses and params against the port's own plain
    ``fit_batch`` (the ring's blockwise sums run in another order than
    the flash path's)."""
    ref = W.result(group, "gpt/plain")
    for rank in range(4):
        got = W.result(group, f"gpt/{label}", rank)
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["params"], ref["params"],
                                   rtol=P_RTOL, atol=P_ATOL)
        assert got["params"].tobytes() == W.result(
            group, f"gpt/{label}")["params"].tobytes()


@pytest.mark.parametrize("name,label", [("tbptt", "1x1x2"),
                                        ("tbptt", "2x1x2"),
                                        ("accum2", "2x1x2")])
def test_sp_mesh_composes_with_tbptt_and_accumulation(group, name, label):
    """tBPTT on an sp mesh (the windows cut the whole sequence, so the
    batch is not split on T and the sp ranks train as replicas) and
    gradient accumulation (each microbatch split on T): the plain run's
    losses and params."""
    ref = W.result(group, f"{name}/plain")
    got = W.result(group, f"{name}/{label}")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], ref["params"], rtol=P_RTOL,
                               atol=P_ATOL)
