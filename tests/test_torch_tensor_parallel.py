"""The port's tensor parallelism (a ``model`` mesh axis, ROADMAP A6.2a)
against the JAX package's, on the CPU.

The port's side runs in one group of four gloo processes for the module
(``torch_parallel_worker.run_group(..., world=4)``): each mesh is built
over those ranks, a ``1 x 2`` one over each half of them, ``2 x 2`` and
``1 x 4`` over all four. Weights are carried from the JAX nets by
``convert.params_from_jax``; the JAX side runs here on its CPU devices.
``min_shard_size`` is 16 so the small test kernels shard, as in
``tests/test_parallel.py::test_tensor_parallel_sharding_compiles``.
Held:

- the mesh's layout (rank = (d * n_model + m) * n_seq + s, rows by the
  data index) and ``param_spec`` against the JAX package's for every
  leaf of the full-width GPT;
- one step of an MLP, a 2-block ``gpt_tiny`` and a char-RNN LSTM at
  ``1 x 2`` and ``2 x 2`` against the JAX single-device ``fit_batch``:
  losses at 1e-5 relative, params at rtol 2e-4 / atol 2e-5, every rank
  the same params after ``gather_params``; a replicated bias's update;
- the JAX test's MLP at ``1 x 4`` and ``2 x 2``: its score falls over 10
  steps, its hidden kernel sharded ``(None, "model")``;
- ``score`` refused while the shards are attached, ``gather_params``
  between two steps changing nothing, zero1 with ``n_model > 1`` refused
  in the JAX message's words;
- model-sharded checkpoints both ways: a port-written directory read by
  the JAX ``restore_sharded``, a JAX-written one restored into the port
  at world 1 and at ``2 x 2``.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import MeshContext as JMesh
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel.checkpoint import (
    restore_sharded as jrestore_sharded,
)
from deeplearning4j_tpu.resilience.manager import (
    CheckpointManager as JCheckpointManager,
)

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 2e-4, 2e-5
MIN_SHARD = 16
GPT_KW = dict(vocab_size=16, seq_len=16)
RNN_KW = dict(vocab_size=12, hidden=16, layers=1)
#: the JAX test's MLP: 8 -> 64 -> 64 -> 4, SGD at 0.1
WIDE_MLP = dict(seed=3, updater="sgd", lr=0.1, hidden=64, n_in=8, n_out=4)
TP_LAYOUTS = {"1x2": (1, 2, 1), "2x2": (2, 2, 1)}


def jax_mlp(seed=12345, lr=0.05, updater="adam", hidden=16, n_in=4,
            n_out=3, clip=None):
    """``torch_parallel_worker.mlp_conf``'s stack."""
    b = JNNC.builder().seed(seed).updater(updater, learning_rate=lr)
    if clip is not None:
        b = b.gradient_normalization(clip, threshold=0.5)
    return JNet(b.weight_init("xavier").list()
                .layer(JDense(n_out=hidden, activation="relu"))
                .layer(JDense(n_out=hidden, activation="tanh"))
                .layer(JOutput(n_out=n_out, activation="softmax"))
                .set_input_type(JInputType.feed_forward(n_in)).build()
                ).init()


def jax_net(kind, **kw):
    if kind == "mlp":
        return jax_mlp(**kw)
    if kind == "lenet_bn":
        return jax_lenet_bn()
    if kind == "gpt":
        return JGraph(jgpt.gpt_tiny(**kw)).init()
    return JNet(jchar_rnn(**kw)).init()


def numpy_params(jnet):
    return jax.tree.map(np.asarray, jnet.params)


def mlp_batches(n, rows=8, n_in=4, n_out=3, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(rows, n_in)).astype(np.float32),
             np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, rows)]]
            for _ in range(n)]


def seq_batches(n, V, T, rows, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        tok = rng.integers(0, V, (rows, T + 1))
        out.append([eye[tok[:, :-1]], eye[tok[:, 1:]]])
    return out


def jax_lenet_bn():
    """``torch_parallel_worker.lenet_bn_conf``'s stack."""
    from deeplearning4j_tpu.nn.layers import BatchNormalization as JBN
    from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
    from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JSub
    return JNet(JNNC.builder().seed(12345)
                .updater("adam", learning_rate=0.01)
                .weight_init("xavier").list()
                .layer(JConv(n_out=6, kernel_size=(5, 5), activation="relu"))
                .layer(JBN())
                .layer(JSub(pooling_type="max", kernel_size=(2, 2),
                            stride=(2, 2)))
                .layer(JConv(n_out=16, kernel_size=(5, 5),
                             activation="relu"))
                .layer(JSub(pooling_type="max", kernel_size=(2, 2),
                            stride=(2, 2)))
                .layer(JDense(n_out=32, activation="relu"))
                .layer(JOutput(n_out=10, activation="softmax",
                               loss="mcxent"))
                .set_input_type(JInputType.convolutional(16, 16, 1))
                .build()).init()


def image_batches(rows=8, seed=10):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=(rows, 16, 16, 1)) + 0.5).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]]]


#: the parity nets: kind, net kwargs, one batch
PARITY = {
    "mlp": ("mlp", {}, mlp_batches(1)),
    # the per-layer L2 clip: a column shard's squares summed over 'model'
    "mlp_clip": ("mlp", dict(clip="clipl2perlayer"), mlp_batches(1)),
    # batch norm over the data axis' rows; conv kernels gathered on use
    "lenet_bn": ("lenet_bn", {}, image_batches()),
    "gpt": ("gpt", GPT_KW, seq_batches(1, 16, 16, 4, seed=1)),
    "lstm": ("char_rnn", RNN_KW, seq_batches(1, 12, 12, 4, seed=3)),
}
WIDE_BATCHES = mlp_batches(1, rows=16, n_in=8, n_out=4, seed=0)
#: composition with the data-parallel step's features, against the same
#: run at 1 x 1 x 1: a char-RNN over three tBPTT windows (5, 5, 2) and
#: gpt_tiny under gradient accumulation 2
COMPOSE = {
    "tbptt": ("char_rnn", dict(RNN_KW, tbptt_length=5),
              seq_batches(1, 12, 12, 4, seed=8), 1),
    "accum2": ("gpt", GPT_KW, seq_batches(1, 16, 16, 4, seed=2), 2),
    # dropout: the model ranks of a replica draw the same masks (one
    # replica here: the net's own stream, as the plain step)
    "dropout": ("mlp", dict(dropout=0.5), mlp_batches(1, seed=4), 1),
}


def _jax_ckpt(tmp):
    """A directory the JAX trainer writes on a 2 x 2 mesh after one step
    of gpt_tiny (its kernels sharded over 'model'), and the JAX net."""
    jnet = jax_net("gpt", **GPT_KW)
    ctx = JMesh.create(n_data=2, n_model=2, devices=jax.devices()[:4])
    ctx.min_shard_size = MIN_SHARD
    JTrainer(jnet, ctx).fit_batch(JDataSet(*PARITY["gpt"][2][0]))
    mgr = JCheckpointManager(tmp / "jax_ckpt", sharded=True, mesh_ctx=ctx)
    return str(mgr.save(jnet)), jnet


def _cases(tmp, jax_dir):
    cases = []
    for name, (kind, kw, batches) in PARITY.items():
        params = numpy_params(jax_net(kind, **kw))
        for label, layout in TP_LAYOUTS.items():
            cases.append(dict(name=f"{name}/{label}", fn="mesh_train",
                              args=dict(kind=kind, net_kw=kw, params=params,
                                        batches=batches, layout=layout,
                                        min_shard=MIN_SHARD)))
    for label, layout in (("1x4", (1, 4, 1)), ("2x2", (2, 2, 1))):
        cases.append(dict(name=f"wide/{label}", fn="mesh_train", args=dict(
            kind="mlp", net_kw=WIDE_MLP, params=None, batches=WIDE_BATCHES,
            layout=layout, steps=10, min_shard=MIN_SHARD)))
    for name, (kind, kw, batches, accum) in COMPOSE.items():
        for label, layout in (("plain", (1, 1, 1)), ("1x2", (1, 2, 1)),
                              ("2x2", (2, 2, 1))):
            cases.append(dict(name=f"{name}/{label}", fn="mesh_train",
                              args=dict(kind=kind, net_kw=kw, params=None,
                                        batches=batches, layout=layout,
                                        steps=2, accum=accum,
                                        min_shard=MIN_SHARD)))
    cases += [
        dict(name="save", fn="mesh_train", args=dict(
            kind="gpt", net_kw=GPT_KW, params=None,
            batches=PARITY["gpt"][2], layout=(2, 2, 1), min_shard=MIN_SHARD,
            save=str(tmp / "port_ckpt"))),
        dict(name="restore", fn="mesh_restore", args=dict(
            ckpt=jax_dir, kind="gpt", net_kw=GPT_KW, layout=(2, 2, 1),
            batches=PARITY["gpt"][2])),
        dict(name="roundtrip", fn="mesh_roundtrip", args=dict(
            kind="gpt", net_kw=GPT_KW, batches=PARITY["gpt"][2],
            layout=(2, 2, 1))),
        dict(name="refusals", fn="mesh_refusals", args=dict(
            layouts=[(1, 2, 1), (2, 2, 1), (1, 4, 1), (2, 1, 2)])),
    ]
    return cases


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    return _jax_ckpt(tmp_path_factory.mktemp("jax_tp"))


@pytest.fixture(scope="module")
def group(tmp_path_factory, jax_ckpt):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    return W.run_group(_cases(tmp, jax_ckpt[0]), tmp, world=4)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [(1, 2, 1), (2, 2, 1), (1, 4, 1),
                                    (2, 1, 2)])
def test_mesh_layout_is_the_jax_meshes_reshape(group, layout):
    nd, nm, ns = layout
    size = nd * nm * ns
    for rank in range(4):
        got = W.result(group, "refusals", rank)[str(layout)]
        r = rank % size
        assert tuple(got["coords"]) == (r // (nm * ns), (r // ns) % nm,
                                        r % ns)
        d = got["coords"][0]
        assert got["n_data"] == nd
        assert tuple(got["rows"]) == (8 // nd * d, 8 // nd * (d + 1))
        assert got["model_axis"] == ("model" if nm > 1 else None)
        assert got["seq_axis"] == ("sp" if ns > 1 else None)
        assert tuple(got["spec"]) == ((None, "model") if nm > 1 else ())


def test_param_spec_of_the_full_width_gpt_is_the_jax_packages():
    """``param_spec`` for every leaf of gpt_decoder(96, 256, 512, 8, 8) at
    n_model=2, against the JAX MeshContext's; a rank then holds 12.7M of
    its 25.4M params."""
    from deeplearning4j_tpu_torch.models.gpt import gpt_decoder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import MeshContext
    net = ComputationGraph(gpt_decoder(96, 256, 512, 8, 8),
                           device="cpu").init()
    port = MeshContext(world=2, n_model=2)
    jctx = JMesh.create(n_data=1, n_model=2, devices=jax.devices()[:2])
    total = per_rank = 0
    for node, leaves in net.params.items():
        for name, t in leaves.items():
            shape = tuple(t.shape)
            want = tuple(jctx.param_spec(f"{node}/{name}", shape))
            got = port.param_spec(f"{node}/{name}", shape)
            assert got == want, (node, name, got, want)
            total += t.numel()
            per_rank += t.numel() // 2 if got else t.numel()
    assert total == 25_384_448
    assert per_rank == 12_711_424


# ---------------------------------------------------------------------------
# one step against the JAX single-device step
# ---------------------------------------------------------------------------

def _jax_step(kind, kw, batches, steps=1):
    jnet = jax_net(kind, **kw)
    losses = [float(jnet.fit_batch(JDataSet(*b))) for _ in range(steps)
              for b in batches]
    return losses, np.asarray(jnet.params_flat()), jnet


@pytest.mark.parametrize("layout", sorted(TP_LAYOUTS))
@pytest.mark.parametrize("name", sorted(PARITY))
def test_tensor_parallel_step_matches_the_jax_single_device_step(
        group, name, layout):
    kind, kw, batches = PARITY[name]
    want_losses, want_params, _ = _jax_step(kind, kw, batches)
    got = W.result(group, f"{name}/{layout}")
    assert got["sharded"], "no leaf was sharded"
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["params"], want_params, rtol=P_RTOL,
                               atol=P_ATOL)
    for rank in range(1, 4):
        other = W.result(group, f"{name}/{layout}", rank)
        assert other["params"].tobytes() == got["params"].tobytes(), rank


@pytest.mark.parametrize("name,layout", [
    ("tbptt", "1x2"), ("tbptt", "2x2"), ("accum2", "1x2"),
    ("accum2", "2x2"), ("dropout", "1x2")])
def test_tensor_parallel_composes_with_tbptt_and_accumulation(
        group, name, layout):
    """tBPTT (one update a window, the LSTM's sharded W / RW gathered on
    use), gradient accumulation and dropout (one replica: the net's own
    stream) on a model axis: the plain run's losses and params."""
    ref = W.result(group, f"{name}/plain")
    got = W.result(group, f"{name}/{layout}")
    assert got["sharded"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["params"], ref["params"], rtol=P_RTOL,
                               atol=P_ATOL)


def test_model_ranks_of_a_replica_draw_the_same_dropout_masks(group):
    """At 2 x 2 each replica draws from its own stream (its data index),
    and its two model ranks from the same one: their replicated bias
    updates agree bit for bit, the two replicas' masks differ."""
    got = [W.result(group, "dropout/2x2", r) for r in range(4)]
    assert [tuple(g["coords"]) for g in got] == [(0, 0, 0), (0, 1, 0),
                                                 (1, 0, 0), (1, 1, 0)]
    assert got[0]["bias0"].tobytes() == got[1]["bias0"].tobytes()
    assert got[2]["bias0"].tobytes() == got[3]["bias0"].tobytes()
    plain = W.result(group, "dropout/plain")
    assert got[0]["params"].tobytes() != plain["params"].tobytes()


@pytest.mark.parametrize("layout", sorted(TP_LAYOUTS))
def test_replicated_bias_takes_the_whole_update(group, layout):
    """The first dense layer's bias is replicated beside its sharded
    kernel: every model rank applies the whole bias gradient (added after
    the gather), and the update is the JAX step's."""
    _, _, jnet = _jax_step("mlp", {}, PARITY["mlp"][2])
    want = np.asarray(jnet.params[0]["b"])
    got = [W.result(group, f"mlp/{layout}", r)["bias0"] for r in range(4)]
    assert "0/W" in W.result(group, f"mlp/{layout}")["sharded"]
    np.testing.assert_allclose(got[0], want, rtol=P_RTOL, atol=P_ATOL)
    init = np.asarray(jax_net("mlp").params[0]["b"])
    assert np.abs(got[0] - init).max() > 0, "the bias did not move"
    for g in got[1:]:
        assert g.tobytes() == got[0].tobytes()


@pytest.mark.parametrize("layout", ["1x4", "2x2"])
def test_jax_tensor_parallel_mlp_trains_sharded(group, layout):
    """tests/test_parallel.py::test_tensor_parallel_sharding_compiles on
    the port: the 64-wide kernels shard over 'model' and the score falls
    over 10 steps."""
    got = W.result(group, f"wide/{layout}")
    assert got["sharded"] == ["0/W", "1/W", "2/W"]
    # the first step's loss is the score at the initial params
    assert got["score"] < got["losses"][0]
    assert got["losses"][-1] < got["losses"][0]
    spec = W.result(group, "refusals")[str((2, 2, 1))]["spec"]
    assert tuple(spec) == (None, "model")


def test_sharded_leaves_hold_a_ranks_columns(group):
    """At 1 x 4 every 64-wide kernel holds a quarter of its columns (the
    4-wide output kernel too), the moments with them."""
    got = W.result(group, "wide/1x4")
    whole = 4 * (8 * 64 + 64 + 64 * 64 + 64 + 64 * 4 + 4)
    rank = 4 * ((8 * 64 + 64 * 64 + 64 * 4) // 4 + 64 + 64 + 4)
    assert got["whole_bytes"] == whole and got["param_bytes"] == rank


def test_score_is_refused_while_shards_are_attached(group):
    err = W.result(group, "gpt/2x2")["score_refused"]
    assert err[0] == "RuntimeError" and "gather_params()" in err[1], err


def test_gather_params_between_steps_changes_nothing(group):
    got = W.result(group, "roundtrip")
    assert got["gathered"].tobytes() == got["straight"].tobytes()
    for rank in range(1, 4):
        other = W.result(group, "roundtrip", rank)
        assert other["mid"].tobytes() == got["mid"].tobytes()


def test_zero_weight_update_sharding_is_refused_with_a_model_axis(group):
    err = W.result(group, "refusals")["zero1_model"]
    assert err[0] == "ValueError" and \
        "composes with pure data parallelism only" in err[1], err
    err = W.result(group, "refusals")["zero2_model_dp1"]
    assert err[0] == "ValueError" and "nothing to shard" in err[1], err
    err = W.result(group, "refusals")["n_model_3"]
    assert err[0] == "ValueError" and "n_model=3" in err[1], err


# ---------------------------------------------------------------------------
# model-sharded checkpoints across the packages
# ---------------------------------------------------------------------------

def test_port_model_sharded_checkpoint_reads_in_the_jax_package(group):
    got = W.result(group, "save")
    path = got["saved"]
    manifest = json.loads(open(f"{path}/manifest.json").read())
    spec = manifest["leaves"]["params/b0_attn/Wq"]["spec"]
    assert spec == [None, "model"], spec
    tree = jrestore_sharded(path, None)
    for key, want in got["leaves"].items():
        node, name = key.split("/")
        np.testing.assert_array_equal(tree["params"][node][name], want)
    mu = tree["opt_state"]["0"][".mu"]["b0_attn"]["Wq"]
    assert mu.shape == (16, 16) and np.abs(mu).max() > 0


def test_jax_model_sharded_checkpoint_restores_into_the_port(
        group, jax_ckpt):
    path, jnet = jax_ckpt
    manifest = json.loads(open(f"{path}/manifest.json").read())
    assert manifest["leaves"]["params/b0_attn/Wq"]["spec"] == [None,
                                                                "model"]
    # world 1, in this process
    from deeplearning4j_tpu_torch.resilience.manager import (
        CheckpointManager,
    )
    net = W.build("gpt", seed=777, **GPT_KW)
    from pathlib import Path
    mgr = CheckpointManager(Path(path).parent, sharded=True)
    cursor = mgr.restore(net)
    assert cursor.step == 1
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    # 2 x 2 over the ranks: each restores its column shards, then steps
    got = W.result(group, "restore")
    want_losses, want_params, _ = _jax_continue(jnet)
    np.testing.assert_allclose(got["loss"], want_losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["params"], want_params, rtol=P_RTOL,
                               atol=P_ATOL)


def _jax_continue(jnet):
    """One more single-device step of the JAX net the checkpoint holds."""
    losses = [float(jnet.fit_batch(JDataSet(*PARITY["gpt"][2][0])))]
    return losses, np.asarray(jnet.params_flat()), jnet


def test_model_columns_are_contiguous_blocks_in_index_order():
    """``model_columns`` cuts the last axis into contiguous column blocks
    in model-index order (the JAX NamedSharding's layout)."""
    from deeplearning4j_tpu_torch.parallel import MeshContext
    t = torch.arange(24.0).reshape(2, 12)
    parts = [MeshContext(world=3, rank=r, n_model=3).model_columns(t)
             for r in range(3)]
    assert torch.equal(torch.cat(parts, dim=-1), t)
