"""ZeRO-1/2 weight-update sharding in the port's ``ParallelTrainer``, at
world 2 on the CPU (one group of two gloo processes for the module,
``torch_parallel_worker``), within the port: the JAX package's zero
tests are ROADMAP C1, so the yardstick is the port's own replicated mode.

At world 2 a sum over the ranks is ``a + b`` in every collective, and the
three modes reduce each microbatch in the same order, so fp32 zero1 and
zero2 trajectories equal the replicated one bit for bit
(``tests/test_zero1.py:61`` ``test_zero1_loss_parity_bitwise``,
``tests/test_zero2.py`` ``test_zero2_matches_zero1_bitwise``): with and
without label masks and gradient accumulation, with a frozen layer and a
per-layer learning rate, the elementwise clip, a bf16 compute policy, on
``gpt_tiny`` and on a char-RNN's tBPTT windows. A norm-based clip sums
the rows' squares in another order: held to its max difference. Also
held: updater state sharded 1/dp (rows of ``ceil(size / 2)``), half the
bytes; ``gather_opt_state`` round trips; a NaN batch under a skip_batch
sentinel skipped at the same step on both ranks; the per-leaf layout
helpers against the JAX package's.
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu.parallel.mesh import (
    zero1_chunk as jzero1_chunk, zero1_shard_leaf as jzero1_shard_leaf,
)

MODES = ("off", "zero1", "zero2")
#: 17 hidden units: every leaf needs padding to divide by 2
MLP = dict(hidden=17)


def _batches(n=1, rows=16, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        arrays = [rng.normal(size=(rows, 4)).astype(np.float32),
                  np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]]
        if masked:
            arrays += [None, (rng.random(rows) > 0.3).astype(np.float32)]
        out.append(arrays)
    return out


def _seq(V, T, rows, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (rows, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return [[eye[tok[:, :-1]], eye[tok[:, 1:]]]]


def _poisoned():
    clean = _batches(seed=1)[0]
    bad = [np.array(clean[0]), clean[1]]
    bad[0][0, 0] = np.nan
    return [clean, bad, clean]


#: name -> (kind, net kwargs, batches, accum, precision, sentinel, steps)
SETS = {
    "plain": ("mlp", MLP, _batches(), 1, None, None, 5),
    "masked": ("mlp", MLP, _batches(masked=True), 1, None, None, 5),
    "accum4": ("mlp", MLP, _batches(), 4, None, None, 5),
    "accum4_masked": ("mlp", MLP, _batches(masked=True), 4, None, None, 5),
    "frozen_layer_lr": ("mlp", dict(MLP, frozen=True, layer_lr=0.01),
                        _batches(), 1, None, None, 3),
    "sgd_elementwise_clip": ("mlp", dict(
        MLP, updater="nesterovs", clip="clipelementwiseabsolutevalue"),
        _batches(), 2, None, None, 3),
    "bf16": ("mlp", MLP, _batches(), 1, "bf16", None, 3),
    "gpt": ("gpt", dict(vocab_size=16, seq_len=16), _seq(16, 16, 4, 2), 2,
            None, None, 2),
    "char_rnn_tbptt": ("char_rnn", dict(vocab_size=12, hidden=16, layers=2,
                                        tbptt_length=5),
                       _seq(12, 12, 4, 3), 1, None, None, 2),
    "sentinel": ("mlp", MLP, _poisoned(), 1, None, "skip_batch", 1),
}
#: norm-based clips: the rows' sums of squares run in another order
CLIPS = {"clip_l2_per_layer": "clipl2perlayer",
         "renorm_per_param_type": "renormalizel2perparamtype"}


def _cases():
    cases = []
    for name, (kind, kw, batches, accum, prec, sentinel, steps) in \
            SETS.items():
        for mode in MODES:
            cases.append(dict(name=f"{name}/{mode}", fn="trainer", args=dict(
                kind=kind, net_kw=kw, params=None, batches=batches,
                steps=steps, accum=accum, mode=mode, precision=prec,
                sentinel=sentinel)))
    for name, clip in CLIPS.items():
        for mode in ("off", "zero2"):
            cases.append(dict(name=f"{name}/{mode}", fn="trainer", args=dict(
                kind="mlp", net_kw=dict(MLP, clip=clip), params=None,
                batches=_batches(), steps=3, mode=mode)))
    cases += [dict(name=f"gather/{mode}", fn="gather_roundtrip",
                   args=dict(net_kw=MLP, batches=_batches(), mode=mode))
              for mode in ("zero1", "zero2")]
    cases.append(dict(name="memory", fn="zero_memory",
                      args=dict(net_kw=dict(hidden=64))))
    return cases


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return W.run_group(_cases(), tmp_path_factory.mktemp("zero"))


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_zero_trajectory_is_the_replicated_one_bitwise(group, name, mode):
    for rank in (0, 1):
        ref = W.result(group, f"{name}/off", rank)
        got = W.result(group, f"{name}/{mode}", rank)
        assert got["loss_bytes"] == ref["loss_bytes"], (rank, got["losses"],
                                                        ref["losses"])
        assert got["params"].tobytes() == ref["params"].tobytes(), rank
        assert np.isfinite(got["params"]).all()


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_norm_clip_under_zero_holds_its_max_difference(group, name):
    """The clip norms are all-reduced sums of the rows' squares, summed in
    another order than on whole tensors: within 1e-6 of the replicated
    params after 3 steps (relative), not bit for bit."""
    ref = W.result(group, f"{name}/off")
    got = W.result(group, f"{name}/zero2")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["params"], ref["params"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_updater_state_is_sharded_1_over_dp(group, mode):
    """Adam's mu and nu: each leaf this rank's row of ceil(size / 2)."""
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    net = W.build("mlp", **MLP)
    want = sorted([(1, jzero1_chunk(t.numel(), 2))
                   for t in tree_leaves(net.params)] * 2)
    assert W.result(group, f"plain/{mode}")["opt_shapes"] == want
    full = sorted([tuple(t.shape) for t in tree_leaves(net.params)] * 2)
    assert W.result(group, "plain/off")["opt_shapes"] == full


def test_sharded_state_holds_half_the_bytes(group):
    got = W.result(group, "memory")
    assert got["rows"] < 0.52 * got["full"]


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_gather_opt_state_round_trips(group, mode):
    for rank in (0, 1):
        got = W.result(group, f"gather/{mode}", rank)
        assert got["gathered"] == sorted(got["params"] * 2)
        assert got["whole_equal"] and got["bitwise"]


@pytest.mark.parametrize("mode", MODES)
def test_sentinel_skip_fires_at_the_same_step_on_every_rank(group, mode):
    for rank in (0, 1):
        got = W.result(group, f"sentinel/{mode}", rank)
        assert got["skipped"] == 1


# ---------------------------------------------------------------------------
# the layout, in this process
# ---------------------------------------------------------------------------

def test_mode_parse_and_flags():
    from deeplearning4j_tpu_torch.parallel import WeightUpdateSharding
    assert not WeightUpdateSharding.parse(None).enabled
    assert WeightUpdateSharding.parse("zero1").enabled
    assert not WeightUpdateSharding.parse("zero1").zero2
    assert WeightUpdateSharding.parse("zero2").zero2
    with pytest.raises(ValueError, match="mode must be one of"):
        WeightUpdateSharding.parse("zero3")


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_zero_refuses_a_world_1_mesh(mode):
    from deeplearning4j_tpu_torch.parallel import MeshContext, ParallelTrainer
    with pytest.raises(ValueError, match="at least 2 replicas"):
        ParallelTrainer(W.build("mlp"), MeshContext.create(device="cpu"),
                        weight_update_sharding=mode)


@pytest.mark.parametrize("size,n", [(17, 2), (12, 4), (1, 3), (68, 8)])
def test_shard_leaf_is_the_jax_layout(size, n):
    from deeplearning4j_tpu_torch.parallel.mesh import (
        zero1_chunk, zero1_shard_leaf, zero1_unshard_leaf,
    )
    x = np.arange(size, dtype=np.float32).reshape(-1, 1) + 0.5
    got = zero1_shard_leaf(torch.from_numpy(x), n)
    assert zero1_chunk(size, n) == jzero1_chunk(size, n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jzero1_shard_leaf(x, n)))
    assert zero1_unshard_leaf(got, x.shape).numpy().tobytes() == x.tobytes()


def test_zero_layout_rows_views_and_unpack():
    """Each rank's row holds its chunk of every leaf; views write through;
    the gathered rows rebuild every leaf."""
    from deeplearning4j_tpu_torch.nn.updater import ZeroLayout, tree_leaves
    tree = [{"W": torch.arange(15.0).reshape(3, 5), "b": torch.arange(4.0)},
            {"W": torch.arange(7.0)}]
    rows = []
    for rank in range(3):
        lay = ZeroLayout(tree, 3, rank)
        assert lay.row == 5 + 2 + 3
        rows.append(lay.take_row(tree))
    packed = ZeroLayout(tree, 3, 0).pack(tree)
    assert torch.equal(packed, torch.stack(rows))
    lay = ZeroLayout(tree, 3, 1)
    views = lay.views(rows[1], tree)
    assert [tuple(v.shape) for v in tree_leaves(views)] == [(1, 5), (1, 2),
                                                            (1, 3)]
    tree_leaves(views)[0].fill_(-1.0)
    assert (rows[1][:5] == -1).all()
    out = [{"W": torch.zeros(3, 5), "b": torch.zeros(4)},
           {"W": torch.zeros(7)}]
    lay.unpack_into(torch.cat(rows), out)
    assert torch.equal(out[0]["W"].reshape(-1)[5:10],
                       torch.full((5,), -1.0))
    assert torch.equal(out[0]["b"], tree[0]["b"])
    assert torch.equal(out[1]["W"], tree[1]["W"])


@pytest.mark.parametrize("kind", ["clipl2perlayer", "renormalizel2perlayer",
                                  "clipl2perparamtype",
                                  "renormalizel2perparamtype",
                                  "clipelementwiseabsolutevalue", "none"])
def test_sharded_normalization_at_world_1_is_the_plain_one(kind):
    """One rank, no padding: the rows are the whole tensors, and the
    sharded normalization gives the plain one's values bit for bit."""
    from deeplearning4j_tpu_torch.nn.updater import (
        normalize_gradients, normalize_gradients_sharded, tree_leaves,
    )
    from deeplearning4j_tpu_torch.parallel import MeshContext
    net = W.build("mlp", clip=kind)
    rng = np.random.default_rng(0)
    grads = [{k: torch.from_numpy(rng.normal(size=t.shape).astype(
        np.float32)) for k, t in p.items()} for p in net.params]
    want = normalize_gradients(grads, net.conf.training)
    got = normalize_gradients_sharded(grads, net.conf.training,
                                      MeshContext.create(device="cpu"))
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
