"""The port's mixture-of-experts layer over the data axis
(``parallel/expert.py`` under ``ParallelTrainer``, ROADMAP A6.2c) against
the JAX package's, on the CPU.

The JAX ``ParallelTrainer`` is one GSPMD program over the global batch,
so an ``MoELayer``'s capacity, its tokens' positions in the experts'
buffers and its balancing loss cover every row. The net here makes that
bind: ``Dense(16, relu) -> MoELayer(4 experts, capacity_factor=1.0,
aux_loss_weight=1.0) -> Output(3)`` on 32 rows routes 16 tokens each to
two experts against a global capacity of 8, and the same layer run on
each half of the rows gives another output. The port's trainer, in one
group of four gloo processes for the module
(``torch_parallel_worker.run_group``), is held to the JAX single-device
step (and the JAX ``ParallelTrainer``) at dp = 2 and 4, under zero1,
zero2 and accumulation 2, and on a ``[B, T, F]`` MoE at dp x tp x sp =
2 x 1 x 2: losses within 1e-5, params within rtol 2e-4 / atol 2e-5.
Weights cross by ``convert.params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType, NeuralNetConfiguration
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.layers.normalization import LayerNormalization
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import expert as jexpert
from deeplearning4j_tpu.parallel.mesh import MeshContext as JMesh
from deeplearning4j_tpu.parallel.trainer import ParallelTrainer as JTrainer

from deeplearning4j_tpu_torch.parallel import expert as pexpert

LOSS_TOL, RTOL, ATOL = 1e-5, 2e-4, 2e-5
ROWS, E, CF = 32, 4, 1.0


def moe_conf():
    return (NeuralNetConfiguration.builder().seed(5)
            .updater("sgd", learning_rate=0.1)
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(jexpert.MoELayer(n_experts=E, hidden=32,
                                    capacity_factor=CF, aux_loss_weight=1.0))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def seq_conf():
    """A [B, T, F] MoE: layer norm (token-wise, so an sp rank runs it on
    its time steps) in front of the experts (which see whole sequences)."""
    return (NeuralNetConfiguration.builder().seed(7)
            .updater("sgd", learning_rate=0.1)
            .list()
            .layer(LayerNormalization())
            .layer(jexpert.MoELayer(n_experts=E, hidden=16,
                                    capacity_factor=CF, aux_loss_weight=1.0))
            .layer(RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(6, 8)).build())


def ff_batches(n=2, rows=ROWS, seed=0):
    r = np.random.default_rng(seed)
    return [[r.normal(size=(rows, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.integers(0, 3, rows)]]
            for _ in range(n)]


def seq_batches(n=2, rows=8, T=8, seed=1):
    r = np.random.default_rng(seed)
    return [[r.normal(size=(rows, T, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.integers(0, 3, (rows, T))]]
            for _ in range(n)]


def jax_params(conf):
    return jax.tree.map(np.asarray, JNet(conf).init().params)


MLP, SEQ = moe_conf(), seq_conf()
P_MLP, P_SEQ = jax_params(MLP), jax_params(SEQ)
B_MLP, B_SEQ = ff_batches(), seq_batches()

#: case -> (conf, params, batches, mesh layout, mode, accumulation)
CASES = {
    "dp2": (MLP, P_MLP, B_MLP, (2, 1, 1), "off", 1),
    "dp4": (MLP, P_MLP, B_MLP, (4, 1, 1), "off", 1),
    "zero1": (MLP, P_MLP, B_MLP, (2, 1, 1), "zero1", 1),
    "zero2": (MLP, P_MLP, B_MLP, (2, 1, 1), "zero2", 1),
    "accum2": (MLP, P_MLP, B_MLP, (2, 1, 1), "off", 2),
    "sp": (SEQ, P_SEQ, B_SEQ, (2, 1, 2), "off", 1),
}


def c31_conf(seed):
    """C31's MoE MLP, the card's ``moe_dp`` net at its widths
    (``chip_smoke.moe_dp_conf``: Dense(512, relu) -> 8 experts of 2048 ->
    Output(96), Adam 1e-3), built by the port from ``seed``."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType as PInputType, NeuralNetConfiguration as PConf,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer as PDense, OutputLayer as POutput,
    )
    return (PConf.builder().seed(seed)
            .updater("adam", learning_rate=1e-3).weight_init("xavier")
            .list()
            .layer(PDense(n_out=512, activation="relu"))
            .layer(pexpert.MoELayer(n_experts=8, hidden=2048,
                                    capacity_factor=1.0,
                                    aux_loss_weight=1e-2,
                                    activation="relu"))
            .layer(POutput(n_out=96, activation="softmax", loss="mcxent"))
            .set_input_type(PInputType.feed_forward(512)).build())


def c31_batches(seed, rows=2048, n=3):
    r = np.random.default_rng(seed)
    return [[r.standard_normal((rows, 512), dtype=np.float32),
             np.eye(96, dtype=np.float32)[r.integers(0, 96, rows)]]
            for _ in range(n)]


#: C31's runs at dp = 2: a seed whose net crosses (one expert unit before
#: the third step), and one whose does not
C31_SEEDS = {"c31_cross": 23, "c31_none": 22}


def no_moe_conf():
    return (NeuralNetConfiguration.builder().seed(5)
            .updater("sgd", learning_rate=0.1)
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_data")
    cases = [dict(name=name, fn="moe_data",
                  args=dict(conf=conf.to_json(), params=params,
                            batches=batches, layout=layout, mode=mode,
                            accum=accum))
             for name, (conf, params, batches, layout, mode, accum)
             in CASES.items()]
    cases.append(dict(name="no_moe", fn="moe_data",
                      args=dict(conf=no_moe_conf().to_json(),
                                params=jax_params(no_moe_conf()),
                                batches=B_MLP, layout=(4, 1, 1))))
    cases += [dict(name=name, fn="moe_crossings",
                   args=dict(conf=c31_conf(seed).to_json(),
                             batches=c31_batches(seed + 1)))
              for name, seed in C31_SEEDS.items()]
    return W.run_group(cases, tmp, world=4)


def jax_steps(conf, params, batches, mesh=None, accum=1):
    """The JAX net's losses and flat params after one step on each batch:
    its own ``fit_batch``, or a JAX ``ParallelTrainer`` on ``mesh``."""
    net = JNet(conf).init(jax.tree.map(jnp.asarray, params))
    fit = net.fit_batch
    if mesh is not None or accum > 1:
        fit = JTrainer(net, mesh or JMesh.create(
            n_data=1, devices=jax.devices()[:1]),
            gradient_accumulation=accum).fit_batch
    losses = [float(fit(JDataSet(*b))) for b in batches]
    return losses, np.asarray(net.params_flat())


def assert_step(got, losses, params):
    np.testing.assert_allclose(got["losses"], losses, rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got["params"], params, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the net binds the capacity the global batch sets
# ---------------------------------------------------------------------------

def test_capacity_binds_on_the_global_batch():
    """At init the 32 rows route 16 tokens each to two experts against a
    global capacity of 8, so the layer drops tokens; run on each 16-row
    half (a per-rank step's view) it gives another output."""
    p = P_MLP
    x = B_MLP[0][0]
    h = np.maximum(x @ p[0]["W"] + p[0]["b"], 0.0)
    gates = jax.nn.softmax(jnp.asarray(h @ p[1]["Wg"]), axis=-1)
    counts = np.bincount(np.asarray(gates).argmax(-1), minlength=E)
    capacity = max(1, int(CF * ROWS / E))
    assert counts.max() > capacity, (counts, capacity)
    dispatch = jexpert.moe_dispatch(gates, capacity)[0]
    assert float(dispatch.sum()) < ROWS
    whole = np.asarray(jexpert.moe_ffn(p[1], jnp.asarray(h), "relu",
                                       CF)[0])
    halves = np.concatenate([np.asarray(jexpert.moe_ffn(
        p[1], jnp.asarray(h[i:i + ROWS // 2]), "relu", CF)[0])
        for i in (0, ROWS // 2)])
    assert np.abs(whole - halves).max() > 0.1


class _Halves:
    """``mesh.GlobalBatch``'s token methods for one of two data ranks that
    split ``counts_of`` (each rank's per-expert counts), no collective."""

    def __init__(self, rank, counts_of):
        self.rank, self.counts_of = rank, counts_of

    def n_tokens(self, n):
        return 2 * n

    def token_counts(self, counts):
        rows = torch.stack(self.counts_of).to(torch.float64)
        return rows[:self.rank].sum(dim=0), rows.sum(dim=0)

    def token_sum(self, t):
        return self.total


def test_global_dispatch_of_each_half_is_the_whole_batchs():
    """``moe_ffn`` on each half of the tokens with the global positions
    (the counts of the half before it) gives the rows the JAX layer gives
    on the whole batch, and the balancing loss of the whole."""
    p = P_MLP
    h = np.maximum(B_MLP[0][0] @ p[0]["W"] + p[0]["b"], 0.0).astype(
        np.float32)
    want, want_aux = jexpert.moe_ffn(p[1], jnp.asarray(h), "relu", CF)
    tp = {k: torch.tensor(v) for k, v in p[1].items()}
    halves = [torch.tensor(h[:ROWS // 2]), torch.tensor(h[ROWS // 2:])]
    gates = [torch.softmax(x @ tp["Wg"], dim=-1) for x in halves]
    counts = [torch.nn.functional.one_hot(g.argmax(-1), E).sum(0)
              for g in gates]
    outs = []
    for r, x in enumerate(halves):
        batch = _Halves(r, counts)
        batch.total = sum(g.sum(0) for g in gates)
        out, aux = pexpert.moe_ffn(tp, x, "relu", CF, batch=batch)
        assert abs(float(aux) - float(want_aux)) < LOSS_TOL
        outs.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(want),
                               rtol=LOSS_TOL, atol=LOSS_TOL)


# ---------------------------------------------------------------------------
# ParallelTrainer on the MoE net, against the JAX step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_moe_step_equals_the_jax_global_step(group, case):
    """Each rank's losses and params equal the JAX single-device steps on
    the global batches (accumulation 2: the JAX trainer's two
    microbatches on one device), and the ranks hold the same aux loss."""
    conf, params, batches, _, _, accum = CASES[case]
    losses, flat = jax_steps(conf, params, batches, accum=accum)
    for rank in range(4):
        got = W.result(group, case, rank)
        assert_step(got, losses, flat)
        assert got["aux"] == W.result(group, case, 0)["aux"]


@pytest.mark.parametrize("dp", [2, 4])
def test_moe_step_equals_the_jax_parallel_trainer(group, dp):
    losses, flat = jax_steps(MLP, P_MLP, B_MLP,
                             mesh=JMesh.create(n_data=dp,
                                               devices=jax.devices()[:dp]))
    for rank in range(4):
        assert_step(W.result(group, f"dp{dp}", rank), losses, flat)


def test_dispatch_collectives_run_only_for_an_moe_net(group):
    """A step of the MoE net gathers the per-expert counts and sums the
    gate totals over the data axis once a microbatch; a net with no MoE
    layer issues neither."""
    for case in ("dp2", "accum2", "sp"):
        _, _, batches, _, _, accum = CASES[case]
        got = W.result(group, case)
        n = len(batches) * accum
        assert [a for a, _ in got["gathers"]] == ["data"] * n, got
        assert [a for a, _ in got["sums"]] == ["data"] * n, got
        assert {b for _, b in got["gathers"]} == {E * 8}
    none = W.result(group, "no_moe")
    assert none["gathers"] == [] and none["sums"] == []


# ---------------------------------------------------------------------------
# C31: the MoE MLP's Adam path, gated by its crossed units
# ---------------------------------------------------------------------------

def test_c31_elements_outside_lie_in_crossed_units(group):
    """A mesh run whose net puts an expert unit's ReLU pre-activation on
    the other side of 0 (against the plain run, on a token both keep)
    before a step: every W1 / b1 / W2 element outside rtol 2e-4 / atol
    2e-5 of the plain run lies in a crossed unit's column, entry or row,
    the other leaves hold at most C23's 64, and there are some."""
    for rank in range(4):
        got = W.result(group, "c31_cross", rank)
        assert got["crossed_expert_units"] >= 1, got
        assert got["expert_outside"] > 0, got
        assert got["unexplained"] == 0, got
        assert got["other_outside"] <= 64, got
        assert got["holds"], got


def test_c31_no_crossing_leaves_no_element_outside(group):
    """A mesh run with no crossing holds every element of every leaf."""
    for rank in range(4):
        got = W.result(group, "c31_none", rank)
        assert got["crossed_dense_units"] == 0, got
        assert got["crossed_expert_units"] == 0, got
        assert got["expert_outside"] == 0 and got["other_outside"] == 0, got
        assert got["holds"], got
