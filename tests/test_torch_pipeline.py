"""The port's ``PipelineTrainer`` and ``pipeline_apply`` (``parallel/
pipeline.py``, ROADMAP A6.2b) against the JAX package's, on the CPU.

The port's side runs in one group of four gloo processes for the module
(``torch_parallel_worker.run_group(..., world=4)``), started in a thread
while the JAX side runs here: a 4-stage and a ``2 x 2`` (dp x pp) mesh
span the group, a 2-stage one each half of it. Nets are built from the
JAX configs' JSON, and both nets start from one set of weights: the
port's draw from the config's seed, carried into the rank processes by
``convert.params_from_jax`` and into the JAX nets by ``init(params)``.
Held, as ``tests/test_pipeline_trainer.py`` holds the JAX pipeline:

- one step of the MLP (4 stages, the last an identity), a conv body, a
  conv before the head, dp x pp, the MLP with L1 / L2 penalties (each
  stage's share summed over the stages), batch norm at M=1 (3 steps, running
  statistics too), the MoE layer at M=1, the char-RNN-shaped LSTM and
  its tBPTT windows (two batches), a carry-less bidirectional tBPTT net
  against the JAX single-device ``fit_batch``: losses within 1e-5,
  params within 1e-5 (2e-5 for the conv body);
- batch norm at M=4 and the MoE layer at M=2, whose pipeline semantics
  differ from one device, against the JAX ``PipelineTrainer`` on a
  2-device CPU mesh at the same M;
- convergence (MLP, batch norm, LSTM, MoE, dp x pp), dropout that
  repeats from a seed, per-microbatch batch-norm accuracy within 0.08 of
  the single-device run's;
- every refusal with the JAX package's words, the stage lists of
  ``partition_stages`` against the JAX package's (the char-RNN's
  timesteps refusal among them), the one-time aux warning, the
  telemetry phases, a sentinel's skipped step on every stage, the
  stage-local bytes, ``score`` refused until ``gather_params``, and a
  zip written after it;
- ``pipeline_apply`` over 4 and 2 stages against the stages run in turn
  and the JAX gradient of each stage's row (the JAX ``pipeline_apply``
  held to the same once).
"""

import concurrent.futures
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType, NeuralNetConfiguration
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization, ConvolutionLayer, DenseLayer, DropoutLayer,
    GravesBidirectionalLSTM, GravesLSTM, OutputLayer, RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import pipeline as jpipe
from test_pipeline_trainer import _bn_conf, _lstm_conf, _mlp_conf, _moe_conf

LOSS_TOL = 1e-5
P_ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def ff_batch(b, f, k, seed):
    r = _rng(seed)
    return [r.normal(size=(b, f)).astype(np.float32),
            np.eye(k, dtype=np.float32)[r.integers(0, k, b)]]


def seq_batch(b, T, f, k, seed):
    r = _rng(seed)
    return [r.normal(size=(b, T, f)).astype(np.float32),
            np.eye(k, dtype=np.float32)[r.integers(0, k, (b, T))]]


def img_batch(b, h, k, seed):
    r = _rng(seed)
    return [r.normal(size=(b, h, h, 1)).astype(np.float32),
            np.eye(k, dtype=np.float32)[r.integers(0, k, b)]]


def _builder(seed, lr=0.05):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater("sgd", learning_rate=lr).weight_init("xavier").list())


def conv_conf():
    return (_builder(3)
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    convolution_mode="same",
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())


def conv_head_conf():
    return (_builder(9)
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    convolution_mode="same",
                                    activation="relu"))
            .layer(OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 1)).build())


def rnn_single_conf():
    return (_builder(3)
            .layer(GravesLSTM(n_out=8, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(6, 5)).build())


def dropout_conf():
    return (_builder(11)
            .layer(DenseLayer(n_out=16, activation="relu", dropout=0.8))
            .layer(DropoutLayer(dropout=0.5))
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def bidi_conf():
    return (NeuralNetConfiguration.builder().seed(2)
            .updater("sgd", learning_rate=0.05).weight_init("xavier")
            .list().backprop_type("truncated_bptt", fwd=4, bwd=4)
            .layer(GravesBidirectionalLSTM(n_out=8, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(6, 8)).build())


def bn_blob_conf():
    return (_builder(9, lr=0.1)
            .layer(DenseLayer(n_out=12, activation="relu"))
            .layer(BatchNormalization())
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())


def penalty_conf():
    """The JAX tests' MLP with an L1 and an L2 penalty: each stage adds
    its own layers' share, summed over the stages."""
    return (NeuralNetConfiguration.builder().seed(7)
            .updater("sgd", learning_rate=0.1).weight_init("xavier")
            .l1(1e-3).l2(1e-2).list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(DenseLayer(n_out=20, activation="tanh"))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())


def stats_conf():
    return (_builder(7)
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())


def blob_batch():
    """tests/test_pipeline_trainer.py's separable two-class blobs."""
    rng = _rng(5)
    n = 64
    x = np.concatenate([rng.normal(-1.0, 0.8, size=(n // 2, 6)),
                        rng.normal(+1.0, 0.8, size=(n // 2, 6))]).astype(
                            np.float32)
    y = np.zeros((n, 2), np.float32)
    y[:n // 2, 0] = 1.0
    y[n // 2:, 1] = 1.0
    perm = rng.permutation(n)
    return [x[perm], y[perm]]


#: parity scenarios against the JAX single-device fit_batch: config,
#: batches, layout (n_data, n_pipe), M, passes, extra case arguments
PARITY = {
    "mlp_pp4": (_mlp_conf, [ff_batch(16, 12, 10, 1)], (1, 4), 4, 1, {}),
    "conv": (conv_conf, [img_batch(8, 8, 5, 2)], (1, 2), 4, 1, {}),
    "conv_head": (conv_head_conf, [img_batch(8, 6, 5, 3)], (1, 2), 2, 1,
                  {}),
    "dp_pp": (_mlp_conf, [ff_batch(16, 12, 10, 4)], (2, 2), 2, 1, {}),
    "penalty": (penalty_conf, [ff_batch(16, 12, 10, 41)], (1, 2), 2, 2, {}),
    "bn_m1": (_bn_conf, [ff_batch(8, 6, 3, 5)], (1, 2), 1, 3, {}),
    "moe_m1": (_moe_conf, [ff_batch(8, 6, 3, 6)], (1, 2), 1, 1, {}),
    "lstm": (_lstm_conf, [seq_batch(8, 8, 6, 4, 7)], (1, 2), 2, 1, {}),
    "lstm_tbptt": (lambda: _lstm_conf(tbptt=True),
                   [seq_batch(8, 8, 6, 4, 8), seq_batch(8, 8, 6, 4, 9)],
                   (1, 2), 2, 1, {}),
    "bidi_tbptt": (bidi_conf, [seq_batch(8, 8, 6, 3, 10)], (1, 2), 2, 1,
                   {}),
}
#: against the JAX PipelineTrainer on 2 CPU devices (per-microbatch
#: batch norm / aux semantics)
JAX_PIPE = {
    "bn_m4": (_bn_conf, [ff_batch(16, 6, 3, 11)], 4, 3),
    "moe_m2": (_moe_conf, [ff_batch(8, 6, 3, 12)], 2, 3),
}
#: convergence: config, batch, layout, M, passes
CONVERGE = {
    "mlp_pp4": (_mlp_conf, ff_batch(16, 12, 10, 13), (1, 4), 4, 16),
    "bn_m4": (_bn_conf, ff_batch(16, 6, 3, 14), (1, 2), 4, 21),
    "lstm": (_lstm_conf, seq_batch(8, 8, 6, 4, 15), (1, 2), 2, 11),
    "moe_m2": (_moe_conf, ff_batch(8, 6, 3, 16), (1, 2), 2, 13),
    "bn_dp_pp": (_bn_conf, ff_batch(8, 6, 3, 17), (2, 2), 2, 11),
    "moe_dp_pp": (lambda: _moe_conf(seed=6), ff_batch(8, 6, 3, 18), (2, 2),
                  2, 11),
}


def numpy_params(conf):
    """The initial weights both nets start from: the port's draw from the
    config's seed, as numpy arrays in the JAX package's layout (a JAX
    net's own draw compiles a program for each config)."""
    from deeplearning4j_tpu_torch.convert import params_to_numpy
    return params_to_numpy(W.conf_net(conf.to_json()).params)


def jax_fit(conf, batches, passes, trainer=None):
    """The JAX net's losses, params, states over ``passes`` of
    ``batches`` (its fit_batch, or ``trainer(net)``'s), from
    ``numpy_params(conf)``."""
    net = JNet(conf).init(jax.tree.map(jnp.asarray, numpy_params(conf)))
    fit = (trainer(net) if trainer else net).fit_batch
    losses = [float(fit(JDataSet(*b))) for _ in range(passes)
              for b in batches]
    return dict(losses=losses, params=np.asarray(net.params_flat()),
                states=jax.tree.map(np.asarray, net.states),
                iterations=net.iteration_count, net=net)


def _cases(tmp):
    cases = []
    for name, (conf, batches, layout, M, passes, kw) in PARITY.items():
        c = conf()
        cases.append(dict(name=name, fn="pp_fit", args=dict(
            conf=c.to_json(), params=numpy_params(c),
            batches=batches, layout=layout, M=M, steps=passes,
            save=str(tmp) if name == "mlp_pp4" else None, **kw)))
    for name, (conf, batches, M, passes) in JAX_PIPE.items():
        c = conf()
        cases.append(dict(name=f"jaxpipe/{name}", fn="pp_fit", args=dict(
            conf=c.to_json(), params=numpy_params(c),
            batches=batches, layout=(1, 2), M=M, steps=passes)))
    for name, (conf, batch, layout, M, passes) in CONVERGE.items():
        cases.append(dict(name=f"converge/{name}", fn="pp_fit", args=dict(
            conf=conf().to_json(), batches=[batch], layout=layout, M=M,
            steps=passes)))
    cases += [
        dict(name="blobs", fn="pp_fit", args=dict(
            conf=bn_blob_conf().to_json(), batches=[blob_batch()],
            layout=(1, 2), M=2, steps=40)),
        dict(name="recurrent", fn="pp_fit", args=dict(
            conf=rnn_single_conf().to_json(),
            batches=[seq_batch(8, 5, 6, 3, 19)], layout=(1, 2))),
        dict(name="sentinel", fn="pp_fit", args=dict(
            conf=_mlp_conf().to_json(),
            batches=[ff_batch(8, 12, 10, 20), ff_batch(8, 12, 10, 21)],
            layout=(1, 2), M=2, sentinel="skip_batch", poison=0)),
        dict(name="dropout", fn="pp_repeat", args=dict(
            conf=dropout_conf().to_json(), batches=[ff_batch(8, 6, 3, 22)],
            layout=(1, 2), M=2, steps=5)),
        dict(name="stats", fn="pp_stats", args=dict(
            conf=stats_conf().to_json(),
            batches=[ff_batch(8, 8, 3, 23 + i) for i in range(3)])),
        dict(name="refuse/mlp", fn="pp_refusals", args=dict(
            conf=_mlp_conf().to_json(), batches=[ff_batch(8, 12, 10, 26)],
            masked=True, M=2, remat=False)),
        dict(name="refuse/remat", fn="pp_refusals", args=dict(
            conf=_mlp_conf().to_json(), batches=[ff_batch(8, 12, 10, 26)],
            remat=True)),
        dict(name="refuse/dp", fn="pp_refusals", args=dict(
            conf=_mlp_conf().to_json(), batches=[ff_batch(12, 12, 10, 27)],
            layout=(2, 2), M=4, full=True)),
        dict(name="refuse/tbptt", fn="pp_refusals", args=dict(
            conf=_lstm_conf(tbptt=True).to_json(),
            batches=[seq_batch(8, 8, 6, 4, 28)], M=2, rank2_labels=True,
            dp_layout=(2, 2))),
        dict(name="refuse/bwd", fn="pp_refusals", args=dict(
            conf=_lstm_conf(tbptt=True).to_json(),
            batches=[seq_batch(8, 8, 6, 4, 28)], M=2, tbptt_bwd=2)),
        dict(name="apply4", fn="pipeline_apply", args=dict(
            stacked=APPLY4["stacked"], xs=APPLY4["x"], layout=(1, 4))),
        dict(name="apply2", fn="pipeline_apply", args=dict(
            stacked=APPLY2["stacked"], xs=APPLY2["x"], layout=(1, 2))),
    ]
    return cases


def _apply_data(S, M, B, F, seed, bias):
    r = _rng(seed)
    stacked = {"W": (r.normal(size=(S, F, F)) * 0.3).astype(np.float32)}
    if bias:
        stacked["b"] = (r.normal(size=(S, F)) * 0.1).astype(np.float32)
    return dict(stacked=stacked,
                x=r.normal(size=(M, B, F)).astype(np.float32))


APPLY4 = _apply_data(4, 6, 3, 8, 30, True)
APPLY2 = _apply_data(2, 4, 2, 4, 31, False)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(W.run_group, _cases(tmp), tmp, 4)
        ref = {name: jax_fit(conf(), batches, passes)
               for name, (conf, batches, _, _, passes, _) in PARITY.items()}
        mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
        for name, (conf, batches, M, passes) in JAX_PIPE.items():
            ref[f"jaxpipe/{name}"] = jax_fit(
                conf(), batches, passes,
                lambda net, M=M: jpipe.PipelineTrainer(
                    net, mesh=mesh, n_microbatches=M))
        blobs = jax_fit(bn_blob_conf(), [blob_batch()], 40)
        ref["blobs"] = np.asarray(blobs.pop("net").output(blob_batch()[0]))
        return run.result(), ref


def _holds(got, want, atol=P_ATOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PARITY))
def test_one_step_matches_the_jax_single_device_step(group, name):
    results, ref = group
    _, _, layout, _, _, _ = PARITY[name]
    want = ref[name]
    atol = 2e-5 if name == "conv" else P_ATOL
    for rank in range(layout[0] * layout[1]):
        got = W.result(results, name, rank)
        assert len(got["losses"]) == len(want["losses"])
        assert max(abs(a - b) for a, b in zip(got["losses"],
                                              want["losses"])) < LOSS_TOL
        _holds(got["params"], want["params"], atol)
        assert got["iterations"] == want["iterations"]
    if name == "bn_m1":
        got = W.result(results, name)["states"]
        for i, st in enumerate(want["states"]):
            for k, v in st.items():
                _holds(got[i][k], v)


@pytest.mark.parametrize("name", list(JAX_PIPE))
def test_microbatched_semantics_match_the_jax_pipeline(group, name):
    """Batch norm over each microbatch and the mean of per-microbatch aux
    losses: the JAX PipelineTrainer's own semantics at the same M."""
    results, ref = group
    want = ref[f"jaxpipe/{name}"]
    for rank in (0, 1):
        got = W.result(results, f"jaxpipe/{name}", rank)
        assert max(abs(a - b) for a, b in zip(got["losses"],
                                              want["losses"])) < LOSS_TOL
        _holds(got["params"], want["params"])
        if name == "bn_m4":
            for k, v in want["states"][1].items():
                _holds(got["states"][1][k], v)


def test_the_last_stage_of_four_is_an_identity_and_create_trainer_builds_it(
        group):
    results, _ = group
    got = W.result(results, "mlp_pp4", 3)
    assert got["type"] == "PipelineTrainer"
    assert got["stages"] == [[0], [1], [2], []]
    assert got["S"] == 4 and got["M"] == 4
    assert [W.result(results, "mlp_pp4", r)["coords"]
            for r in range(4)] == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert [W.result(results, "dp_pp", r)["coords"]
            for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_a_stage_holds_its_own_params_and_moments(group):
    """Stage-local updates: a rank of a 2-stage conv net holds its stage's
    params only, and score is refused until gather_params."""
    results, _ = group
    for rank in (0, 1):
        got = W.result(results, "conv", rank)
        whole, mine = got["whole_bytes"][0], got["rank_bytes"][0]
        assert 0 < mine < whole
        assert got["score_refused"][0] == "RuntimeError"
        assert "gather_params" in got["score_refused"][1]
    assert sum(W.result(results, "conv", r)["rank_bytes"][0]
               for r in (0, 1)) == W.result(results, "conv")["whole_bytes"][0]


def test_gather_params_then_a_zip_holds_the_trained_net(group):
    results, ref = group
    for rank in range(4):
        got = W.result(results, "mlp_pp4", rank)
        np.testing.assert_array_equal(got["zip_params"], got["params"])
        _holds(got["zip_params"], ref["mlp_pp4"]["params"])
        assert np.isfinite(got["score"])


# ---------------------------------------------------------------------------
# convergence, dropout, batch norm, sentinel, telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONVERGE))
def test_training_converges(group, name):
    results, _ = group
    layout = CONVERGE[name][2]
    for rank in range(layout[0] * layout[1]):
        got = W.result(results, f"converge/{name}", rank)
        assert np.isfinite(got["losses"]).all()
        assert got["losses"][-1] < got["losses"][0], got["losses"]
    if name.startswith("bn"):
        st = W.result(results, f"converge/{name}")["states"][1]
        assert float(np.abs(st["mean"]).max()) > 0
        assert np.isfinite(st["var"]).all()


def test_per_microbatch_batch_norm_tracks_the_single_device_accuracy(group):
    results, ref = group
    y = blob_batch()[1].argmax(1)
    a_ref = float((ref["blobs"].argmax(1) == y).mean())
    for rank in (0, 1):
        out = W.result(results, "blobs", rank)["output"]
        a_pp = float((out.argmax(1) == y).mean())
        assert a_ref >= 0.9 and a_pp >= 0.9, (a_ref, a_pp)
        assert abs(a_ref - a_pp) <= 0.08, (a_ref, a_pp)


def test_recurrent_stage_trains(group):
    got = W.result(group[0], "recurrent", 1)
    assert got["stages"] == [[0], []] and np.isfinite(got["losses"]).all()


def test_dropout_inside_the_stages_repeats_from_the_seed(group):
    for rank in (0, 1):
        got = W.result(group[0], "dropout", rank)
        assert np.isfinite(got["runs"][0]).all()
        np.testing.assert_allclose(got["runs"][0], got["runs"][1],
                                   rtol=1e-6)
        assert got["outputs_equal"]


def test_a_bad_step_is_skipped_on_every_stage(group):
    for rank in (0, 1):
        got = W.result(group[0], "sentinel", rank)
        assert got["poisoned_kept"] and got["skipped"] == 1
        assert not np.isfinite(got["losses"][0])
        assert np.isfinite(got["losses"][1])


def test_pipeline_trainer_collects_stats(group):
    got = W.result(group[0], "stats")
    e = got["export"]
    assert e["phases"]["step"]["count"] == 6
    for phase in ("shard", "data_wait", "listener"):
        assert phase in e["phases"]
    assert got["total"] <= got["wall"] * 1.01
    assert got["events"] == (["start"] + ["iter"] * 3 + ["end"]) * 2
    assert got["epochs"] == 2


# ---------------------------------------------------------------------------
# refusals and stage lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,key,words", [
    ("refuse/mlp", "masked", "mask"),
    ("refuse/mlp", "rows", "not divisible by n_microbatches=2"),
    ("refuse/mlp", "axis", "mesh has no 'x' axis"),
    ("refuse/remat", "construct", "remat"),
    ("refuse/dp", "full", "not divisible by the dp axis"),
    ("refuse/tbptt", "rank2", "rank-3"),
    ("refuse/tbptt", "dp", "pp-only"),
    ("refuse/bwd", "construct", "bwd"),
])
def test_refusals_keep_the_jax_words(group, case, key, words):
    err = W.result(group[0], case)[key]
    assert err is not None and err[0] == "ValueError" and words in err[1], \
        err


def test_the_jax_refusals_name_the_same_words():
    """The JAX package's own refusals for the cases above."""
    conf = _lstm_conf(tbptt=True)
    net = JNet(conf).init(jax.tree.map(jnp.asarray, numpy_params(conf)))
    net.conf.training.tbptt_bwd_length = 2
    with pytest.raises(ValueError, match="bwd"):
        jpipe.PipelineTrainer(net, mesh=Mesh(np.array(jax.devices()[:2]),
                                             ("pp",)), n_microbatches=2)


def _port(conf):
    return W.conf_net(conf.to_json())


def _fake_mesh(S):
    from deeplearning4j_tpu_torch.parallel import MeshContext
    return MeshContext(world=S, rank=0, n_pipe=S)


@pytest.mark.parametrize("build", [_mlp_conf, _bn_conf, conv_conf,
                                   _moe_conf, _lstm_conf, conv_head_conf])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_stage_lists_are_the_jax_packages(build, S):
    from deeplearning4j_tpu_torch.parallel import pipeline as ppipe
    net = _port(build())
    jnet = JNet(build()).init(jax.tree.map(jnp.asarray,
                                           numpy_params(build())))
    body, jbody = net.layers[:-1], jnet.layers[:-1]
    want = jpipe.partition_stages(
        jbody, jnet.params, S,
        act_elems=jpipe._mln_boundary_elems(jnet.conf, jbody))
    got = ppipe.partition_stages(
        body, net.params, S,
        act_elems=ppipe._mln_boundary_elems(net.conf, body))
    assert got == want
    assert ppipe.PipelineTrainer(net, _fake_mesh(S)).stages == want


def test_partition_rules_match_the_jax_tests():
    from deeplearning4j_tpu_torch.parallel.pipeline import partition_stages
    layers = [object()] * 4
    params = {i: {"W": np.zeros((100,))} for i in range(4)}
    act = [10.0, 1000.0, 10.0]
    assert partition_stages(layers, params, 2) == [[0, 1], [2, 3]]
    assert partition_stages(layers, params, 2, act_elems=act) == \
        jpipe.partition_stages(layers, params, 2, act_elems=act)
    sizes = [50, 50, 50, 10, 200]
    params = {i: {"W": np.zeros((s,))} for i, s in enumerate(sizes)}
    assert partition_stages([object()] * 5, params, 2) == \
        jpipe.partition_stages([object()] * 5, params, 2)


def test_char_rnn_needs_its_stages_named_as_in_the_jax_package():
    """char_rnn_lstm declares no timesteps: the stage partition refuses
    it, and stages=[[0], [1]] builds, in both packages."""
    from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jconf
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineTrainer
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    net = MultiLayerNetwork(char_rnn_lstm(12, 16, 2), device="cpu").init()
    from deeplearning4j_tpu_torch.convert import params_to_numpy
    jnet = JNet(jconf(12, 16, 2)).init(jax.tree.map(
        jnp.asarray, params_to_numpy(net.params)))
    with pytest.raises(ValueError, match="needs fixed timesteps") as jerr:
        jpipe.PipelineTrainer(jnet, mesh=mesh)
    with pytest.raises(ValueError, match="needs fixed timesteps") as err:
        PipelineTrainer(net, _fake_mesh(2))
    assert str(err.value).split(" (")[0] == str(jerr.value).split(" (")[0]
    assert jpipe.PipelineTrainer(jnet, mesh=mesh,
                                 stages=[[0], [1]]).stages == [[0], [1]]
    assert PipelineTrainer(net, _fake_mesh(2), stages=[[0], [1]],
                           n_microbatches=2).stages == [[0], [1]]
    for bad in ([[1], [0]], [[], [0, 1]], [[0, 1]]):
        with pytest.raises(ValueError, match="stages"):
            PipelineTrainer(MultiLayerNetwork(char_rnn_lstm(12, 16, 2),
                                              device="cpu").init(),
                            _fake_mesh(2), stages=bad)


def test_aux_microbatch_warning_fires_once(caplog):
    """M > 1 with aux-loss layers warns once a process (world 1 here)."""
    from deeplearning4j_tpu_torch.parallel import pipeline as ppipe
    ppipe._WARNED_AUX_MICROBATCH = False
    log = "deeplearning4j_tpu_torch.parallel.pipeline"
    with caplog.at_level(logging.WARNING, logger=log):
        for _ in range(2):
            ppipe.PipelineTrainer(_port(_moe_conf()), n_microbatches=2,
                                  device="cpu")
    warns = [r for r in caplog.records
             if "aux-loss" in r.message and "n_microbatches" in r.message]
    assert len(warns) == 1
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=log):
        ppipe.PipelineTrainer(_port(_moe_conf()), n_microbatches=1,
                              device="cpu")
    assert not [r for r in caplog.records if "aux-loss" in r.message]


def test_world_1_pipeline_runs_on_the_card_unless_asked_for_the_cpu():
    from deeplearning4j_tpu_torch.parallel.strategy import create_trainer
    net = _port(_mlp_conf())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_trainer("pipeline", net)
    tr = create_trainer("pipeline", net, device="cpu", n_microbatches=2)
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    loss = tr.fit_batch(DataSet(*ff_batch(8, 12, 10, 40)))
    assert np.isfinite(float(loss)) and net.iteration_count == 1


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------

def _jax_apply(data):
    """The stages of ``data`` run in turn, and the JAX gradient of
    sum(out**2) with respect to the stack (the sequential composition
    ``pipeline_apply`` computes)."""
    def forward(stacked, x):
        for s in range(stacked["W"].shape[0]):
            h = x @ stacked["W"][s]
            x = jnp.tanh(h + stacked["b"][s] if "b" in stacked else h)
        return x
    stacked = {k: jnp.asarray(v) for k, v in data["stacked"].items()}
    x = jnp.asarray(data["x"])
    grads = jax.grad(lambda p: jnp.sum(forward(p, x) ** 2))(stacked)
    return np.asarray(forward(stacked, x)), jax.tree.map(np.asarray, grads)


def test_jax_pipeline_apply_is_the_stages_in_turn():
    """The reference the port is held to: the JAX ``pipeline_apply`` over
    2 CPU devices equals the stages run in turn."""
    def stage_fn(p, x):
        return jnp.tanh(x @ p["W"])
    stacked = {k: jnp.asarray(v) for k, v in APPLY2["stacked"].items()}
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    out = jpipe.pipeline_apply(stage_fn, stacked, jnp.asarray(APPLY2["x"]),
                               mesh)
    np.testing.assert_allclose(np.asarray(out), _jax_apply(APPLY2)[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,S", [("apply4", 4), ("apply2", 2)])
def test_pipeline_apply_matches_the_stages_in_turn_and_jax_gradients(
        group, name, S):
    out, grads = _jax_apply(APPLY4 if S == 4 else APPLY2)
    for rank in range(S):
        got = W.result(group[0], name, rank)
        np.testing.assert_allclose(got["out"], out, rtol=1e-5, atol=1e-5)
        row = got["row"]
        assert row == rank and got["other_rows_zero"]
        for k, g in got["grads"].items():
            assert np.any(g != 0)
            np.testing.assert_allclose(g, grads[k][row], rtol=1e-5,
                                       atol=1e-5)


def test_stack_stage_params_stacks_each_leaf():
    from deeplearning4j_tpu_torch.parallel.pipeline import stack_stage_params
    parts = [{"W": torch.full((2, 2), float(i))} for i in range(3)]
    got = stack_stage_params(parts)
    assert got["W"].shape == (3, 2, 2) and float(got["W"][2, 0, 0]) == 2.0
