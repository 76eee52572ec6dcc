"""The port's ``GraphPipelineTrainer`` (``parallel/pipeline.py``, ROADMAP
A6.2b) against the JAX package's, on the CPU.

The port's side runs in one group of four gloo processes for the module
(``torch_parallel_worker.run_group(..., world=4)``), started in a thread
while the JAX side runs here: the ``2 x 2`` (dp x pp) mesh spans the
group, a 2-stage one each half of it. Both nets start from the port's
draw of the config's seed, carried into the ranks by
``convert.params_from_jax``. Held, as ``tests/test_graph_pipeline.py``
holds the JAX graph pipeline:

- one step (or three) against the JAX single-device ``fit_batch``: a
  residual DAG with batch norm at M=1 (running statistics too), the same
  DAG without batch norm under a per-layer L2 clip at M=2 (the whole
  tree's norm, its squares summed over the stages), the two-input /
  two-head DAG at M=2, and ``gpt_tiny`` whose tied head sits on the last
  stage while its embedding is stage 0's, at M=1 (Adam) and M=2 (SGD):
  losses within 1e-5, params within 1e-5 (the GPT's at rtol 2e-4 /
  atol 2e-5, as the tensor-parallel tests hold it);
- the merge-vertex DAG with batch norm on dp x pp converging, dropout
  repeating from a seed, the epoch hooks, the cut points of a ResNet and
  the stage lists of the full-width GPT (cut at ``b3_res2``) against the
  JAX package's, the refusals in its words, the stage-local bytes, and
  ``gather_params`` then a zip.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType, NeuralNetConfiguration
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.resnet import resnet_tiny as jresnet_tiny
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization, DenseLayer, DropoutLayer, OutputLayer,
)
from deeplearning4j_tpu.parallel import pipeline as jpipe
from test_graph_pipeline import _small_dag, _two_in_two_out_dag

LOSS_TOL = 1e-5
P_ATOL = 1e-5
GPT_RTOL, GPT_ATOL = 2e-4, 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def ff_batch(b, f, k, seed):
    r = _rng(seed)
    return [r.normal(size=(b, f)).astype(np.float32),
            np.eye(k, dtype=np.float32)[r.integers(0, k, b)]]


def multi_batch(seed):
    r = _rng(seed)
    return [[r.normal(size=(8, 5)).astype(np.float32),
             r.normal(size=(8, 4)).astype(np.float32)],
            [np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)],
             np.eye(2, dtype=np.float32)[r.integers(0, 2, 8)]]]


def text_batch(V, T, rows, seed):
    r = _rng(seed)
    tok = r.integers(0, V, (rows, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return [eye[tok[:, :-1]], eye[tok[:, 1:]]]


def residual_dag(seed=4, bn=True, clip=None):
    """A ResNet-style DAG: a stem, then two residual blocks whose skip
    joins by an add vertex (each block output a cut point)."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater("sgd", learning_rate=0.05).weight_init("xavier"))
    if clip is not None:
        b = b.gradient_normalization(clip, threshold=0.5)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("stem", DenseLayer(n_out=12, activation="relu"), "in")
    prev = "stem"
    if bn:
        g.add_layer("bn", BatchNormalization(), "stem")
        prev = "bn"
    for blk in range(2):
        g.add_layer(f"r{blk}_a", DenseLayer(n_out=12, activation="relu"),
                    prev)
        g.add_layer(f"r{blk}_b", DenseLayer(n_out=12, activation="identity"),
                    f"r{blk}_a")
        g.add_vertex(f"r{blk}_add", ElementWiseVertex(op="add"), prev,
                     f"r{blk}_b")
        prev = f"r{blk}_add"
    g.add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"), prev)
    return g.set_outputs("out").set_input_types(
        InputType.feed_forward(6)).build()


def dropout_dag():
    b = (NeuralNetConfiguration.builder().seed(9)
         .updater("sgd", learning_rate=0.05).weight_init("xavier")
         .graph_builder().add_inputs("in"))
    b.add_layer("d1", DenseLayer(n_out=12, activation="relu", dropout=0.7),
                "in")
    b.add_layer("drop", DropoutLayer(dropout=0.5), "d1")
    b.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"), "drop")
    return b.set_outputs("out").set_input_types(
        InputType.feed_forward(6)).build()


GPT_KW = dict(vocab_size=16, seq_len=16)

#: parity against the JAX single-device fit_batch: config, batches (a
#: MultiDataSet's when ``multi``), M, passes, multi, params' tolerances
PARITY = {
    "residual_bn": (lambda: residual_dag(), [ff_batch(8, 6, 4, 1)], 1, 3,
                    False, (0, P_ATOL)),
    "residual_clip": (lambda: residual_dag(bn=False, clip="clipl2perlayer"),
                      [ff_batch(8, 6, 4, 2)], 2, 2, False, (0, P_ATOL)),
    "multi_io": (_two_in_two_out_dag, [multi_batch(3)], 2, 1, True,
                 (0, P_ATOL)),
    "gpt_adam": (lambda: jgpt.gpt_tiny(**GPT_KW),
                 [text_batch(16, 16, 4, 4)], 1, 2, False,
                 (GPT_RTOL, GPT_ATOL)),
    "gpt_sgd": (lambda: jgpt.gpt_tiny(**GPT_KW, updater="sgd",
                                      learning_rate=0.05),
                [text_batch(16, 16, 4, 5)], 2, 2, False,
                (GPT_RTOL, GPT_ATOL)),
}


def numpy_params(conf):
    """The port's draw of the config's seed, as numpy arrays in the JAX
    package's layout."""
    from deeplearning4j_tpu_torch.convert import params_to_numpy
    return params_to_numpy(W.conf_net(conf.to_json(), graph=True).params)


def jax_net(conf):
    return JGraph(conf).init(jax.tree.map(jnp.asarray, numpy_params(conf)))


def jax_fit(conf, batches, passes, multi):
    net = jax_net(conf)
    data = [JMulti(*b) if multi else JDataSet(*b) for b in batches]
    losses = [float(net.fit_batch(d)) for _ in range(passes) for d in data]
    return dict(losses=losses, params=np.asarray(net.params_flat()),
                states=jax.tree.map(np.asarray, net.states))


def _cases(tmp):
    cases = []
    for name, (conf, batches, M, passes, multi, _) in PARITY.items():
        c = conf()
        cases.append(dict(name=name, fn="pp_fit", args=dict(
            conf=c.to_json(), graph=True, params=numpy_params(c),
            batches=batches, M=M, steps=passes, multi=multi,
            save=str(tmp) if name == "gpt_adam" else None)))
    small = _small_dag().to_json()
    cases += [
        dict(name="dp_pp", fn="pp_fit", args=dict(
            conf=small, graph=True, batches=[ff_batch(8, 6, 4, 6)],
            layout=(2, 2), M=2, steps=11)),
        dict(name="dropout", fn="pp_repeat", args=dict(
            conf=dropout_dag().to_json(), graph=True,
            batches=[ff_batch(8, 6, 3, 7)], steps=3)),
        dict(name="hooks", fn="pp_stats", args=dict(
            conf=small, graph=True, batches=[ff_batch(4, 6, 4, 8)], M=1)),
        dict(name="refusals", fn="pp_refusals", args=dict(
            conf=small, graph=True, batches=[ff_batch(8, 6, 4, 9)], M=1,
            masked=True, multi_arrays=[
                [[_rng(10).normal(size=(4, 32, 32, 3)).astype(np.float32)],
                 [np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]]],
                [[np.zeros((4, 6), np.float32)] * 2,
                 [np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]]]])),
        dict(name="refuse_remat", fn="pp_refusals", args=dict(
            conf=small, graph=True, batches=[ff_batch(8, 6, 4, 9)],
            remat=True)),
    ]
    return cases


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_pipeline")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(W.run_group, _cases(tmp), tmp, 4)
        ref = {name: jax_fit(conf(), batches, passes, multi)
               for name, (conf, batches, _, passes, multi, _)
               in PARITY.items()}
        return run.result(), ref


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PARITY))
def test_steps_match_the_jax_single_device_steps(group, name):
    results, ref = group
    want = ref[name]
    rtol, atol = PARITY[name][5]
    for rank in (0, 1):
        got = W.result(results, name, rank)
        assert got["type"] == "GraphPipelineTrainer"
        assert max(abs(a - b) for a, b in zip(got["losses"],
                                              want["losses"])) < LOSS_TOL
        np.testing.assert_allclose(got["params"], want["params"],
                                   rtol=rtol, atol=atol)
    if name == "residual_bn":
        st = W.result(results, name)["states"]["bn"]
        for k, v in want["states"]["bn"].items():
            np.testing.assert_allclose(st[k], v, atol=P_ATOL, rtol=0)


def test_the_tied_head_takes_stage_0s_embedding(group):
    """gpt_tiny at 2 stages: the embedding on stage 0, the tied head on
    stage 1; each rank holds its stage's params, and the gathered params
    (the embedding trained by the head's gradient too) write a zip that
    restores them."""
    results, _ = group
    s0, s1 = (W.result(results, "gpt_adam", r) for r in (0, 1))
    assert s0["stages"][0][0] == "embed" and s0["stages"][1][-1] == "ln_f"
    assert s0["rank_bytes"][0] + s1["rank_bytes"][0] == s0["whole_bytes"][0]
    for got in (s0, s1):
        assert 0 < got["rank_bytes"][1] < got["whole_bytes"][1]
        assert got["score_refused"][0] == "RuntimeError"
        np.testing.assert_array_equal(got["zip_params"], got["params"])
        assert np.isfinite(got["score"])


# ---------------------------------------------------------------------------
# dp x pp, dropout, hooks, refusals
# ---------------------------------------------------------------------------

def test_dp_times_pp_with_batch_norm_converges(group):
    results, _ = group
    for rank in range(4):
        got = W.result(results, "dp_pp", rank)
        assert np.isfinite(got["losses"]).all()
        assert got["losses"][-1] < got["losses"][0]
    assert float(np.abs(W.result(results, "dp_pp")["states"]["bn"]["mean"])
                 .max()) > 0
    np.testing.assert_array_equal(W.result(results, "dp_pp", 0)["params"],
                                  W.result(results, "dp_pp", 3)["params"])


def test_dropout_repeats_from_the_seed(group):
    for rank in (0, 1):
        got = W.result(group[0], "dropout", rank)
        assert np.isfinite(got["runs"][0]).all()
        np.testing.assert_allclose(got["runs"][0], got["runs"][1],
                                   rtol=1e-6)
        assert got["outputs_equal"]


def test_epoch_hooks_fire(group):
    got = W.result(group[0], "hooks")
    assert got["events"] == ["start", "iter", "end", "start", "iter", "end"]
    assert got["epochs"] == 2


@pytest.mark.parametrize("case,key,words", [
    ("refusals", "masked", "mask"),
    ("refusals", "axis", "mesh has no 'x' axis"),
    ("refuse_remat", "construct", "remat"),
])
def test_refusals_keep_the_jax_words(group, case, key, words):
    err = W.result(group[0], case)[key]
    assert err is not None and err[0] == "ValueError" and words in err[1], \
        err


def test_multidataset_refusals_keep_the_jax_words(group):
    shape_err, arity_err = W.result(group[0], "refusals")["multi"]
    assert "elements/sample" in shape_err[1]
    assert "arity" in arity_err[1]


def _fake_mesh(S):
    from deeplearning4j_tpu_torch.parallel import MeshContext
    return MeshContext(world=S, rank=0, n_pipe=S)


def _port_graph(conf):
    return W.conf_net(conf.to_json(), graph=True)


def test_tied_non_head_and_tbptt_are_refused():
    """``tests/test_gpt.py::test_graph_pipeline_rejects_tied_non_head``
    and ``tests/test_pipeline_trainer.py::
    test_graph_pipeline_rejects_tbptt``, on the port."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration as PNNC,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as PIT
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        PositionalEmbeddingLayer, RnnOutputLayer, TiedRnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GraphPipelineTrainer,
    )
    g = (PNNC.builder().graph_builder()
         .add_inputs("tokens")
         .add_layer("embed", PositionalEmbeddingLayer(
             n_out=8, activation="identity"), "tokens")
         .add_layer("mid", TiedRnnOutputLayer(
             n_out=4, tied_to="embed", activation="softmax"), "embed")
         .add_layer("out", RnnOutputLayer(n_out=4, activation="softmax",
                                          loss="mcxent"), "mid")
         .set_outputs("out")
         .set_input_types(PIT.recurrent(4, 4)))
    net = ComputationGraph(g.build(), device="cpu").init()
    with pytest.raises(ValueError, match="tied"):
        GraphPipelineTrainer(net, _fake_mesh(2))
    conf = _small_dag()
    conf.training.backprop_type = "truncated_bptt"
    with pytest.raises(ValueError, match="truncated_bptt"):
        GraphPipelineTrainer(_port_graph(conf), _fake_mesh(2))


# ---------------------------------------------------------------------------
# cut points and stage lists
# ---------------------------------------------------------------------------

def test_cut_points_are_the_jax_packages():
    from deeplearning4j_tpu_torch.models.resnet import resnet_tiny
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        find_graph_cut_points,
    )
    got = find_graph_cut_points(resnet_tiny())
    assert got == jpipe.find_graph_cut_points(jresnet_tiny())
    cuts = {n for _, n in got}
    assert "s0b0_out" in cuts and "s1b0_add" in cuts
    assert "s0b0_a_conv" not in cuts and "s0b0_b_act" not in cuts
    for build in (_small_dag, _two_in_two_out_dag, residual_dag,
                  lambda: jgpt.gpt_tiny(**GPT_KW)):
        c = build()
        assert find_graph_cut_points(_port_graph(c).conf) == \
            jpipe.find_graph_cut_points(c)


@pytest.mark.parametrize("build,S", [
    (_small_dag, 2), (_two_in_two_out_dag, 2), (_two_in_two_out_dag, 3),
    (residual_dag, 2), (residual_dag, 4),
    (lambda: jgpt.gpt_tiny(**GPT_KW), 2),
])
def test_stage_lists_are_the_jax_packages(build, S):
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GraphPipelineTrainer,
    )
    c = build()
    want = jpipe.GraphPipelineTrainer(
        jax_net(c), mesh=Mesh(np.array(jax.devices()[:S]), ("pp",)))
    got = GraphPipelineTrainer(_port_graph(build()), _fake_mesh(S))
    assert got.stages == want.stages
    assert got.boundaries == want.boundaries


def test_the_full_width_gpt_cuts_at_b3_res2():
    """gpt_decoder(96, 256, 512, 8, 8) at 2 stages: embed and blocks 0-3
    (29 nodes), then blocks 4-7 and ln_f (29 nodes), in both packages."""
    from deeplearning4j_tpu_torch.convert import params_to_numpy
    from deeplearning4j_tpu_torch.models.gpt import gpt_decoder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GraphPipelineTrainer,
    )
    net = ComputationGraph(gpt_decoder(96, 256, 512, 8, 8),
                           device="cpu").init()
    jnet = JGraph(jgpt.gpt_decoder(96, 256, 512, 8, 8)).init(
        jax.tree.map(jnp.asarray, params_to_numpy(net.params)))
    want = jpipe.GraphPipelineTrainer(
        jnet, mesh=Mesh(np.array(jax.devices()[:2]), ("pp",)))
    got = GraphPipelineTrainer(net, _fake_mesh(2))
    assert got.stages == want.stages and got.boundaries == want.boundaries
    assert got.boundaries[1] == ["b3_res2"]
    assert [len(st) for st in got.stages] == [29, 29]
    assert got.stages[0][0] == "embed" and got.stages[1][-1] == "ln_f"
    # the rank of stage 0 holds the embedding and blocks 0-3 only
    held = sum(t.numel() for p in net.params.values() for t in p.values())
    assert 0.45 * 25_384_448 < held < 0.55 * 25_384_448


def _refused_graph(kind):
    """A small graph the graph pipeline refuses: a LastTimeStep vertex, a
    recurrent layer, an aux-loss (MoE) layer, an output head that feeds
    another node."""
    from deeplearning4j_tpu.nn.conf.graph import LastTimeStepVertex
    from deeplearning4j_tpu.nn.layers import GravesLSTM
    from deeplearning4j_tpu.parallel.expert import MoELayer
    b = (NeuralNetConfiguration.builder().seed(3)
         .updater("sgd", learning_rate=0.05).weight_init("xavier")
         .graph_builder().add_inputs("in"))
    if kind == "last_step":
        b.add_vertex("last", LastTimeStepVertex(), "in")
        b.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "last")
        return b.set_outputs("out").set_input_types(
            InputType.recurrent(4, 5)).build()
    if kind == "recurrent":
        from deeplearning4j_tpu.nn.layers import RnnOutputLayer
        b.add_layer("rnn", GravesLSTM(n_out=6, activation="tanh"), "in")
        b.add_layer("out", RnnOutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "rnn")
        return b.set_outputs("out").set_input_types(
            InputType.recurrent(4, 5)).build()
    if kind == "aux":
        b.add_layer("d", DenseLayer(n_out=8, activation="relu"), "in")
        b.add_layer("moe", MoELayer(n_experts=2, hidden=8), "d")
        b.add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "moe")
        return b.set_outputs("out").set_input_types(
            InputType.feed_forward(4)).build()
    b.add_layer("out1", OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"), "in")
    b.add_layer("d", DenseLayer(n_out=4, activation="relu"), "out1")
    b.add_layer("out2", OutputLayer(n_out=2, activation="softmax",
                                    loss="mcxent"), "d")
    return b.set_outputs("out1", "out2").set_input_types(
        InputType.feed_forward(4)).build()


@pytest.mark.parametrize("kind,words", [
    ("last_step", "LastTimeStepVertex"),
    ("recurrent", "is recurrent"),
    ("aux", "auxiliary loss"),
    ("feeds", "feeds other nodes"),
])
def test_graph_refusals_keep_the_jax_words(kind, words):
    """The JAX GraphPipelineTrainer's refusals, raised with its words by
    both packages."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        GraphPipelineTrainer,
    )
    conf = _refused_graph(kind)
    with pytest.raises(ValueError, match=words):
        jpipe.GraphPipelineTrainer(
            jax_net(conf), mesh=Mesh(np.array(jax.devices()[:2]), ("pp",)))
    with pytest.raises(ValueError, match=words):
        GraphPipelineTrainer(_port_graph(conf), _fake_mesh(2))
