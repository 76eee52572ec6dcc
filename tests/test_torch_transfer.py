"""The port's transfer learning (``nn/transferlearning.py``), early
stopping (``earlystopping/``) and gradient checks (``gradientcheck/``)
against the JAX package's, from the same weights (copied with
``convert.params_from_jax``; configs through the JAX JSON):

- the cases of ``tests/test_transfer_earlystopping.py`` and
  ``tests/test_transfer_graph.py``: the built configs equal; kept params
  bit for bit the source's; re-initialized layers take the JAX net's
  weights before training, so losses agree within 1e-5 (relative) and
  params within 2e-4 / 2e-5 after; frozen params bit for bit unchanged;
- early stopping: the same termination reason and details' condition,
  the same epochs and best epoch, scores within 1e-5; listeners' events
  equal; the file saver's ``bestModel.zip`` restores in both packages;
- ``EarlyStoppingParallelTrainer`` at world 2 on gloo ranks
  (``tests/torch_parallel_worker.py``) against the JAX one on a 2-device
  mesh: scores 1e-5, params 2e-4 / 2e-5, both ranks bit for bit;
- the gradient checks of ``tests/test_gradientcheck.py``: the port's
  check (float64, on the CPU) passes where the JAX check passes, and a
  check made to fail (a coarse epsilon against a tight tolerance) fails
  in both;
- the slice as a whole at a small width: the char-RNN's Keras twin
  (``chip_smoke.write_keras_char_rnn``) imported by both packages,
  layer 0 frozen by ``TransferLearning``, Adam 1e-3 under an
  ``EarlyStoppingTrainer`` scored on held-out batches: step losses 1e-5,
  scores 1e-5, the same best epoch, the frozen layer bit for bit.
"""

import json

import jax
import numpy as np
import pytest

import chip_smoke
import torch_parallel_worker as W
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iris import IrisDataSetIterator as JIris
from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator as JList
from deeplearning4j_tpu.gradientcheck import GradientCheckUtil as JCheck
from deeplearning4j_tpu.keras.keras_import import KerasModelImport as JImport
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel import MeshContext as JMesh
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSerializer

from deeplearning4j_tpu_torch import earlystopping as pes
from deeplearning4j_tpu_torch.convert import (
    opt_state_from_jax, params_from_jax, states_from_jax,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iris import IrisDataSetIterator
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.gradientcheck import GradientCheckUtil
from deeplearning4j_tpu_torch.keras.keras_import import KerasModelImport
from deeplearning4j_tpu_torch.nn import layers as PL
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning, TransferLearningHelper,
)

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 2e-4, 2e-5


# ---------------------------------------------------------------------------
# nets from the same weights
# ---------------------------------------------------------------------------

def _port(jnet):
    """The port's twin of a JAX net on the CPU: its config through the
    JAX JSON, its params, states and updater state copied."""
    graph = isinstance(jnet, JGraph)
    conf = (ComputationGraphConfiguration if graph
            else MultiLayerConfiguration).from_json(jnet.conf.to_json())
    cls = ComputationGraph if graph else MultiLayerNetwork
    net = cls(conf, device="cpu").init(
        params=params_from_jax(conf, jax.tree.map(np.asarray, jnet.params)),
        states=states_from_jax(conf, jax.tree.map(np.asarray, jnet.states)))
    opt_state_from_jax(net, [np.asarray(a) for a in
                             jax.tree_util.tree_leaves(jnet.opt_state)])
    return net


def _same_conf(jnet, pnet):
    assert json.loads(pnet.conf.to_json()) == json.loads(jnet.conf.to_json())


def _flat(net):
    return np.asarray(net.params_flat())


def _take_jax_params(pnet, jnet):
    """Re-initialized layers draw other numbers in each package: start
    the port's net from the JAX net's."""
    pnet.set_params_flat(_flat(jnet))


def _pretrained(seed=12345, lr=0.05):
    """``tests/test_transfer_earlystopping.py``'s pretrained MLP, trained
    by the JAX package, and its port twin."""
    conf = (JNNC.builder()
            .seed(seed).updater("adam", learning_rate=lr).weight_init("xavier")
            .list()
            .layer(JL.DenseLayer(n_out=16, activation="relu"))
            .layer(JL.DenseLayer(n_out=8, activation="relu"))
            .layer(JL.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JInputType.feed_forward(4))
            .build())
    jnet = JNet(conf).init()
    jnet.fit(JIris(batch_size=50), epochs=10, use_async=False)
    return jnet, _port(jnet)


IRIS = [(b.features, b.labels) for b in JIris(batch_size=50)]


def _fit(jnet, pnet, batches, epochs=1):
    """The same batches through both nets' ``fit_batch``: the losses."""
    jl = [float(jnet.fit_batch(JDataSet(*b))) for _ in range(epochs)
          for b in batches]
    pl = [float(pnet.fit_batch(DataSet(*b))) for _ in range(epochs)
          for b in batches]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    return pl


def test_frozen_layers_do_not_update_as_in_jax():
    jsrc, psrc = _pretrained()
    jnet = jtl.TransferLearning.builder(jsrc).set_feature_extractor(1).build()
    pnet = TransferLearning.builder(psrc).set_feature_extractor(1).build()
    _same_conf(jnet, pnet)
    assert _flat(pnet).tobytes() == _flat(jnet).tobytes()
    frozen = [pnet.params[i]["W"].clone() for i in (0, 1)]
    head = pnet.params[2]["W"].clone()
    _fit(jnet, pnet, IRIS, epochs=3)
    for i in (0, 1):
        assert pnet.params[i]["W"].equal(frozen[i])
        assert pnet.params[i]["W"].equal(psrc.params[i]["W"])
    assert not pnet.params[2]["W"].equal(head)
    np.testing.assert_allclose(_flat(pnet), _flat(jnet), rtol=P_RTOL,
                               atol=P_ATOL)
    # the source net is left as it was
    assert not psrc.params[2]["W"].equal(pnet.params[2]["W"])


def test_n_out_replace_reinitializes_as_in_jax():
    jsrc, psrc = _pretrained()
    jnet = jtl.TransferLearning.builder(jsrc).n_out_replace(1, 12).build()
    pnet = TransferLearning.builder(psrc).n_out_replace(1, 12).build()
    _same_conf(jnet, pnet)
    assert tuple(pnet.params[1]["W"].shape) == (16, 12)
    assert tuple(pnet.params[2]["W"].shape) == (12, 3)
    assert pnet.params[0]["W"].equal(psrc.params[0]["W"])
    _take_jax_params(pnet, jnet)
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
    _fit(jnet, pnet, IRIS)


def test_remove_and_add_output_layer_as_in_jax():
    jsrc, psrc = _pretrained()
    jnet = (jtl.TransferLearning.builder(jsrc).remove_output_layer()
            .add_layer(JL.OutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent")).build())
    pnet = (TransferLearning.builder(psrc).remove_output_layer()
            .add_layer(PL.OutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent")).build())
    _same_conf(jnet, pnet)
    assert tuple(pnet.output(np.zeros((2, 4), np.float32)).shape) == (2, 5)
    _take_jax_params(pnet, jnet)
    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(10, 4)).astype(np.float32),
             np.eye(5, dtype=np.float32)[np.arange(10) % 5])]
    _fit(jnet, pnet, data, epochs=3)


def test_fine_tune_configuration_overrides_as_in_jax():
    jsrc, psrc = _pretrained()
    ftc = dict(updater="sgd", learning_rate=0.5, l2=0.01)
    jnet = (jtl.TransferLearning.builder(jsrc).fine_tune_configuration(
        jtl.FineTuneConfiguration(**ftc)).build())
    pnet = (TransferLearning.builder(psrc).fine_tune_configuration(
        FineTuneConfiguration(**ftc)).build())
    _same_conf(jnet, pnet)
    assert pnet.conf.training.updater.name == "sgd"
    assert pnet.conf.training.updater.learning_rate == 0.5
    assert pnet.conf.layers[0].l2 == 0.01
    _fit(jnet, pnet, IRIS, epochs=2)


def test_transfer_helper_featurizes_as_in_jax():
    jsrc, psrc = _pretrained()
    jnet = jtl.TransferLearning.builder(jsrc).set_feature_extractor(0).build()
    pnet = TransferLearning.builder(psrc).set_feature_extractor(0).build()
    jh, ph = jtl.TransferLearningHelper(jnet), TransferLearningHelper(pnet)
    x = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    feats = ph.featurize(x)
    assert tuple(feats.shape) == (6, 16)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jh.featurize(x)),
                               atol=1e-6)
    jtop, ptop = jh.unfrozen_net(), ph.unfrozen_net()
    _same_conf(jtop, ptop)
    np.testing.assert_allclose(ptop.output(feats).numpy(),
                               np.asarray(jtop.output(np.asarray(feats))),
                               atol=1e-6)
    # the top shares the net's tensors
    assert ptop.params[0]["W"] is pnet.params[1]["W"]


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------

def _results_equal(jres, pres):
    assert pres.termination_reason == jres.termination_reason
    assert (pres.termination_details.split(" ")[0]
            == jres.termination_details.split(" ")[0])
    assert pres.total_epochs == jres.total_epochs
    assert pres.best_model_epoch == jres.best_model_epoch
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for k, v in jres.score_vs_epoch.items():
        np.testing.assert_allclose(pres.score_vs_epoch[k], v, rtol=LOSS_RTOL)
    if np.isfinite(jres.best_model_score):
        np.testing.assert_allclose(pres.best_model_score,
                                   jres.best_model_score, rtol=LOSS_RTOL)


def _es_config(pkg, calculator_it=None, epoch_conds=(), iter_conds=(),
               saver=None):
    return pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=list(epoch_conds),
        iteration_termination_conditions=list(iter_conds),
        score_calculator=(None if calculator_it is None else
                          pkg.DataSetLossCalculator(calculator_it)),
        model_saver=saver if saver is not None else pkg.InMemoryModelSaver())


def test_early_stopping_max_epochs_as_in_jax():
    jnet, pnet = _pretrained()
    jres = jes.EarlyStoppingTrainer(
        _es_config(jes, JIris(batch_size=150),
                   [jes.MaxEpochsTerminationCondition(4)]),
        jnet, JIris(batch_size=50)).fit()
    pres = pes.EarlyStoppingTrainer(
        _es_config(pes, IrisDataSetIterator(batch_size=150),
                   [pes.MaxEpochsTerminationCondition(4)]),
        pnet, IrisDataSetIterator(batch_size=50)).fit()
    _results_equal(jres, pres)
    assert pres.termination_reason == "EpochTerminationCondition"
    assert pres.total_epochs == 4 and pres.best_model_epoch >= 1
    # the in-memory saver put the best epoch's params back into the net
    assert pres.best_model is pnet
    np.testing.assert_allclose(_flat(pnet), _flat(jres.best_model),
                               rtol=P_RTOL, atol=P_ATOL)


def test_early_stopping_score_improvement_as_in_jax():
    jnet, pnet = _pretrained(lr=1e-8)

    def conds(pkg):
        return [pkg.MaxEpochsTerminationCondition(50),
                pkg.ScoreImprovementEpochTerminationCondition(
                    max_epochs_without_improvement=2, min_improvement=1e-3)]
    jres = jes.EarlyStoppingTrainer(
        _es_config(jes, JIris(batch_size=150), conds(jes)), jnet,
        JIris(batch_size=50)).fit()
    pres = pes.EarlyStoppingTrainer(
        _es_config(pes, IrisDataSetIterator(batch_size=150), conds(pes)),
        pnet, IrisDataSetIterator(batch_size=50)).fit()
    _results_equal(jres, pres)
    assert pres.total_epochs < 50


def _diverging(pkg_conf, layers, input_type, net_cls):
    conf = (pkg_conf.builder().seed(1).updater("sgd", learning_rate=1e6)
            .list().layer(layers.DenseLayer(n_out=8, activation="relu"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(input_type.feed_forward(4)).build())
    return net_cls(conf)


def test_early_stopping_nan_abort_as_in_jax():
    jnet = _diverging(JNNC, JL, JInputType, JNet).init()
    pnet = _port(jnet)

    def cfg(pkg):
        return _es_config(pkg, None, [pkg.MaxEpochsTerminationCondition(20)],
                          [pkg.MaxScoreIterationTerminationCondition(
                              max_score=1e4)])
    jres = jes.EarlyStoppingTrainer(cfg(jes), jnet, JIris(50)).fit()
    pres = pes.EarlyStoppingTrainer(cfg(pes), pnet,
                                    IrisDataSetIterator(50)).fit()
    assert pres.termination_reason == jres.termination_reason == \
        "IterationTerminationCondition"
    assert pres.total_epochs == jres.total_epochs


def _graph_conf(pkg_conf, layers, input_type):
    return (pkg_conf.builder().seed(1)
            .updater("adam", learning_rate=0.05).weight_init("xavier")
            .graph_builder().add_inputs("in")
            .add_layer("d", layers.DenseLayer(n_out=16, activation="relu"),
                       "in")
            .add_layer("out", layers.OutputLayer(n_out=3,
                                                 activation="softmax"), "d")
            .set_outputs("out")
            .set_input_types(input_type.feed_forward(4)).build())


def test_early_stopping_listener_and_graph_trainer_as_in_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    jnet = JGraph(_graph_conf(JNNC, JL, JInputType)).init()
    pnet = _port(jnet)
    runs = {}
    for label, pkg, net, data in (
            ("jax", jes, jnet, JList([JDataSet(x, y)])),
            ("port", pes, pnet, ListDataSetIterator([DataSet(x, y)]))):
        events = []

        class Rec(pkg.EarlyStoppingListener):
            def on_start(self, config, model):
                events.append("start")

            def on_epoch(self, epoch, score, config, model):
                events.append(("epoch", epoch, round(float(score), 4)))

            def on_completion(self, result):
                events.append(("done", result.termination_reason))

        cfg = _es_config(pkg, None, [
            pkg.MaxEpochsTerminationCondition(50),
            pkg.BestScoreEpochTerminationCondition(best_expected_score=0.4)],
            [pkg.InvalidScoreIterationTerminationCondition()])
        res = pkg.EarlyStoppingGraphTrainer(cfg, net, data,
                                            listener=Rec()).fit()
        runs[label] = (events, res)
    (jev, jres), (pev, pres) = runs["jax"], runs["port"]
    assert pev == jev
    _results_equal(jres, pres)
    c = pes.InvalidScoreIterationTerminationCondition()
    assert c.terminate(float("nan")) and c.terminate(float("inf"))
    assert not c.terminate(1.0)


def test_local_file_saver_round_trips_through_both_packages(tmp_path):
    jnet, pnet = _pretrained()
    saver = pes.LocalFileModelSaver(str(tmp_path / "es"))
    cfg = _es_config(pes, IrisDataSetIterator(batch_size=150),
                     [pes.MaxEpochsTerminationCondition(3)], saver=saver)
    cfg.save_last_model = True
    res = pes.EarlyStoppingTrainer(cfg, pnet,
                                   IrisDataSetIterator(batch_size=50)).fit()
    best = res.best_model
    assert isinstance(best, MultiLayerNetwork) and best is not pnet
    assert (tmp_path / "es" / "latestModel.zip").exists()
    np.testing.assert_allclose(
        best.score(DataSet(*[np.concatenate(a) for a in zip(*IRIS)])),
        res.best_model_score, rtol=1e-6)
    jbest = JSerializer.restore_model(tmp_path / "es" / "bestModel.zip")
    assert _flat(best).tobytes() == _flat(jbest).tobytes()


# ---------------------------------------------------------------------------
# graph transfer learning
# ---------------------------------------------------------------------------

def _base_graph():
    conf = (JNNC.builder().seed(3).updater("sgd").learning_rate(0.1)
            .graph_builder().add_inputs("in")
            .add_layer("d1", JL.DenseLayer(n_out=10, activation="relu"),
                       "in")
            .add_layer("d2", JL.DenseLayer(n_out=8, activation="relu"),
                       "d1")
            .add_layer("out", JL.OutputLayer(n_out=4, activation="softmax",
                                             loss="mcxent"), "d2")
            .set_outputs("out")
            .set_input_types(JInputType.feed_forward(5)).build())
    jnet = JGraph(conf).init()
    return jnet, _port(jnet)


GRNG = np.random.default_rng(0)
GX = GRNG.normal(size=(6, 5)).astype(np.float32)


def test_graph_nout_replace_keeps_upstream_params_as_in_jax():
    jsrc, psrc = _base_graph()
    jnet = jtl.TransferLearning.graph_builder(jsrc).n_out_replace(
        "out", 7).build()
    pnet = TransferLearning.graph_builder(psrc).n_out_replace(
        "out", 7).build()
    _same_conf(jnet, pnet)
    assert pnet.params["d1"]["W"].equal(psrc.params["d1"]["W"])
    assert tuple(pnet.params["out"]["W"].shape) == (8, 7)
    _take_jax_params(pnet, jnet)
    np.testing.assert_allclose(pnet.output(GX).numpy(),
                               np.asarray(jnet.output(GX)), atol=1e-6)


def test_graph_feature_extractor_freezes_ancestors_as_in_jax():
    jsrc, psrc = _base_graph()
    jnet = jtl.TransferLearning.graph_builder(jsrc).set_feature_extractor(
        "d2").build()
    pnet = TransferLearning.graph_builder(psrc).set_feature_extractor(
        "d2").build()
    _same_conf(jnet, pnet)
    assert pnet.conf.nodes["d1"].layer.frozen
    assert pnet.conf.nodes["d2"].layer.frozen
    assert not pnet.conf.nodes["out"].layer.frozen
    d1 = pnet.params["d1"]["W"].clone()
    y = np.eye(4, dtype=np.float32)[GRNG.integers(0, 4, 6)]
    _fit(jnet, pnet, [(GX, y)], epochs=3)
    assert pnet.params["d1"]["W"].equal(d1)
    np.testing.assert_allclose(_flat(pnet), _flat(jnet), rtol=P_RTOL,
                               atol=P_ATOL)


def test_graph_remove_and_add_new_head_as_in_jax():
    jsrc, psrc = _base_graph()

    def edit(builder, layers, ftc):
        return (builder.remove_vertex_and_connections("out")
                .add_layer("new_out", layers.OutputLayer(
                    n_out=2, activation="softmax", loss="mcxent"), "d2")
                .set_outputs("new_out")
                .fine_tune_configuration(ftc(learning_rate=0.01)).build())
    jnet = edit(jtl.TransferLearning.graph_builder(jsrc), JL,
                jtl.FineTuneConfiguration)
    pnet = edit(TransferLearning.graph_builder(psrc), PL,
                FineTuneConfiguration)
    _same_conf(jnet, pnet)
    assert pnet.conf.network_outputs == ["new_out"]
    assert pnet.params["d2"]["W"].equal(psrc.params["d2"]["W"])
    _take_jax_params(pnet, jnet)
    y = np.eye(2, dtype=np.float32)[GRNG.integers(0, 2, 6)]
    losses = _fit(jnet, pnet, [(GX, y)], epochs=11)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# EarlyStoppingParallelTrainer at world 2
# ---------------------------------------------------------------------------

def _mlp_batches(n, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(rows, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]]
            for _ in range(n)]


ES_TRAIN, ES_HELD = _mlp_batches(3, seed=1), _mlp_batches(2, seed=2)


def test_early_stopping_parallel_trainer_matches_jax_at_world_2(tmp_path):
    jnet = JNet(_jax_mlp_conf()).init()
    params = jax.tree.map(np.asarray, jnet.params)
    group = W.run_group([dict(name="es", fn="early_stopping_parallel",
                              args=dict(params=params, batches=ES_TRAIN,
                                        held_out=ES_HELD, epochs=3))],
                        tmp_path)
    cfg = _es_config(jes, JList([JDataSet(*b) for b in ES_HELD]),
                     [jes.MaxEpochsTerminationCondition(3)])
    jres = jes.EarlyStoppingParallelTrainer(
        cfg, jnet, JList([JDataSet(*b) for b in ES_TRAIN]),
        mesh=JMesh.create(n_data=2)).fit()
    got = W.result(group, "es")
    assert got["reason"] == jres.termination_reason
    assert got["epochs"] == jres.total_epochs == 3
    assert got["best_epoch"] == jres.best_model_epoch
    for k, v in jres.score_vs_epoch.items():
        np.testing.assert_allclose(got["scores"][int(k)], v, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["params"], _flat(jnet), rtol=P_RTOL,
                               atol=P_ATOL)
    assert W.result(group, "es", rank=1)["params"].tobytes() == \
        got["params"].tobytes()
    assert got["iterations"] == 3 * len(ES_TRAIN)


def _jax_mlp_conf(seed=12345, lr=0.05, hidden=16):
    """``torch_parallel_worker.mlp_conf``'s MLP, built by the JAX package."""
    return (JNNC.builder().seed(seed).updater("adam", learning_rate=lr)
            .weight_init("xavier").list()
            .layer(JL.DenseLayer(n_out=hidden, activation="relu"))
            .layer(JL.DenseLayer(n_out=hidden, activation="tanh"))
            .layer(JL.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JInputType.feed_forward(4)).build())


# ---------------------------------------------------------------------------
# gradient checks
# ---------------------------------------------------------------------------

GRAD_RNG = np.random.default_rng(42)


def _seq(layers, input_type, *stack):
    b = JNNC.builder().seed(7)
    lb = b.list()
    for layer in stack:
        lb = lb.layer(layer)
    return lb.set_input_type(input_type).build()


def _rnn(cls, **kw):
    return (_seq(None, JInputType.recurrent(3),
                 cls(n_out=4, activation="tanh", **kw),
                 JL.RnnOutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent")),
            GRAD_RNG.normal(size=(3, 4, 3)),
            np.eye(2)[GRAD_RNG.integers(0, 2, (3, 4))], {})


def _masked(cls):
    mask = np.ones((3, 5))
    mask[0, 3:] = 0.0
    mask[2, 1:] = 0.0
    return (_seq(None, JInputType.recurrent(3),
                 cls(n_out=4, activation="tanh"),
                 JL.RnnOutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent")),
            GRAD_RNG.normal(size=(3, 5, 3)),
            np.eye(2)[GRAD_RNG.integers(0, 2, (3, 5))],
            dict(features_mask=mask, labels_mask=mask))


def _dense(loss, act):
    labels = np.eye(3)[GRAD_RNG.integers(0, 3, 6)]
    conf = (JNNC.builder().seed(7).l2(0.01).l1(0.005).list()
            .layer(JL.DenseLayer(n_out=5, activation="tanh"))
            .layer(JL.OutputLayer(n_out=3, activation=act, loss=loss))
            .set_input_type(JInputType.feed_forward(4)).build())
    return conf, GRAD_RNG.normal(size=(6, 4)), labels, {}


GRAD_CASES = {
    "dense_mcxent": lambda: _dense("mcxent", "softmax"),
    "dense_mse_identity": lambda: _dense("mse", "identity"),
    "dense_mse_tanh": lambda: _dense("mse", "tanh"),
    "dense_xent": lambda: _dense("xent", "sigmoid"),
    "cnn": lambda: (_seq(None, JInputType.convolutional(5, 5, 2),
                         JL.ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                             stride=(1, 1),
                                             activation="tanh"),
                         JL.SubsamplingLayer(pooling_type="max",
                                             kernel_size=(2, 2),
                                             stride=(1, 1)),
                         JL.OutputLayer(n_out=2, activation="softmax",
                                        loss="mcxent")),
                    GRAD_RNG.normal(size=(4, 5, 5, 2)),
                    np.eye(2)[GRAD_RNG.integers(0, 2, 4)], {}),
    "cnn_avg_same": lambda: (
        _seq(None, JInputType.convolutional(4, 4, 1),
             JL.ConvolutionLayer(n_out=2, kernel_size=(3, 3),
                                 convolution_mode="same",
                                 activation="sigmoid"),
             JL.SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2),
                                 stride=(2, 2)),
             JL.OutputLayer(n_out=2, activation="softmax", loss="mcxent")),
        GRAD_RNG.normal(size=(3, 4, 4, 1)),
        np.eye(2)[GRAD_RNG.integers(0, 2, 3)], {}),
    "batchnorm": lambda: (
        _seq(None, JInputType.feed_forward(4),
             JL.DenseLayer(n_out=6, activation="tanh"),
             JL.BatchNormalization(),
             JL.OutputLayer(n_out=3, activation="softmax", loss="mcxent")),
        GRAD_RNG.normal(size=(5, 4)),
        np.eye(3)[GRAD_RNG.integers(0, 3, 5)], {}),
    "lrn": lambda: (
        _seq(None, JInputType.convolutional(4, 4, 1),
             JL.ConvolutionLayer(n_out=4, kernel_size=(2, 2),
                                 activation="tanh"),
             JL.LocalResponseNormalization(),
             JL.OutputLayer(n_out=2, activation="softmax", loss="mcxent")),
        GRAD_RNG.normal(size=(3, 4, 4, 1)),
        np.eye(2)[GRAD_RNG.integers(0, 2, 3)], {}),
    "lstm": lambda: _rnn(JL.LSTM),
    "graves_lstm": lambda: _rnn(JL.GravesLSTM),
    "graves_bidirectional": lambda: _rnn(JL.GravesBidirectionalLSTM),
    "simple_rnn": lambda: _rnn(JL.SimpleRnn),
    "gru": lambda: _rnn(JL.GRU),
    "gru_reset_before": lambda: _rnn(JL.GRU, reset_after=False),
    "graves_lstm_masked": lambda: _masked(JL.GravesLSTM),
    "gru_masked": lambda: _masked(JL.GRU),
    "global_pooling_lstm": lambda: (
        _seq(None, JInputType.recurrent(3),
             JL.LSTM(n_out=4, activation="tanh"),
             JL.GlobalPoolingLayer(pooling_type="avg"),
             JL.OutputLayer(n_out=2, activation="softmax", loss="mcxent")),
        GRAD_RNG.normal(size=(3, 4, 3)),
        np.eye(2)[GRAD_RNG.integers(0, 2, 3)], {}),
    "embedding": lambda: (
        _seq(None, JInputType.feed_forward(7),
             JL.EmbeddingLayer(n_out=4, activation="identity"),
             JL.OutputLayer(n_out=3, activation="softmax", loss="mcxent")),
        GRAD_RNG.integers(0, 7, (5, 1)).astype(np.float64),
        np.eye(3)[GRAD_RNG.integers(0, 3, 5)], {}),
    "shape_layers": lambda: (
        _seq(None, JInputType.feed_forward(6),
             JL.DenseLayer(n_out=12, activation="tanh"),
             JL.ReshapeLayer(target_shape=(3, 4)),
             JL.PermuteLayer(dims=(2, 1)),
             JL.TimeDistributedLayer(inner=JL.DenseLayer(n_out=5,
                                                         activation="tanh")),
             JL.GRU(n_out=4, activation="tanh"),
             JL.GlobalPoolingLayer(pooling_type="avg"),
             JL.OutputLayer(n_out=2, activation="softmax", loss="mcxent")),
        GRAD_RNG.normal(size=(3, 6)),
        np.eye(2)[GRAD_RNG.integers(0, 2, 3)], {}),
    "layernorm": lambda: (
        (JNNC.builder().seed(3).updater("sgd", learning_rate=0.1)
         .weight_init("xavier").list()
         .layer(JL.DenseLayer(n_out=8, activation="tanh"))
         .layer(JL.LayerNormalization())
         .layer(JL.OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
         .set_input_type(JInputType.feed_forward(5)).build()),
        GRAD_RNG.normal(size=(6, 5)),
        np.eye(3)[GRAD_RNG.integers(0, 3, 6)], {}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradient_check_passes_where_the_jax_check_passes(case):
    conf, x, y, kw = GRAD_CASES[case]()
    jnet = JNet(conf).init()
    pnet = _port(jnet)
    want = JCheck.check_gradients(jnet, x, y, subset=24, **kw)
    assert GradientCheckUtil.check_gradients(pnet, x, y, subset=24,
                                             **kw) == want
    assert want


@pytest.mark.parametrize("case", ["dense_mse_tanh", "lstm"])
def test_gradient_check_fails_where_the_jax_check_fails(case):
    """A coarse epsilon against a tight tolerance: both checks fail."""
    conf, x, y, kw = GRAD_CASES[case]()
    jnet = JNet(conf).init()
    pnet = _port(jnet)
    loose = dict(kw, subset=8, epsilon=0.5, max_rel_error=1e-9,
                 min_abs_error=0.0)
    assert not JCheck.check_gradients(jnet, x, y, **loose)
    assert not GradientCheckUtil.check_gradients(pnet, x, y, **loose)


# ---------------------------------------------------------------------------
# the slice as a whole: a Keras LSTM imported, frozen, fine-tuned
# ---------------------------------------------------------------------------

def test_keras_lstm_fine_tuned_under_early_stopping_as_in_jax(tmp_path):
    V, H = 12, 16
    path = tmp_path / "twin.h5"
    chip_smoke.write_keras_char_rnn(path, V, H, 2, seed=5)
    jbase = JImport.import_keras_model_and_weights(str(path))
    pbase = KerasModelImport.import_keras_model_and_weights(str(path),
                                                            device="cpu")
    assert _flat(pbase).tobytes() == _flat(jbase).tobytes()

    def transfer(pkg_tl, base):
        return (pkg_tl.TransferLearning.builder(base)
                .fine_tune_configuration(pkg_tl.FineTuneConfiguration(
                    updater="adam", learning_rate=1e-3))
                .set_feature_extractor(0).build())
    import deeplearning4j_tpu_torch.nn.transferlearning as ptl
    jnet, pnet = transfer(jtl, jbase), transfer(ptl, pbase)
    _same_conf(jnet, pnet)
    rng = np.random.default_rng(3)
    data = [np.eye(V, dtype=np.float32)[rng.integers(0, V, (4, 9))]
            for _ in range(5)]
    batches = [(d[:, :-1], d[:, 1:]) for d in data]
    train, held = batches[:3], batches[3:]
    frozen = {k: t.clone() for k, t in pnet.params[0].items()}
    jres = jes.EarlyStoppingTrainer(
        _es_config(jes, JList([JDataSet(*b) for b in held]),
                   [jes.MaxEpochsTerminationCondition(2)]),
        jnet, JList([JDataSet(*b) for b in train])).fit()
    pres = pes.EarlyStoppingTrainer(
        _es_config(pes, ListDataSetIterator([DataSet(*b) for b in held]),
                   [pes.MaxEpochsTerminationCondition(2)]),
        pnet, ListDataSetIterator([DataSet(*b) for b in train])).fit()
    _results_equal(jres, pres)
    assert all(pnet.params[0][k].equal(frozen[k]) for k in frozen)
    np.testing.assert_allclose(_flat(pnet), _flat(jnet), rtol=P_RTOL,
                               atol=P_ATOL)
