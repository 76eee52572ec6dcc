"""The port's autotuner (``deeplearning4j_tpu_torch/autotune/``) against
the JAX package's, on the CPU: the counterparts of the 23 cases of
``tests/test_autotune.py`` on the same small net and ``fake_probe``; the
search space, the config-only census with ``predict`` under
``Hardware.reference()`` and the analytic ranking held to the JAX
package's (lists equal, floats to 1e-12 relative); ``TunedConfig`` JSON
crossing both ways; and, over one group of two gloo ranks
(``tests/torch_parallel_worker.py``), real probes at dp = 2 whose tuned
trainer is bitwise the hand-built one on both ranks, which return equal
``TunedConfig`` dicts.
"""

import json
import math

import numpy as np
import pytest

import torch_parallel_worker as W
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.analysis import fixtures
from deeplearning4j_tpu.autotune import TunedConfig as JTunedConfig
from deeplearning4j_tpu.autotune import model as jmodel
from deeplearning4j_tpu.autotune import space as jspace
from deeplearning4j_tpu.autotune import tuner as jtuner
from deeplearning4j_tpu.autotune.config import ProbeRecord as JProbeRecord
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput

from deeplearning4j_tpu_torch.autotune import (
    AutotuneError, Candidate, TunedConfig, autotune, default_candidate,
    enumerate_space, mesh_shapes, serve_bucket_set,
)
from deeplearning4j_tpu_torch.autotune import model as pmodel
from deeplearning4j_tpu_torch.autotune import tuner as ptuner
from deeplearning4j_tpu_torch.autotune.config import ProbeRecord
from deeplearning4j_tpu_torch.autotune.probe import synthesize_batch
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def small_conf(seed=7):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(16))
            .build())


def jax_small_conf(seed=7):
    return (JConf.builder().seed(seed)
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(JDense(n_out=32, activation="relu"))
            .layer(JOutput(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(16))
            .build())


def small_net(seed=7):
    return MultiLayerNetwork(small_conf(seed), device="cpu").init()


def fake_probe(net, candidate, batch, steps=3, warmup=1, devices=None):
    """The JAX test's measurement stub: a value from the candidate's shape
    alone, so two searches see the same measurements."""
    base = (candidate.dp * 1.0 + candidate.tp * 2.0 + candidate.sp * 3.0
            + candidate.gradient_accumulation * 0.25
            + (0.5 if candidate.weight_update_sharding != "off" else 0.0)
            + (0.5 if candidate.precision != "fp32" else 0.0))
    return {"measured_step_s": 1e-4 * base, "compile_s": 0.0,
            "losses": [0.0]}


def as_tuples(cands):
    return [(c.dp, c.tp, c.pp, c.sp, c.gradient_accumulation, c.precision,
             c.weight_update_sharding) for c in cands]


# ---------------------------------------------------------------- space

def test_mesh_shapes_cover_exact_device_count():
    shapes = mesh_shapes(8)
    assert all(d * t * p * s == 8 for d, t, p, s in shapes)
    assert (8, 1, 1, 1) in shapes and (1, 8, 1, 1) in shapes
    assert (2, 2, 2, 1) in shapes
    assert len(set(shapes)) == len(shapes)
    for n in range(1, 13):
        assert mesh_shapes(n) == jspace.mesh_shapes(n)


def test_enumerate_space_structural_constraints():
    cands = list(enumerate_space(4, 12, accum_choices=(1, 2, 4, 5)))
    assert cands and all(c.devices == 4 for c in cands)
    assert all(c.gradient_accumulation != 5 for c in cands)
    for n, b in ((4, 12), (8, 64), (2, 9), (1, 32)):
        assert as_tuples(enumerate_space(n, b)) \
            == as_tuples(jspace.enumerate_space(n, b))


def test_default_candidate_and_buckets():
    assert default_candidate(8, 64) == Candidate(dp=8)
    assert default_candidate(8, 63) == Candidate(dp=1)  # indivisible
    assert serve_bucket_set(16) == (1, 2, 4, 8, 16)
    assert serve_bucket_set(48) == (1, 2, 4, 8, 16, 32)  # pow2 floor
    assert max(serve_bucket_set(10_000)) == 128          # capped
    for n, b in ((8, 64), (8, 63), (2, 16), (3, 0)):
        assert as_tuples([default_candidate(n, b)]) \
            == as_tuples([jspace.default_candidate(n, b)])
    for b in (0, 1, 5, 16, 48, 129, 10_000):
        assert serve_bucket_set(b) == jspace.serve_bucket_set(b)
    assert Candidate(dp=2, tp=2, precision="bf16").slug() \
        == jspace.Candidate(dp=2, tp=2, precision="bf16").slug()


# ---------------------------------------------- the cost model vs the JAX one

def port_conf(jconf):
    return MultiLayerConfiguration.from_json(jconf.to_json())


@pytest.mark.parametrize("name", ["small", "good_mlp"])
def test_census_and_predict_are_the_jax_packages(name):
    """``census_from_conf`` and ``predict`` under ``Hardware.reference()``
    give the JAX package's floats (1e-12 relative) on the same config,
    for every candidate of an 8-rank space."""
    jconf = jax_small_conf() if name == "small" else fixtures.good_mlp()[0]
    jc = jmodel.census_from_conf(jconf)
    pc = pmodel.census_from_conf(port_conf(jconf))
    assert pc.param_count == jc.param_count
    assert pc.flops_per_example == jc.flops_per_example
    assert pc.activation_elems_per_example \
        == jc.activation_elems_per_example
    assert (pc.has_attention, pc.n_layers, pc.updater, pc.mem_dtype) \
        == (jc.has_attention, jc.n_layers, jc.updater, jc.mem_dtype)
    jhw, phw = jmodel.Hardware.reference(), pmodel.Hardware.reference()
    for cand in jspace.enumerate_space(8, 64):
        pcand = Candidate(**{k: getattr(cand, k) for k in (
            "dp", "tp", "pp", "sp", "gradient_accumulation", "precision",
            "weight_update_sharding")})
        want = jmodel.predict(jc, cand, 64, hardware=jhw)
        got = pmodel.predict(pc, pcand, 64, hardware=phw)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), (cand, k)


def test_analytic_search_ranks_the_same():
    jconf = fixtures.good_mlp()[0]
    jc = jmodel.census_from_conf(jconf)
    pc = pmodel.census_from_conf(port_conf(jconf))
    want, jcount = jtuner.analytic_search(
        jc, 8, 64, hardware=jmodel.Hardware.reference())
    got, pcount = ptuner.analytic_search(
        pc, 8, 64, hardware=pmodel.Hardware.reference())
    assert as_tuples([c for c, _ in got]) == as_tuples([c for c, _ in want])
    assert pcount == jcount
    jbest = jtuner.analytic_best(jc, 8, 64,
                                 hardware=jmodel.Hardware.reference())
    pbest = ptuner.analytic_best(pc, 8, 64,
                                 hardware=pmodel.Hardware.reference())
    assert pbest[0].slug() == jbest[0].slug()


def test_hardware_detect_without_a_card_is_the_cpu_profile():
    hw = pmodel.Hardware.detect()
    assert (hw.peak_flops, hw.ici_bytes_per_s, hw.is_accelerator,
            hw.device_kind) == (1e12, 50e9, False, "cpu")
    assert pmodel.H100_F32_FRACTION == pytest.approx(494.7 / 3 / 989.4)
    card = pmodel.Hardware(peak_flops=989.4e12, ici_bytes_per_s=1e9,
                           device_kind="NVIDIA H100 80GB HBM3",
                           fp32_fraction=pmodel.H100_F32_FRACTION)
    assert card.matmul_fraction("bf16") == 1.0
    assert card.matmul_fraction("fp32") == pmodel.H100_F32_FRACTION


# ------------------------------------------------------------ the search

def test_autotune_deterministic_with_fixed_measurements():
    t1 = autotune(small_net(), devices=2, global_batch=16, top_k=3,
                  probe_fn=fake_probe)
    t2 = autotune(small_net(), devices=2, global_batch=16, top_k=3,
                  probe_fn=fake_probe)
    assert t1.to_dict() == t2.to_dict()


def test_autotune_analytic_only_deterministic():
    t1 = autotune(small_net(), devices=2, global_batch=16, top_k=0)
    t2 = autotune(small_net(), devices=2, global_batch=16, top_k=0)
    assert t1.to_dict() == t2.to_dict()
    assert t1.measured_step_s is None
    assert t1.measured_vs_predicted_gap is None


def test_pruning_illegal_configs_never_probed():
    probed = []

    def spy(net, cand, batch, **kw):
        probed.append(cand)
        return fake_probe(net, cand, batch, **kw)

    tuned = autotune(small_net(), devices=2, global_batch=9, top_k=4,
                     probe_fn=spy)
    assert probed, "search probed nothing"
    assert all(c.dp == 1 for c in probed)
    assert all(c.weight_update_sharding == "off" for c in probed)
    assert tuned.dp == 1
    assert tuned.search["pruned_illegal"] > 0


def test_pruning_hbm_budget():
    with pytest.raises(AutotuneError):
        autotune(small_net(), devices=2, global_batch=16, hbm_budget=1,
                 top_k=0)
    tuned = autotune(small_net(), devices=2, global_batch=16,
                     hbm_budget=1 << 30, top_k=0)
    assert tuned.search["pruned_hbm"] == 0
    assert tuned.predicted_hbm_bytes is not None
    assert tuned.predicted_hbm_bytes <= 1 << 30


def test_winner_measured_no_slower_than_default():
    """Real probes at world 1 (no group): the default is probed, the
    winner measures no slower, every gap is finite."""
    tuned = autotune(small_net(), global_batch=16, top_k=2, probe_steps=2)
    by_cfg = {p.config: p for p in tuned.probes}
    default = default_candidate(1, 16)
    assert default.slug() in by_cfg, "default config must be probed"
    assert tuned.search["probes"] == len(tuned.probes) >= 2
    assert tuned.measured_step_s <= by_cfg[default.slug()].measured_step_s
    for p in tuned.probes:
        assert math.isfinite(p.measured_vs_predicted_gap)
        assert p.measured_vs_predicted_gap > 0


def test_a_probe_wider_than_the_group_is_skipped_naming_the_world(caplog):
    """``devices=2`` without a group: the analytic search plans for two
    ranks, each real probe raises naming the world (1) and is skipped
    with its exception in the warning, and the analytic winner ships."""
    import logging
    with caplog.at_level(logging.WARNING,
                         logger="deeplearning4j_tpu_torch.autotune.tuner"):
        tuned = autotune(small_net(), devices=2, global_batch=16, top_k=1,
                         probe_steps=1)
    assert tuned.probes == [] and tuned.search["probes"] == 0
    assert any("process group has world 1" in r.message
               for r in caplog.records)


def test_probe_parity_tuned_equals_hand_built_bitwise():
    from deeplearning4j_tpu_torch.parallel import (
        MeshContext, ParallelTrainer,
    )
    tuned = autotune(small_net(), global_batch=16, top_k=1, probe_steps=1)
    ds = synthesize_batch(small_conf(), 16)

    def run(build):
        fresh = small_net()
        trainer = build(fresh)
        losses = [float(trainer.fit_batch(ds)) for _ in range(3)]
        return losses, fresh.params_flat()

    losses_t, params_t = run(lambda n: tuned.trainer(n))
    losses_h, params_h = run(lambda n: ParallelTrainer(
        n, MeshContext.create(n_data=tuned.dp, n_model=tuned.tp,
                              n_seq=tuned.sp, device="cpu"),
        **tuned.trainer_kwargs()))
    assert [np.float32(x).tobytes() for x in losses_t] \
        == [np.float32(x).tobytes() for x in losses_h]
    assert params_t.tobytes() == params_h.tobytes()


# ------------------------------------------------------------ TunedConfig

def full_tuned(cls=TunedConfig, rec=ProbeRecord):
    return cls(
        dp=4, tp=2, gradient_accumulation=2, precision="bf16",
        weight_update_sharding="zero2", global_batch=64, device_count=8,
        hbm_budget_bytes=1 << 34, serve_buckets=(1, 2, 4, 8),
        predicted_step_s=1e-3, measured_step_s=2e-3,
        measured_vs_predicted_gap=2.0, predicted_hbm_bytes=123,
        predicted_mfu=0.5,
        probes=[rec("dp4_tp2_ga2_bf16_zero2", 1e-3, 2e-3, 2.0, 0.1)],
        search={"candidates": 10, "pruned_illegal": 2})


def test_tuned_config_json_round_trip():
    tuned = full_tuned()
    rt = TunedConfig.from_json(tuned.to_json())
    assert rt == tuned
    assert rt.to_dict() == tuned.to_dict()
    d = json.loads(tuned.to_json())
    assert d["format"] == TunedConfig.FORMAT
    with pytest.raises(ValueError):
        TunedConfig.from_dict(dict(d, format="TunedConfig.v999"))


def test_tuned_config_json_crosses_both_packages(tmp_path):
    """A JAX-written TunedConfig loads in the port and compares equal, and
    the port's loads in the JAX package: the same JSON text both ways."""
    jt = full_tuned(JTunedConfig, JProbeRecord)
    path = str(tmp_path / "jax.json")
    jt.save(path)
    assert TunedConfig.load(path) == full_tuned()
    assert TunedConfig.load(path).to_json() == jt.to_json()
    full_tuned().save(str(tmp_path / "port.json"))
    assert JTunedConfig.load(str(tmp_path / "port.json")) == jt


def test_tuned_config_save_load_atomic(tmp_path):
    tuned = TunedConfig(dp=2, global_batch=16, device_count=2)
    path = str(tmp_path / "tuned.json")
    tuned.save(path)
    assert TunedConfig.load(path) == tuned
    assert [p.name for p in tmp_path.iterdir()] == ["tuned.json"]


def test_tuned_config_pp_refuses_flat_mesh():
    with pytest.raises(ValueError):
        TunedConfig(pp=2).mesh_context(device="cpu")


# ------------------------------------------------- consumers accept tuned=

def test_parallel_trainer_accepts_tuned():
    """At world 1 (the dp = 2 case runs in the worker group,
    ``tests/test_torch_parallel.py``)."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    tuned = TunedConfig(gradient_accumulation=2, precision="bf16",
                        global_batch=16)
    tr = ParallelTrainer(small_net(), tuned=tuned)
    assert tr.mesh.n_data == 1
    assert tr.gradient_accumulation == 2
    assert tr.weight_update_sharding.mode == "off"
    assert tr.precision.compute_dtype == "bfloat16"
    tr2 = ParallelTrainer(small_net(), tuned=tuned, precision="fp32",
                          gradient_accumulation=4)
    assert tr2.precision.compute_dtype == "float32"
    assert tr2.gradient_accumulation == 4


def test_parallel_wrapper_accepts_tuned():
    from deeplearning4j_tpu_torch.parallel import MeshContext
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    tuned = TunedConfig(dp=2, gradient_accumulation=3, global_batch=16,
                        device_count=2)
    pw = ParallelWrapper(small_net(), tuned=tuned,
                         mesh=MeshContext.create(device="cpu"))
    assert pw.workers == 2
    assert pw.averaging_frequency == 3


def test_data_parallel_trainer_accepts_tuned():
    from deeplearning4j_tpu_torch.parallel import multihost
    tuned = TunedConfig(gradient_accumulation=2, global_batch=32,
                        device_count=8)
    tr = multihost.data_parallel_trainer(small_net(), tuned=tuned)
    assert tr.gradient_accumulation == 2
    assert tr.mesh.n_data == 1
    with pytest.raises(ValueError, match="pp=2"):
        multihost.data_parallel_trainer(
            small_net(), tuned=TunedConfig(dp=2, pp=2, device_count=4))


def test_autotune_rejects_batch_size_mismatch():
    with pytest.raises(AutotuneError):
        autotune(small_net(), devices=2,
                 batch=synthesize_batch(small_conf(), 16),
                 global_batch=64, top_k=0)


def test_keras_server_accepts_tuned():
    from deeplearning4j_tpu_torch.keras.server import KerasServer
    tuned = TunedConfig(dp=2, global_batch=16, device_count=2,
                        serve_buckets=(1, 2, 4, 8))
    srv = KerasServer(tuned=tuned, device="cpu")
    try:
        assert srv._batcher.max_batch == 8
    finally:
        srv.stop()


# ------------------------------------------------------------------ GC016

def test_gc016_warns_on_mistuned_config():
    from deeplearning4j_tpu_torch.analysis.graphcheck import validate_config
    conf = port_conf(fixtures.good_mlp()[0])
    findings = validate_config(conf, mesh={"dp": 1}, batch_size=64,
                               autotune_devices=8)
    assert any(f.rule == "GC016" for f in findings)


def test_gc016_quiet_without_device_count_and_when_tuned():
    from deeplearning4j_tpu_torch.analysis.graphcheck import validate_config
    conf = port_conf(fixtures.good_mlp()[0])
    assert not any(f.rule == "GC016" for f in validate_config(
        conf, mesh={"dp": 1}, batch_size=64))
    assert not any(f.rule == "GC016" for f in validate_config(
        conf, mesh={"dp": 8}, batch_size=256, autotune_devices=8))


# ------------------------------------------------------------ observability

def test_autotune_metrics_exported():
    from deeplearning4j_tpu_torch.profiling.metrics import get_registry
    before = dict(get_registry().snapshot("autotune_"))
    tuned = autotune(small_net(), devices=2, global_batch=16, top_k=2,
                     probe_fn=fake_probe)
    snap = get_registry().snapshot("autotune_")
    assert snap["autotune_searches_total"] \
        == before.get("autotune_searches_total", 0) + 1
    assert snap["autotune_probes_total"] \
        >= before.get("autotune_probes_total", 0) + len(tuned.probes)
    assert math.isfinite(snap["autotune_measured_vs_predicted_gap"])
    for p in tuned.probes:
        assert f"autotune_gap_{p.config}" in snap


# ------------------------------------------------- cost census memoization

def test_param_census_memoized_on_net_identity():
    from deeplearning4j_tpu_torch.profiling import cost
    net = small_net()
    c1 = cost.param_census(net)
    assert cost.param_census(net) is c1
    other = small_net()
    assert cost.param_census(other) is not c1
    assert cost.param_census(other) == c1


def test_train_step_cost_memoized_on_batch_signature():
    from deeplearning4j_tpu_torch.profiling import cost
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        DivergenceSentinel,
    )
    net = small_net()
    ds = synthesize_batch(small_conf(), 16)
    c1 = cost.train_step_cost(net, ds)
    c2 = cost.train_step_cost(net, ds)
    assert c2 == c1 and c2 is not c1
    key, results = cost._STEP_COST[net]
    assert key == cost._step_key(net) and results
    c1["flops_per_step"] = -1.0
    assert cost.train_step_cost(net, ds)["flops_per_step"] != -1.0
    c3 = cost.train_step_cost(net, synthesize_batch(small_conf(), 8))
    assert c3["batch"] == 8
    assert len(cost._STEP_COST[net][1]) == 2
    # a rebuilt step (a sentinel attached) drops every cached count
    net.set_divergence_sentinel(DivergenceSentinel("skip_batch"))
    cost.train_step_cost(net, ds)
    assert len(cost._STEP_COST[net][1]) == 1


def test_weight_update_cost_uses_census():
    from deeplearning4j_tpu_torch.profiling import cost
    net = small_net()
    wuc = cost.weight_update_cost(net, dp=2, weight_update_sharding="zero1")
    assert wuc["comm_bytes_per_step"] == cost.dp_comm_bytes_per_update(
        net.num_params(), 2, 4, 1, "zero1")


# ----------------------------------------------- dp = 2 over a gloo group

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    cases = [dict(name="autotune", fn="autotune",
                  args=dict(conf=small_conf().to_json()))]
    return W.run_group(cases, tmp_path_factory.mktemp("autotune"), world=2)


def test_ranks_agree_and_the_tuned_trainer_is_the_hand_built_one(group):
    """Real probes over two ranks: each rank's seconds reduced to their
    maximum, both ranks return the same TunedConfig (the default dp = 2
    probed among them), and its trainer trains bitwise the hand-built
    one on both ranks."""
    r0, r1 = (W.result(group, "autotune", r) for r in range(2))
    assert r0["tuned"] == r1["tuned"]
    t = r0["tuned"]
    assert t["device_count"] == 2 and t["search"]["probes"] >= 1
    assert "dp2_ga1_fp32_off" in {p["config"] for p in t["probes"]}
    for r in (r0, r1):
        assert r["tuned_run"][0] == r["hand_run"][0]
        assert r["tuned_run"][1].tobytes() == r["hand_run"][1].tobytes()
