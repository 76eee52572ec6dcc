"""The port's static analysis (``analysis/graphcheck.py``,
``analysis/memory.py``, ``analysis/findings.py`` and the configs'
``validate()`` / ``memory_report()`` hooks, ROADMAP A7.3) against the
JAX package's, on the CPU.

Every graphcheck fixture of ``deeplearning4j_tpu/analysis/fixtures.py``
(``KNOWN_BAD`` and ``KNOWN_GOOD``) is built by the JAX package, carried
to the port through its JSON (``load_config_dict`` for a graph built
without its builder, ``from_json`` for the rest) and validated by both
with the same arguments (a JAX iterator becomes the port's, or an object
with ``attach``): the findings' (rule, severity, location) lists are
equal, the GC016 fixtures' too (the autotuner's analytic verdict at
``autotune_devices=``). ``memory_report`` equals the JAX package's on every
``KNOWN_GOOD`` config, each byte field, entry and KV field as an exact
integer; so do ``kv_pool_plan`` and ``kv_cache_bytes``. The cases of
``tests/test_graphcheck.py`` follow on the port's own configs (the JAX
``Mesh`` case as a ``MeshContext`` one), then the ZeRO and KV cases of
``test_zero1.py``, ``test_zero2.py`` and ``test_generation.py`` (the
last against the port's serving engine on ``gpt_tiny``), and the CLI's
file mode.
"""

import json
import threading

import pytest

from deeplearning4j_tpu.analysis import fixtures
from deeplearning4j_tpu.analysis import memory as jmemory
from deeplearning4j_tpu.analysis.graphcheck import (
    validate_config as jvalidate,
)

import deeplearning4j_tpu_torch.parallel.expert  # noqa: F401 (MoELayer)
from deeplearning4j_tpu_torch.analysis import (
    check_graph, check_multilayer, memory_report, validate_config,
)
from deeplearning4j_tpu_torch.analysis import graphcheck, memory
from deeplearning4j_tpu_torch.analysis.findings import (
    Severity, has_errors, max_severity,
)
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration, NodeConf,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.parallel.expert import MoELayer


# ---------------------------------------------------------------------------
# carrying a JAX fixture to the port
# ---------------------------------------------------------------------------

def graph_dict(conf) -> dict:
    """A JAX graph config's dict, its nodes in definition order where no
    builder ordered them (``to_dict`` lists the topological order)."""
    d = conf.to_dict()
    if not conf.topological_order:
        d["nodes"] = []
        for n in conf.nodes.values():
            nd = {"name": n.name, "kind": n.kind, "inputs": list(n.inputs)}
            if n.layer is not None:
                nd["layer"] = n.layer.to_dict()
            if n.vertex is not None:
                nd["vertex"] = n.vertex.to_dict()
            if n.preprocessor is not None:
                nd["preprocessor"] = n.preprocessor.to_dict()
            d["nodes"].append(nd)
    return json.loads(json.dumps(d))


def port_conf(conf):
    """The port's config of the JAX ``conf``, through its JSON."""
    if hasattr(conf, "nodes"):
        if not conf.topological_order:
            return graphcheck.load_config_dict(graph_dict(conf))
        return ComputationGraphConfiguration.from_json(conf.to_json())
    return MultiLayerConfiguration.from_json(conf.to_json())


class _Attached:
    """An iterator the trainers bind to their mesh (GC013's clean side)."""

    def attach(self, *_):
        pass


def port_kwargs(kw: dict) -> dict:
    """The JAX fixture's validate kwargs for the port: a JAX input
    iterator becomes the port's list iterator, or an object with
    ``attach`` where the JAX one shards its sources."""
    kw = dict(kw)
    it = kw.get("input_iterator")
    if it is not None:
        if hasattr(it, "attach") or getattr(it, "places_sharded", False):
            kw["input_iterator"] = _Attached()
        else:
            from deeplearning4j_tpu_torch.datasets.iterator import (
                ListDataSetIterator,
            )
            kw["input_iterator"] = ListDataSetIterator([])
    return kw


def triples(findings):
    return [(f.rule, f.severity, f.location) for f in findings]


def assert_same_findings(conf, kw):
    want = triples(jvalidate(conf, **kw))
    port = port_conf(conf)
    got = validate_config(port, **port_kwargs(kw))
    assert triples(got) == want
    for f in got:
        assert f.message and f.hint
    return got


@pytest.mark.parametrize("name,rule,make", fixtures.KNOWN_BAD,
                         ids=[n for n, _, _ in fixtures.KNOWN_BAD])
def test_known_bad_findings_equal_the_jax_packages(name, rule, make):
    conf, kw = make()
    got = assert_same_findings(conf, kw)
    assert rule in {f.rule for f in got}


@pytest.mark.parametrize("name,make", fixtures.KNOWN_GOOD,
                         ids=[n for n, _ in fixtures.KNOWN_GOOD])
def test_known_good_validates_clean_as_in_the_jax_package(name, make):
    conf, kw = make()
    assert assert_same_findings(conf, kw) == []


# ---------------------------------------------------------------------------
# memory_report / kv_pool_plan / kv_cache_bytes against the JAX package's
# ---------------------------------------------------------------------------

BYTE_FIELDS = ("total_params", "param_bytes", "updater_state_bytes",
               "updater_state_shards", "gradient_bytes", "gradient_shards",
               "activation_bytes", "total_hbm_bytes",
               "peak_layer_working_set_bytes", "kv_cache_total_bytes",
               "kv_page_len", "kv_pages_total", "kv_pages_per_row")


def report_fields(rep) -> dict:
    out = {k: getattr(rep, k) for k in BYTE_FIELDS}
    out["entries"] = [(e.name, e.layer_type, e.n_params,
                       tuple(e.activation_shape), e.activation_elems)
                      for e in rep.entries]
    return out


@pytest.mark.parametrize("name,make", fixtures.KNOWN_GOOD,
                         ids=[n for n, _ in fixtures.KNOWN_GOOD])
def test_memory_report_equals_the_jax_packages(name, make):
    conf, kw = make()
    dp = (kw.get("mesh") or {}).get("dp", 1)
    # the KV term of a graph (on a stack the JAX package's decode-length
    # walk raises; the port's finds no decoder)
    args = dict(batch_size=kw.get("batch_size", 32), dp=dp,
                decode_rows=8 if hasattr(conf, "nodes") else 0,
                weight_update_sharding=kw.get("weight_update_sharding",
                                              "off"))
    want = report_fields(jmemory.memory_report(conf, **args))
    got = memory_report(port_conf(conf), **args)
    assert report_fields(got) == want
    assert got.total_params > 0


@pytest.mark.parametrize("budget", [None, 3000, 10 ** 6])
def test_kv_pool_plan_and_cache_bytes_equal_the_jax_packages(budget):
    from deeplearning4j_tpu.models.gpt import gpt_tiny
    conf = gpt_tiny(vocab_size=16, seq_len=8, n_layers=2)
    port = port_conf(conf)
    want = jmemory.kv_pool_plan(conf, 8, budget_bytes=budget)
    got = memory.kv_pool_plan(port, 8, budget_bytes=budget)
    for k in ("page_len", "pages_per_row", "page_group_bytes", "pages",
              "total_pages", "total_bytes"):
        assert getattr(got, k) == getattr(want, k), k
    for rows, pages, pl in ((8, None, None), (3, None, 4), (0, 5, None)):
        assert memory.kv_cache_bytes(port, rows, page_len=pl, pages=pages) \
            == jmemory.kv_cache_bytes(conf, rows, page_len=pl, pages=pages)
    assert memory.kv_page_group_bytes(port) == \
        jmemory.kv_page_group_bytes(conf)


def test_kv_pool_plan_refuses_what_the_engine_refuses():
    conf, _ = fixtures.good_mlp()
    port = port_conf(conf)
    with pytest.raises(ValueError, match="no causal attention"):
        memory.kv_pool_plan(port, 4)
    assert memory.kv_cache_bytes(port, 4) == 0
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    gpt = gpt_tiny(vocab_size=16, seq_len=8)
    with pytest.raises(ValueError, match="cannot hold even one"):
        memory.kv_pool_plan(gpt, 4, budget_bytes=1)
    with pytest.raises(ValueError, match="must divide"):
        memory.kv_pool_plan(gpt, 4, page_len=3)


def test_param_shapes_allocate_nothing():
    conf, _ = fixtures.good_mlp()
    port = port_conf(conf)
    shapes = memory.param_shapes(port.layers[0])
    assert shapes == {"W": (784, 256), "b": (256,)}
    assert memory.DEFAULT_HBM_BYTES == 85_017_493_504
    rep = memory_report(port, batch_size=64)
    assert rep.vmem_pressure() == \
        rep.peak_layer_working_set_bytes / memory.L2_BYTES


# ---------------------------------------------------------------------------
# the cases of tests/test_graphcheck.py, on the port's configs
# ---------------------------------------------------------------------------

def mlp():
    return (NeuralNetConfiguration.builder()
            .seed(12345).updater("adam", learning_rate=1e-3)
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=256, activation="relu"))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())


def test_shape_mismatch_is_error_with_location():
    conf = MultiLayerConfiguration(layers=[
        DenseLayer(n_in=784, n_out=256, activation="relu"),
        DenseLayer(n_in=128, n_out=64, activation="relu"),
        OutputLayer(n_in=64, n_out=10, activation="softmax", loss="mcxent"),
    ])
    f = next(f for f in check_multilayer(conf) if f.rule == "GC005")
    assert f.severity == Severity.ERROR
    assert "layer[1]" in f.location
    assert "256" in f.message


def _graph(nodes, n_in=8):
    return ComputationGraphConfiguration(
        nodes=nodes, network_inputs=["in"], network_outputs=["out"],
        input_types={"in": InputType.feed_forward(n_in)})


def _dense(name, inputs, n_out=8):
    return NodeConf(name=name, kind="layer", inputs=inputs,
                    layer=DenseLayer(n_in=8, n_out=n_out, activation="relu"))


def _out(inputs):
    return NodeConf(name="out", kind="layer", inputs=inputs,
                    layer=OutputLayer(n_in=8, n_out=2,
                                      activation="softmax"))


def test_cycle_names_participants():
    conf = _graph({"in": NodeConf(name="in", kind="input"),
                   "a": _dense("a", ["c"]), "b": _dense("b", ["a"]),
                   "c": _dense("c", ["b"]), "out": _out(["c"])})
    f = next(f for f in check_graph(conf) if f.rule == "GC002")
    assert {"a", "b", "c"} <= set(f.location.split(","))


def test_dead_vertex_warning():
    conf = _graph({"in": NodeConf(name="in", kind="input"),
                   "used": _dense("used", ["in"]),
                   "orphan": _dense("orphan", ["in"], n_out=4),
                   "out": _out(["used"])})
    f = next(f for f in check_graph(conf) if f.rule == "GC004")
    assert f.severity == Severity.WARNING
    assert f.location == "orphan"


def test_duplicate_layer_names_flagged():
    conf = MultiLayerConfiguration(layers=[
        DenseLayer(name="h", n_in=8, n_out=8, activation="relu"),
        DenseLayer(name="h", n_in=8, n_out=8, activation="relu"),
        OutputLayer(n_in=8, n_out=2, activation="softmax"),
    ])
    assert any(f.rule == "GC001" for f in check_multilayer(conf))


def test_missing_loss_head_is_warning_only():
    conf = (NeuralNetConfiguration.builder().list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(DenseLayer(n_out=4, activation="relu"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    findings = conf.validate()
    assert [f.rule for f in findings] == ["GC006"]
    assert max_severity(findings) == Severity.WARNING
    assert not has_errors(findings)


def test_moe_expert_mesh_mismatch():
    def conf(n_experts):
        return (NeuralNetConfiguration.builder().list()
                .layer(MoELayer(n_experts=n_experts, hidden=16))
                .layer(OutputLayer(n_out=2, activation="softmax"))
                .set_input_type(InputType.feed_forward(8))
                .build())
    findings = conf(6).validate(mesh={"ep": 4}, batch_size=32)
    assert any(f.rule == "GC010" and f.severity == Severity.ERROR
               for f in findings)
    assert conf(8).validate(mesh={"ep": 4}, batch_size=32) == []


def test_mesh_accepts_the_ports_mesh_context():
    from deeplearning4j_tpu_torch.parallel import MeshContext
    mesh = MeshContext(world=8, rank=0)
    assert graphcheck._mesh_axes(mesh) == {"data": 8, "model": 1, "sp": 1,
                                           "pp": 1, "ep": 1}
    conf = mlp()
    assert check_multilayer(conf, mesh=mesh, batch_size=64) == []
    assert any(f.rule == "GC008"
               for f in check_multilayer(conf, mesh=mesh, batch_size=33))
    sp = MeshContext(world=8, rank=0, n_seq=2)
    assert triples(check_multilayer(conf, mesh=sp, batch_size=64)) == \
        triples(check_multilayer(conf, mesh={"dp": 4, "sp": 2},
                                 batch_size=64))
    with pytest.raises(TypeError, match="Unsupported mesh"):
        check_multilayer(conf, mesh=object())


def test_precision_policy_instance_carries_its_own_loss_scale():
    """GC015 on the port's ``PrecisionPolicy``: an instance's own loss
    scale rules (the config's is not read), as for the JAX policy."""
    from deeplearning4j_tpu_torch.nn.updater import PrecisionPolicy
    conf = mlp()
    conf.training.loss_scale = 1024.0
    assert conf.validate(precision="bf16") == []
    bare = conf.validate(precision=PrecisionPolicy("bfloat16"))
    assert triples(bare) == [("GC015", "warning", "compute=bfloat16")]
    assert conf.validate(precision=PrecisionPolicy(
        "bfloat16", loss_scale=512.0)) == []


def test_pp_more_stages_than_layers_warns():
    findings = mlp().validate(mesh={"pp": 8}, batch_size=32)
    assert any(f.rule == "GC009" for f in findings)


def test_tbptt_non_rnn_head_flagged_on_deserialized_conf():
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        LSTM, RnnOutputLayer,
    )
    conf = (NeuralNetConfiguration.builder().list()
            .layer(LSTM(n_out=32, activation="tanh"))
            .layer(RnnOutputLayer(n_out=5, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(16, 20)).build())
    d = conf.to_dict()
    d["training"]["backprop_type"] = "truncated_bptt"
    d["layers"][-1] = {"@type": "OutputLayer", "n_in": 32, "n_out": 5,
                       "activation": "softmax", "loss": "mcxent"}
    broken = MultiLayerConfiguration.from_dict(d)
    assert any(f.rule == "GC005" and "truncated_bptt" in f.message
               for f in broken.validate())


def test_list_builder_validate_without_build():
    b = (NeuralNetConfiguration.builder().list()
         .layer(DenseLayer(n_out=8, activation="relu"))
         .layer(OutputLayer(n_out=2, activation="softmax"))
         .set_input_type(InputType.feed_forward(4)))
    assert b.validate(mesh={"dp": 2}, batch_size=8) == []
    b2 = NeuralNetConfiguration.builder().list().layer(
        DenseLayer(n_out=8, activation="relu"))
    findings = b2.validate()
    assert findings and findings[0].severity == Severity.ERROR
    assert findings[0].rule == "GC005" and findings[0].location == "<build>"


def test_graph_builder_validate_reports_instead_of_raising():
    gb = (NeuralNetConfiguration.builder().graph_builder()
          .add_inputs("in")
          .set_input_types(InputType.feed_forward(8))
          .add_layer("h", DenseLayer(n_out=8, activation="relu"), "ghost")
          .add_layer("out", OutputLayer(n_out=2, activation="softmax"), "h")
          .set_outputs("out"))
    findings = gb.validate()
    assert any(f.rule == "GC003" for f in findings)
    with pytest.raises(ValueError):
        gb.build()


def test_builder_validate_does_not_freeze_global_defaults():
    nb = NeuralNetConfiguration.builder()
    lb = (nb.list()
          .layer(DenseLayer(n_out=8))
          .layer(OutputLayer(n_out=2, activation="softmax"))
          .set_input_type(InputType.feed_forward(4)))
    assert [f.rule for f in lb.validate()] == []
    nb.activation("tanh").l2(0.01)
    conf = lb.build()
    assert conf.layers[0].activation == "tanh"
    assert conf.layers[0].l2 == 0.01

    gb = (NeuralNetConfiguration.builder()
          .graph_builder().add_inputs("in")
          .set_input_types(InputType.feed_forward(4))
          .add_layer("h", DenseLayer(n_out=8), "in")
          .add_layer("out", OutputLayer(n_out=2, activation="softmax"), "h")
          .set_outputs("out"))
    gb.validate()
    gb._parent.activation("tanh")
    conf = gb.build()
    assert conf.nodes["h"].layer.activation == "tanh"


def merge_graph():
    from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    return (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3).weight_init("xavier")
            .graph_builder()
            .add_inputs("in_a", "in_b")
            .set_input_types(InputType.feed_forward(12),
                             InputType.feed_forward(8))
            .add_layer("da", DenseLayer(n_out=16, activation="relu"),
                       "in_a")
            .add_layer("db", DenseLayer(n_out=16, activation="relu"),
                       "in_b")
            .add_vertex("merge", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "merge")
            .set_outputs("out")
            .build())


def test_serialized_duplicate_node_names_flagged():
    d = merge_graph().to_dict()
    clash = next(n for n in d["nodes"] if n["name"] == "db")
    clash["name"] = "da"
    loaded = graphcheck.load_config_dict(d)
    assert any(f.rule == "GC001" and f.location == "da"
               for f in check_graph(loaded))


def test_memory_report_matches_real_param_count():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = mlp()
    rep = conf.memory_report(batch_size=64)
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert rep.total_params == net.num_params()
    assert rep.param_bytes == sum(t.numel() * t.element_size()
                                  for p in net.params for t in p.values())
    assert rep.total_hbm_bytes > rep.param_bytes
    assert "MemoryReport" in rep.to_text()


def test_memory_report_remat_shrinks_activations():
    conf, _ = fixtures.good_cnn()
    port = port_conf(conf)
    full = memory_report(port, batch_size=128)
    port.training.remat = True
    lean = memory_report(port, batch_size=128)
    assert lean.activation_bytes < full.activation_bytes


def test_nested_wrapper_n_in_mismatch_found_without_mutation():
    from deeplearning4j_tpu_torch.nn.layers.shape import TimeDistributedLayer
    inner = DenseLayer(n_in=999, n_out=8, activation="relu")
    conf = MultiLayerConfiguration(
        layers=[TimeDistributedLayer(inner=inner),
                OutputLayer(n_in=8, n_out=2, activation="softmax")],
        input_type=InputType.recurrent(7, 5))
    findings = check_multilayer(conf)
    assert any(f.rule == "GC005" and "999" in f.message for f in findings)
    assert inner.n_in == 999


def test_lenient_graph_memory_report_keeps_activations():
    conf = merge_graph()
    built = memory_report(conf, batch_size=64)
    lenient = memory_report(graphcheck.load_config_dict(conf.to_dict()),
                            batch_size=64)
    assert built.activation_bytes > 0
    assert lenient.activation_bytes == built.activation_bytes
    assert lenient.total_params == built.total_params
    assert conf.memory_report(batch_size=64).total_hbm_bytes == \
        built.total_hbm_bytes


def test_hbm_overflow_warning():
    findings = check_multilayer(mlp(), batch_size=64, hbm_bytes=1 << 20)
    assert any(f.rule == "GC007" for f in findings)
    assert not any(f.rule == "GC007"
                   for f in check_multilayer(mlp(), batch_size=64))


@pytest.mark.parametrize("widths,batch,want", [
    ([3, 2, 1], 32, [("GC014", "error", "resize dp=3")]),
    ([8], 32, []),
    ([6], 32, [("GC014", "error", "resize dp=6")]),
    ([4], 32, [("GC014", "error", "resize dp=4")]),
    ([2, 1], 64, []),
    (None, 32, []),
])
def test_gc014_resize_plans(widths, batch, want):
    """The GC014 cases of tests/test_graphcheck.py: an indivisible
    surviving width, a grown width (legal when it divides, an error when
    not), the current width as a no-op plan, a clean plan with the sole
    survivor under zero1, and no plan at all."""
    findings = check_multilayer(
        mlp(), mesh={"dp": 4}, batch_size=batch,
        weight_update_sharding="zero1" if batch == 64 else None,
        elastic_resize_widths=widths)
    assert [t for t in triples(findings) if t[0] == "GC014"] == want


def test_gc014_zero1_pad_waste_reevaluated():
    conf, _ = fixtures.bad_zero1_padding()
    findings = check_multilayer(port_conf(conf), mesh={"dp": 8},
                                batch_size=56,
                                weight_update_sharding="zero1",
                                elastic_resize_widths=[7])
    ours = [f for f in findings if f.rule == "GC014"]
    assert len(ours) == 1 and ours[0].severity == Severity.WARNING
    assert "dp=7" in ours[0].location


# ---------------------------------------------------------------------------
# the ZeRO and KV cases of test_zero1 / test_zero2 / test_generation
# ---------------------------------------------------------------------------

def zero_conf():
    return (NeuralNetConfiguration.builder()
            .seed(12345).updater("adam", learning_rate=0.05)
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=17, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())


def test_zero1_memory_report_divides_updater_state():
    conf = zero_conf()
    rep_off = conf.memory_report(batch_size=32)
    rep_z = memory_report(conf, batch_size=32,
                          weight_update_sharding="zero1", dp=8)
    assert rep_off.updater_state_bytes == rep_off.param_bytes * 2
    assert rep_z.updater_state_bytes == -(-rep_off.updater_state_bytes // 8)
    assert "zero1: 1/8 per replica" in rep_z.to_text()


def test_zero2_memory_report_divides_gradients():
    conf = zero_conf()
    rep_off = memory_report(conf, batch_size=32)
    rep_z1 = memory_report(conf, batch_size=32,
                           weight_update_sharding="zero1", dp=8)
    rep_z2 = memory_report(conf, batch_size=32,
                           weight_update_sharding="zero2", dp=8)
    assert rep_z1.gradient_bytes == rep_off.gradient_bytes
    assert rep_z2.gradient_bytes == -(-rep_off.gradient_bytes // 8)
    assert (rep_z2.updater_state_bytes == rep_z1.updater_state_bytes
            == -(-rep_off.updater_state_bytes // 8))
    assert "zero2: 1/8 per replica" in rep_z2.to_text()


VOCAB, SEQ_LEN = 13, 16


@pytest.fixture(scope="module")
def gpt_net():
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return ComputationGraph(gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN),
                            device="cpu").init()


def test_memory_report_kv_term(gpt_net):
    conf = gpt_net.conf
    assert memory.kv_cache_bytes(conf, 8) == gpt_net.decode_cache_bytes(8)
    plan = memory.kv_pool_plan(conf, 8)
    assert plan.page_len == gpt_net.kv_page_len()
    assert plan.pages_per_row * plan.page_len == gpt_net.decode_max_len()
    assert memory.kv_cache_bytes(conf, 0, pages=plan.pages) \
        == gpt_net.decode_cache_bytes(8)
    rep = memory_report(conf, batch_size=4, decode_rows=8)
    assert rep.kv_cache_total_bytes == plan.total_bytes
    assert rep.kv_page_len == plan.page_len
    assert rep.kv_pages_total == plan.total_pages
    assert "page pool" in rep.to_text()
    assert memory_report(conf, batch_size=4).kv_cache_total_bytes == 0


@pytest.mark.parametrize("budget", [None, 6000])
def test_live_engine_pool_matches_report(gpt_net, budget):
    """The port's serving engine allocates the pool ``kv_pool_plan``
    sizes, with and without a byte budget, and publishes its bytes."""
    from deeplearning4j_tpu_torch.keras.generation import (
        GenerationScheduler,
    )
    from deeplearning4j_tpu_torch.models.gpt import greedy_generate
    from deeplearning4j_tpu_torch.profiling.metrics import (
        MetricsRegistry, set_registry,
    )
    from deeplearning4j_tpu_torch.resilience.service import Deadline
    prev = set_registry(MetricsRegistry())
    sched = GenerationScheduler(max_rows=4, cache_budget_bytes=budget)
    try:
        prompt = [1, 2, 3]
        r = sched.submit("m", gpt_net, threading.Lock(), prompt, 3,
                         Deadline(120.0))
        assert r["tokens"] == greedy_generate(gpt_net, prompt, 3)
        plan = memory.kv_pool_plan(gpt_net.conf, sched.max_rows,
                                   budget_bytes=budget)
        eng = sched._engines["m"]
        assert eng.page_len == plan.page_len
        assert eng.usable_pages == plan.pages
        assert eng.total_pages == plan.total_pages
        assert eng.pool_bytes == plan.total_bytes
        assert sum(v.numel() * v.element_size()
                   for kv in eng.pool.values()
                   for v in kv.values()) == plan.total_bytes
        from deeplearning4j_tpu_torch.profiling.metrics import get_registry
        gauge = get_registry().get("serving_kv_cache_bytes")
        assert gauge is not None and gauge.value == plan.total_bytes
    finally:
        sched.stop()
        set_registry(prev)


# ---------------------------------------------------------------------------
# the CLI's file mode
# ---------------------------------------------------------------------------

def test_cli_file_mode_exit_codes(tmp_path, capsys):
    good = tmp_path / "mlp.json"
    good.write_text(mlp().to_json())
    assert graphcheck.main([str(good), "--mesh", "dp=8",
                            "--batch-size", "64", "--memory"]) == 0
    out = capsys.readouterr().out
    assert "clean" in out and "MemoryReport" in out
    assert graphcheck.main([str(good), "--mesh", "dp=8",
                            "--batch-size", "33"]) == 1
    assert "GC008" in capsys.readouterr().out
    yaml_path = tmp_path / "mlp.yaml"
    yaml_path.write_text(mlp().to_yaml())
    assert graphcheck.main([str(yaml_path), "--mesh", "pp=8"]) == 0
    assert "GC009" in capsys.readouterr().out
    broken = tmp_path / "cycle.json"
    conf, _ = fixtures.bad_graph_cycle()
    broken.write_text(json.dumps(graph_dict(conf)))
    assert graphcheck.main([str(broken)]) == 1
    assert "GC002" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        graphcheck.main([str(good), "--mesh", "dp"])
    assert "axis=size" in str(e.value)


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    good = tmp_path / "mlp.json"
    good.write_text(mlp().to_json())
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis.graphcheck",
         str(good), "--batch-size", "64"], cwd=str(root),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout and "Warning" not in proc.stderr
