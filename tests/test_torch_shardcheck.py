"""The port's shardcheck (``analysis/shardcheck``, ``analysis/fixtures``)
against the JAX package's, on the CPU.

The port's "step program" is a record of one real step, taken from a
snapshot of the state and put back bit for bit. The rules SC001-SC010
run over it with the JAX package's ids, severities and context. Here:

- the cases of ``tests/test_shardcheck.py`` that have a counterpart (its
  HLO-parser cases become the record's JSON round trip and a garbage
  input), SC009 / SC010 of ``tests/test_generation.py`` and SC008 of
  ``tests/test_gpt.py``;
- each known-bad and known-good fixture of the port held to the JAX
  package's fixture of the same name (``deeplearning4j_tpu.analysis.
  fixtures``, 8 host devices): the same (rule, severity) set above INFO;
- the recorded comm bytes against JAX's ``hlo_comm_bytes`` at dp = 2;
- ``cost_analysis()["comm_bytes_hlo"]`` against JAX's;
- a checked step against an unchecked twin, bit for bit.

The dp = 2 cases share one group of two gloo ranks
(``tests/torch_parallel_worker.py``); the fixture nets carry the JAX
nets' weights (``convert.params_from_jax``).
"""

import functools
import re

import jax
import numpy as np
import pytest

import torch_parallel_worker as W
from deeplearning4j_tpu.analysis import fixtures as jfix
from deeplearning4j_tpu.analysis import shardcheck as jsc
from deeplearning4j_tpu.models.gpt import gpt_tiny as jgpt_tiny
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.analysis import fixtures as pfix
from deeplearning4j_tpu_torch.analysis import shardcheck as sc
from deeplearning4j_tpu_torch.analysis.findings import Severity
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.profiling.cost import dp_comm_bytes_per_update

#: the JAX package's live findings where they differ from its own
#: fixture table under jax 0.9.0 (ROADMAP C1, C36): XLA's all-reduce
#: combiner emits one tuple-typed all-reduce, which the reference's HLO
#: parser reads as a scalar (its SC007 bytes undercount and its SC001
#: never sees the full all-reduce), and StableHLO names the step's results
#: "result[0]" where the parser looks for "[0]" (its SC004 misses the half
#: masters). Under the jax the reference pins they equal the port's.
JAX_090 = {
    "zero1-full-allreduce": set(),
    "bf16-half-masters": {("SC005", "error")},
    "zero1-step": {("SC007", "warning")},
    "zero2-step": {("SC007", "warning")},
    "bf16-zero2-step": {("SC007", "warning")},
    "fp32-preset-identity": {("SC007", "warning")},
    "replicated-step": {("SC007", "warning")},
}


def significant(findings):
    return {(f[0], f[1]) if isinstance(f, tuple) else (f.rule, f.severity)
            for f in findings
            if (f[1] if isinstance(f, tuple) else f.severity)
            != Severity.INFO}


def rules_of(findings):
    return sorted({f[0] if isinstance(f, tuple) else f.rule
                   for f in findings})


# ---------------------------------------------------------------------------
# the JAX fixtures' weights, carried into the port's fixture nets
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@functools.lru_cache(maxsize=None)
def jax_params() -> dict:
    """The JAX fixture nets' params, carried into the port's fixture nets'
    layout (numpy); built once, when a test first needs them."""
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    mlp = jfix._sc_net()
    gpt = JGraph(jgpt_tiny(vocab_size=8, seq_len=8)).init()
    attn = jax_attn_net()
    ports = {"mlp": pfix._sc_net("cpu").conf,
             "attn": pfix._sc_attn_net("cpu").conf,
             "gpt": gpt_tiny(vocab_size=8, seq_len=8)}
    return {key: _numpy(convert.params_from_jax(ports[key], _np(net.params)))
            for key, net in (("mlp", mlp), ("gpt", gpt), ("attn", attn))}


def jax_attn_net():
    from deeplearning4j_tpu import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers.attention import SelfAttentionLayer
    from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater("adam", learning_rate=1e-3).weight_init("xavier")
            .list()
            .layer(SelfAttentionLayer(n_heads=2, causal=True, block_size=4,
                                      activation="identity"))
            .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(8, 8)).build())
    return MultiLayerNetwork(conf).init()


def step_batches(n=2, seed=1):
    r = np.random.default_rng(seed)
    return [[r.normal(size=(8, 16)).astype(np.float32),
             np.eye(4, dtype=np.float32)[r.integers(0, 4, 8)]]
            for _ in range(n)]


def tbptt_batch(B=4, T=120, V=16, seed=3):
    r = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    return [eye[r.integers(0, V, (B, T))], eye[r.integers(0, V, (B, T))]]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shardcheck")
    cases = [dict(name="fixtures", fn="shardcheck_fixtures",
                  args=dict(params=jax_params())),
             dict(name="steps", fn="shardcheck_steps",
                  args=dict(params=jax_params()["mlp"], batches=step_batches(),
                            tbptt_batch=tbptt_batch()))]
    return W.run_group(cases, tmp, world=2)


@pytest.fixture(scope="module")
def fx(group):
    """Rank 0's fixtures, programs read back from their JSON."""
    got = W.result(group, "fixtures")
    for table in ("bad", "good"):
        for entry in got[table].values():
            entry["program"] = sc.StepProgram.from_json(entry["json"])
            if entry["baseline"] is not None:
                entry["ctx"]["baseline"] = sc.StepProgram.from_json(
                    entry["baseline"])
    return got


def program_of(fx, name):
    table = "bad" if name in fx["bad"] else "good"
    e = fx[table][name]
    return e["program"], dict(e["ctx"])


def check(fx, name, **overrides):
    program, ctx = program_of(fx, name)
    ctx.update(overrides)
    return program, sc.check_step_program(program, **ctx)


# ---------------------------------------------------------------- the record

def test_record_reads_real_zero1_step(fx):
    program, ctx = program_of(fx, "zero1-step")
    kinds = {c.kind for c in program.collectives}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    # one param all-gather of the packed (dp, row) buffer where the JAX
    # program makes one a leaf (the port's deviation, SC002)
    packed = pfix.packed_elems(ctx["param_leaf_sizes"], 2)
    ags = [c for c in program.collectives if c.kind == "all-gather"]
    assert len(ags) == 1 and ags[0].elems == packed
    assert all(c.group_size == 2 for c in program.collectives)
    assert all(s.kept for s in program.leaves("params", "updater"))
    assert program.saw_backward(), "the dispatch mode missed the backward"


def test_record_tags_the_microbatches_of_the_accumulation_loop(fx):
    program, _ = program_of(fx, "zero2-ga-scan")
    assert program.microbatches == 2 and program.updates == 1
    body = [c for c in program.collectives if c.in_loop_body]
    assert sorted({c.microbatch for c in body}) == [0, 1]
    assert {c.kind for c in body} == {"reduce-scatter"}


def test_ring_bytes_match_the_cost_model(fx):
    program, ctx = program_of(fx, "zero1-step")
    got = sc.program_comm_bytes(program, dp=2)
    predicted = dp_comm_bytes_per_update(
        sum(ctx["param_leaf_sizes"]), 2, 4, 1, "zero1")
    assert abs(got - predicted) / predicted < 0.05


def test_program_json_round_trip_and_garbage(fx, tmp_path):
    program, _ = program_of(fx, "zero2-ga-scan")
    again = sc.StepProgram.from_json(program.to_json())
    assert again.to_json() == program.to_json()
    assert again.collectives == program.collectives
    for text in ("not a program at all\n\njust text", "{}", "[1, 2]",
                 '{"format": "dl4j-torch-step-program/v1"}'):
        with pytest.raises(ValueError, match="not a step program"):
            sc.StepProgram.from_json(text)


# -------------------------------------------------------------------- SC001

def test_sc001_real_zero1_and_zero2_steps_are_clean(fx):
    for name in ("zero1-step", "zero2-step"):
        _, findings = check(fx, name)
        assert "SC001" not in rules_of(findings), findings


def test_sc001_fires_on_full_size_allreduce_update(fx):
    _, findings = check(fx, "zero1-full-allreduce")
    f = next(f for f in findings if f.rule == "SC001")
    assert f.severity == Severity.ERROR
    assert "full size" in f.message


def test_sc001_does_not_apply_to_replicated_mode(fx):
    _, findings = check(fx, "replicated-step")
    assert "SC001" not in rules_of(findings)


# -------------------------------------------------------------------- SC002

def test_sc002_census_reports_the_collective_mix(fx):
    _, findings = check(fx, "zero1-step")
    census = [f for f in findings if f.rule == "SC002"]
    assert len(census) == 1 and census[0].severity == Severity.INFO
    assert "all-gather" in census[0].message
    assert "reduce-scatter" in census[0].message


def test_sc002_warns_on_extra_param_gathers(fx):
    _, findings = check(fx, "zero1-double-gather")
    warn = [f for f in findings
            if f.rule == "SC002" and f.severity == Severity.WARNING]
    assert warn, findings
    assert "param leaves" in warn[0].message


# -------------------------------------------------------------------- SC003

def test_sc003_real_ga_scan_keeps_the_anchor(fx):
    program, findings = check(fx, "zero2-ga-scan")
    assert "SC003" not in rules_of(findings), findings
    assert not any(c.in_loop_body and c.kind == "all-gather"
                   for c in program.collectives)


def test_sc003_fires_on_in_body_weight_gather(fx):
    _, findings = check(fx, "ga-scan-weight-gather")
    f = next(f for f in findings if f.rule == "SC003")
    assert f.severity == Severity.ERROR
    assert "MICROBATCH" in f.message


def test_sc003_not_checked_outside_the_ga_scan_contract(fx):
    _, findings = check(fx, "ga-scan-weight-gather",
                        gradient_accumulation=1)
    assert "SC003" not in rules_of(findings)


# -------------------------------------------------------------------- SC004

def test_sc004_real_bf16_step_is_clean_and_actually_half(fx):
    program, findings = check(fx, "bf16-zero2-step")
    assert "SC004" not in rules_of(findings), findings
    assert program.dot_dtypes()["bf16"] > 0
    for role in ("params", "updater", "loss"):
        assert set(program.boundary[role]) <= {"f32", "s32", "s64"}, role


def test_sc004_fires_when_bf16_casts_gated_out(fx):
    _, findings = check(fx, "bf16-casts-gated-out")
    f = next(f for f in findings if f.rule == "SC004")
    assert "no" in f.message and "bf16" in f.message


def test_sc004_fires_on_half_precision_masters(fx):
    _, findings = check(fx, "bf16-half-masters")
    msgs = [f.message for f in findings if f.rule == "SC004"]
    assert any("master" in m for m in msgs), findings


def test_sc004_fp32_preset_is_op_and_dtype_identical(fx):
    _, findings = check(fx, "fp32-preset-identity")
    assert significant(findings) == set(), findings


def test_sc004_fires_when_fp32_program_differs_from_baseline(fx):
    program, ctx = program_of(fx, "bf16-zero2-step")
    baseline, _ = program_of(fx, "zero2-step")
    findings = sc.check_step_program(
        program, baseline=baseline, precision="fp32",
        weight_update_sharding="zero2", dp=2, expect_donation=True,
        param_leaf_sizes=ctx["param_leaf_sizes"])
    f = next(f for f in findings if f.rule == "SC004")
    assert "NOT op-and-dtype-identical" in f.message


# -------------------------------------------------------------------- SC005

def test_sc005_real_steps_update_in_place(fx):
    for name in ("replicated-step", "zero1-step", "zero2-step"):
        program, findings = check(fx, name)
        assert "SC005" not in rules_of(findings)
        leaves = program.leaves("params", "updater")
        assert leaves and all(s.kept for s in leaves)


def test_sc005_fires_on_out_of_place_update(fx):
    _, findings = check(fx, "donation-missing")
    f = next(f for f in findings if f.rule == "SC005")
    assert "out of place" in f.message


def test_sc005_trainer_donation_off_is_a_choice_not_a_defect(fx):
    e = fx["donate_off"]
    program = sc.StepProgram.from_json(e["json"])
    ctx = dict(e["ctx"])
    assert ctx["expect_donation"] is False
    assert "SC005" not in rules_of(sc.check_step_program(program, **ctx))
    # the port's step updates in place whatever the flag says: claiming
    # donation over the same step stays clean too (JAX's fires here, as
    # its step without donate_argnums keeps the old buffers)
    ctx["expect_donation"] = True
    assert "SC005" not in rules_of(sc.check_step_program(program, **ctx))
    # a step that replaces its params does fire under that claim
    bad, bad_ctx = program_of(fx, "donation-missing")
    assert "SC005" in rules_of(sc.check_step_program(bad, **bad_ctx))


# -------------------------------------------------------------------- SC006

def test_sc006_fires_on_host_read(fx):
    _, findings = check(fx, "host-callback-in-step")
    f = next(f for f in findings if f.rule == "SC006")
    assert "host" in f.message.lower()
    assert "_local_scalar_dense" in f.message


def test_sc006_real_steps_have_no_host_read(fx):
    for name in ("replicated-step", "zero2-ga-scan"):
        program, findings = check(fx, name)
        assert "SC006" not in rules_of(findings)
        assert program.host_reads == []


# -------------------------------------------------------------------- SC007

def test_sc007_zero1_calibration_within_tolerance(fx):
    _, findings = check(fx, "zero1-step")
    f = next(f for f in findings if f.rule == "SC007")
    assert f.severity == Severity.INFO
    assert "+0%" in f.message or "-0%" in f.message


def test_sc007_fires_on_model_mismatch(fx):
    _, findings = check(fx, "comm-model-mismatch")
    f = next(f for f in findings if f.rule == "SC007")
    assert f.severity == Severity.WARNING
    assert "tolerance" in f.message


def test_sc007_gate_holds_on_the_accumulation_path(fx):
    """JAX skips the gate on the accumulation scan (its HLO dump carries
    no trip counts); the record counts every microbatch's collectives,
    so the port gates there too: (k + 1) units at k = 2."""
    program, findings = check(fx, "zero2-ga-scan")
    sc7 = [f for f in findings if f.rule == "SC007"]
    assert sc7 and all(f.severity == Severity.INFO for f in sc7)
    assert "+0%" in sc7[0].message or "-0%" in sc7[0].message


# -------------------------------------------------------------------- SC008

def test_sc008_fires_on_false_sp_claim(fx):
    _, findings = check(fx, "sp-ring-absent")
    assert "SC008" in rules_of(findings)


def test_sp_trainer_shardcheck_clean_with_ring(fx):
    program, ctx = program_of(fx, "sp-ring-step")
    assert ctx["sp"] == 2
    assert significant(sc.check_step_program(program, **ctx)) == set()
    assert any(c.kind == "collective-permute" and c.axis == "sp"
               for c in program.collectives)


# ------------------------------------------------------------- SC009 / SC010

def _tiny_gpt():
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    net = ComputationGraph(gpt_tiny(vocab_size=8, seq_len=8), device="cpu")
    return net.init(pfix._tensors(jax_params()["gpt"], "cpu"))


def test_decode_step_program_updates_caches_in_place():
    """The engine's decode step passes SC009 (every cache leaf kept); the
    same step over copied caches fires it."""
    pfix.SC_PARAMS["gpt"] = jax_params()["gpt"]
    try:
        good, ctx = pfix.sc_good_gpt_decode("cpu")
        bad, bad_ctx = pfix.sc_bad_decode_cache_copied("cpu")
    finally:
        pfix.SC_PARAMS.clear()
    assert not [f for f in sc.check_step_program(good, **ctx)
                if f.rule == "SC009"]
    fired = [f for f in sc.check_step_program(bad, **bad_ctx)
             if f.rule == "SC009"]
    assert fired and fired[0].severity == Severity.ERROR


def test_paged_decode_step_program_sc010():
    """The engine's paged decode runner (``StepRunner.step_program``)
    passes SC009 and SC010; the step over a copy of the pool fires SC010
    with the donation arm, and the DENSE step checked against a paged
    claim fires the gather-missing arm."""
    from deeplearning4j_tpu_torch.keras.generation import StepRunner
    net = _tiny_gpt()
    pl = net.kv_page_len()
    ppr = net.decode_max_len() // pl
    pool = net.init_kv_page_pool(2 * ppr + 1, pl)
    before = [t.clone() for kv in pool.values() for t in kv.values()]
    runner = StepRunner(net, "decode", 2, pl, pool=pool)
    assert significant(runner.shardcheck(net, pool)) == set()
    # page 0, where the recorded step wrote, is put back
    for t, b in zip([t for kv in pool.values() for t in kv.values()],
                    before):
        assert torch_equal(t, b)
    pfix.SC_PARAMS["gpt"] = jax_params()["gpt"]
    try:
        bad, ctx = pfix.sc_bad_paged_pool_copied("cpu")
        dense, dctx = pfix.sc_bad_paged_gather_missing("cpu")
    finally:
        pfix.SC_PARAMS.clear()
    fired = [f for f in sc.check_step_program(bad, **ctx)
             if f.rule == "SC010"]
    assert fired and fired[0].severity == Severity.ERROR
    assert "donat" in fired[0].message
    fired = [f for f in sc.check_step_program(dense, **dctx)
             if f.rule == "SC010"]
    assert fired and "indirection never formed" in fired[0].message


def torch_equal(a, b) -> bool:
    return bool((a == b).all()) and a.dtype == b.dtype


# ----------------------------------------------- container / trainer hooks

def _small_batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, 16)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


def test_net_shardcheck_multilayer_clean():
    pfix.SC_PARAMS["mlp"] = jax_params()["mlp"]
    try:
        net = pfix._sc_net("cpu")
    finally:
        pfix.SC_PARAMS.clear()
    findings = net.shardcheck(_small_batch())
    assert significant(findings) == set(), findings


def test_net_shardcheck_computation_graph_clean():
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.core import (
        DenseLayer, OutputLayer,
    )
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater("adam", learning_rate=1e-3).weight_init("xavier")
            .graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.feed_forward(16))
            .add_layer("h", DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                          loss="mcxent"), "h")
            .set_outputs("out")
            .build())
    net = ComputationGraph(conf, device="cpu").init()
    findings = net.shardcheck(_small_batch())
    assert significant(findings) == set(), findings


def test_parallel_wrapper_shardcheck_clean(group):
    findings = W.result(group, "steps")["wrapper"]
    assert significant(findings) == set(), findings


def test_early_stopping_trainer_delegates_shardcheck(group):
    findings = W.result(group, "steps")["early_stopping"]
    assert significant(findings) == set(), findings
    assert "SC002" in rules_of(findings)     # the census proves dp ran


def test_cost_analysis_carries_comm_bytes_hlo():
    """A single net's step issues no collective: the port's
    ``comm_bytes_hlo`` is 0, as the JAX package's on the same net and
    batch."""
    pfix.SC_PARAMS["mlp"] = jax_params()["mlp"]
    try:
        net = pfix._sc_net("cpu")
    finally:
        pfix.SC_PARAMS.clear()
    batch = _small_batch()
    jnet = jfix._sc_net()
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    want = jnet.cost_analysis(JDataSet(batch.features, batch.labels))
    assert net.cost_analysis(batch)["comm_bytes_hlo"] \
        == want["comm_bytes_hlo"] == 0


# -------------------------------------------------------------- the gates

def test_cli_self_check_passes(fx):
    assert fx["self_check"] == 0, "\n".join(fx["report"])


def test_cli_contracts_pass(fx):
    assert fx["contracts"] == 0, "\n".join(fx["report"])


def test_cli_file_mode(fx, tmp_path, capsys):
    path = tmp_path / "step.json"
    program, _ = program_of(fx, "zero1-step")
    path.write_text(program.to_json())
    # clean under the true claim...
    assert sc.main([str(path), "--wus", "zero1", "--dp", "2"]) == 0
    # ...and the zero-mode claim is refuted on an off-mode step
    program_off, _ = program_of(fx, "replicated-step")
    path.write_text(program_off.to_json())
    assert sc.main([str(path), "--wus", "zero1", "--dp", "2"]) == 1
    path.write_text("not json")
    assert sc.main([str(path)]) == 2
    assert "not a step program" in capsys.readouterr().out


def test_rule_table_is_complete():
    assert set(sc.RULES) == {"SC001", "SC002", "SC003", "SC004", "SC005",
                             "SC006", "SC007", "SC008", "SC009", "SC010"}
    assert set(sc.RULES) == set(jsc.RULES)
    for rule in sc.RULES:
        assert sc.RULES[rule][0] == jsc.RULES[rule][0], rule
        assert sc.RULE_SEVERITY[rule] == str(jsc.RULE_SEVERITY[rule])
    assert sc.COMM_BYTES_TOLERANCE == jsc.COMM_BYTES_TOLERANCE
    assert sc.SC001_MIN_GRAD_ELEMS == jsc.SC001_MIN_GRAD_ELEMS


def test_every_rule_has_a_known_bad_and_a_known_good_fixture():
    """As ``tests/test_fixture_coverage.py`` requires of the JAX
    package's: every SC rule has a known-bad step and a known-good one
    mapped in ``SC_GOOD_FOR``; the port's tables name JAX's fixtures."""
    bad_rules = {rule for _, rule, _ in pfix.SC_KNOWN_BAD}
    assert bad_rules == set(sc.RULES)
    good = {name for name, _ in pfix.SC_KNOWN_GOOD}
    assert set(pfix.SC_GOOD_FOR) == set(sc.RULES)
    assert set(pfix.SC_GOOD_FOR.values()) <= good
    assert [(n, r) for n, r, _ in pfix.SC_KNOWN_BAD] \
        == [(n, r) for n, r, _ in jfix.SC_KNOWN_BAD]
    assert [n for n, _ in pfix.SC_KNOWN_GOOD] \
        == [n for n, _ in jfix.SC_KNOWN_GOOD]
    assert pfix.SC_GOOD_FOR == jfix.SC_GOOD_FOR


# --------------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def jax_fixtures():
    out = {}
    for name, _rule, make in jfix.SC_KNOWN_BAD:
        program, ctx = make()
        out[name] = (program, jsc.check_step_program(program, **ctx))
    for name, make in jfix.SC_KNOWN_GOOD:
        program, ctx = make()
        out[name] = (program, jsc.check_step_program(program, **ctx))
    return out


ALL_FIXTURES = ([("bad", n, r) for n, r, _ in jfix.SC_KNOWN_BAD]
                + [("good", n, None) for n, _ in jfix.SC_KNOWN_GOOD])


@pytest.mark.parametrize("table,name,rule", ALL_FIXTURES,
                         ids=[n for _, n, _ in ALL_FIXTURES])
def test_findings_match_the_jax_fixture(fx, jax_fixtures, table, name,
                                        rule):
    port = significant(fx[table][name]["findings"])
    if table == "bad":
        assert (rule, str(jsc.RULE_SEVERITY[rule])) in port, port
    else:
        assert port == set(), port
    jax_set = significant(jax_fixtures[name][1])
    assert jax_set == port or jax_set == JAX_090.get(name), \
        (name, port, jax_set)


def _jax_ring_bytes(program, zero: bool) -> int:
    """The JAX program's ring-model bytes, ``hlo_comm_bytes`` with its
    tuple-typed collectives (jax 0.9's combined all-reduce, which the
    reference parser reads as one scalar) counted element by element: a
    full all-reduce in the replicated step, the reduce-scatter it stands
    for under ZeRO (the reference's own convention for the CPU's
    unfolded all-reduce + slice)."""
    total = jsc.hlo_comm_bytes(program, dp=2)
    for c in program.module.collectives:
        if c.instr.dtype:
            continue
        head = c.instr.line.split(f" {c.instr.opcode}(", 1)[0]
        payload = sum(
            int(np.prod([int(d) for d in dims.split(",") if d] or [1]))
            * jsc.DTYPE_BYTES.get(dt, 4)
            for dt, dims in re.findall(r"([a-z]+\d*)\[([\d,]*)\]", head))
        g = max(2, c.group_size)
        unit = payload * (g - 1) // g
        total += (unit if zero or c.kind != "all-reduce" else 2 * unit) \
            - c.ring_bytes()
    return total


@pytest.mark.parametrize("name,zero", [("replicated-step", False),
                                       ("zero1-step", True),
                                       ("zero2-step", True)])
def test_comm_bytes_within_2_percent_of_jax(fx, jax_fixtures, name, zero):
    """At dp = 2 on the fixture net the recorded bytes are within 2% of
    the JAX program's. Two terms separate them: the ZeRO padding (the
    port packs every leaf's padded ``(dp, chunk)`` rows into one buffer,
    JAX gathers them a leaf: the same ``dp * sum(ceil(s / dp)) - sum(s)``
    elements, 0 for these even leaves) and the loss's reduction (the
    port's own 1-element all-reduce, 4 B a rank; JAX folds the loss into
    the gradient's reduction)."""
    program, ctx = program_of(fx, name)
    leaves = ctx["param_leaf_sizes"]
    padding = pfix.packed_elems(leaves, 2) - sum(leaves)
    assert padding == 0
    port = sc.program_comm_bytes(program, dp=2)
    want = _jax_ring_bytes(jax_fixtures[name][0], zero)
    assert abs(port - want) <= 0.02 * want, (port, want)


# ------------------------------------------- a checked step is left bitwise

@pytest.mark.parametrize("layout", ["off-k1", "zero1-k1", "zero2-k2"])
def test_checked_trainer_step_equals_an_unchecked_one(group, layout):
    got = W.result(group, "steps")["bitwise"][layout]
    assert significant(got["findings"]) == set(), got["findings"]
    before, after = got["before"], got["after"]
    assert np.array_equal(before["params"], after["params"])
    assert before["iteration"] == after["iteration"]
    assert np.array_equal(before["rng"], after["rng"])
    for a, b in zip(before["states"], after["states"]):
        assert np.array_equal(a, b)
    assert same_opt(before["opt"], after["opt"])
    checked, twin = got["checked"], got["twin"]
    assert checked["losses"] == twin["losses"]
    assert np.array_equal(checked["params"], twin["params"])
    assert same_opt(checked["opt"], twin["opt"])


def same_opt(a: dict, b: dict) -> bool:
    """Two updater states' slots (lists of arrays) and counts, bitwise."""
    if sorted(a) != sorted(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list):
            if len(x) != len(y) or not all(
                    np.array_equal(u, v) for u, v in zip(x, y)):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


@pytest.mark.parametrize("kind", ["gpt", "gpt_bf16", "char_rnn"])
def test_checked_net_step_equals_an_unchecked_one(kind):
    """``net.shardcheck`` on the GPT (K4-K6 sites, in the policy's dtype)
    and the char-RNN (K2 / K3 over its tBPTT windows) leaves the net as
    it was: the next ``fit_batch`` equals that of a twin never checked,
    bit for bit."""
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
    from deeplearning4j_tpu_torch.models.gpt import gpt_decoder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    r = np.random.default_rng(5)
    if kind == "char_rnn":
        def make():
            return MultiLayerNetwork(char_rnn_lstm(16, 8, 2),
                                     device="cpu").init()
        B, T, V, sites, dtype = 4, 120, 16, {"K2": 6, "K3": 6}, "f32"
    else:
        precision = "bf16" if kind == "gpt_bf16" else None

        def make():
            return ComputationGraph(gpt_decoder(16, 8, 32, 2, 2,
                                                precision=precision),
                                    device="cpu").init()
        B, T, V = 4, 8, 16
        sites = {"K4": 2, "K5": 2, "K6": 2}
        dtype = "bf16" if precision else "f32"
    eye = np.eye(V, dtype=np.float32)
    batch = DataSet(eye[r.integers(0, V, (B, T))],
                    eye[r.integers(0, V, (B, T))])
    net, twin = make(), make()
    program = sc.net_step_program(net, batch)
    assert dict(program.kernel_counts()) == sites
    assert {dt for (_, dt) in program.kernel_dtypes()} == {dtype}
    assert program.saw_backward()
    assert significant(net.shardcheck(batch)) == set()
    assert net.iteration_count == twin.iteration_count == 0
    a, b = net.fit_batch(batch), twin.fit_batch(batch)
    assert np.float32(float(a)).tobytes() == np.float32(float(b)).tobytes()
    assert np.array_equal(net.params_flat(), twin.params_flat())


# ------------------------------------------------ what SC006 finds on steps

def test_guarded_trainer_step_reads_nothing_on_the_host(group):
    """Under a divergence sentinel the trainer's step computes its flag
    on the device and hands it over after the step: no host read."""
    got = W.result(group, "steps")["sentinel"]
    assert got["host_reads"] == []
    assert significant(got["findings"]) == set(), got["findings"]


def test_tbptt_trainer_step_is_one_update_a_window(group):
    got = W.result(group, "steps")["tbptt"]
    assert got["updates"] == 3          # T = 120 in windows of 50
    assert got["kernels"] == {"K2": 6, "K3": 6}
    assert significant(got["findings"]) == set(), got["findings"]


@pytest.mark.parametrize("lag", [0, 1])
def test_guarded_tbptt_step_drains_between_its_window_programs(lag):
    """ROADMAP C37: a tBPTT step under a divergence sentinel hands each
    window's flag to the sentinel between windows, as the JAX package
    does between its jitted windows, and the sentinel reads the flags
    older than ``lag`` on the host there (``resilience/sentinel.py
    _handle``). The record marks each window as a program of its own
    (``steprecord.window``) and each read the sentinel makes as its drain
    (``steprecord.drain``), so those drains, ``windows - lag`` of them,
    fall between programs: SC006 reports them as info and the step is
    clean above INFO. A host read planted inside a window's loss still
    fires SC006, once a window, and so does one planted before the first
    window, outside every window program."""
    import torch
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        DivergenceSentinel,
    )
    f, l = tbptt_batch()
    batch = DataSet(f, l)
    windows = 3                          # T = 120 in windows of 50
    net = MultiLayerNetwork(char_rnn_lstm(16, 8, 2), device="cpu").init()
    net.set_divergence_sentinel(DivergenceSentinel("skip_batch", lag=lag))
    program = sc.net_step_program(net, batch)
    assert program.windows == windows and program.updates == windows
    assert [h.op for h in sc.between_windows(program)] \
        == ["_local_scalar_dense.default"] * (windows - lag)
    assert [h.window for h in program.host_reads] == [None] * (windows - lag)
    assert all(h.drain for h in program.host_reads)
    findings = sc.check_step_program(program, **net.shardcheck_context())
    assert significant(findings) == set()
    assert [f.severity for f in findings if f.rule == "SC006"] \
        == [Severity.INFO]
    again = sc.StepProgram.from_json(program.to_json())
    assert again.windows == windows and again.host_reads == program.host_reads

    carries_of = net._initial_carries

    def leaky_carries(*args, **kwargs):
        out = carries_of(*args, **kwargs)
        torch.zeros(1).item()            # a host read before the windows
        return out
    net._initial_carries = leaky_carries
    program = sc.net_step_program(net, batch)
    early = [h for h in program.host_reads if not h.drain]
    assert [(h.window, h in sc.between_windows(program))
            for h in early] == [(None, False)]
    assert ("SC006", "error") in significant(
        sc.check_step_program(program, **net.shardcheck_context()))
    net._initial_carries = carries_of

    loss_of = net._tbptt_loss

    def leaky(*args, **kwargs):
        out = loss_of(*args, **kwargs)
        out[0].item()                    # a host read inside the window
        return out
    net._tbptt_loss = leaky
    program = sc.net_step_program(net, batch)
    assert [h.window for h in program.host_reads
            if h.window is not None] == list(range(windows))
    assert ("SC006", "error") in significant(
        sc.check_step_program(program, **net.shardcheck_context()))


def test_a_collectives_transport_is_the_collectives_not_the_steps():
    """The copies a collective is staged through host buffers by
    (``parallel/mesh._shift`` / ``_post`` / ``_take`` under gloo on CUDA
    tensors) are recorded as ops tagged ``host_staged``: the one that
    made a buffer the collective was handed and the one that reads a
    buffer back. SC006 reports them as info, citing C21; a host read of
    the step's own still fires it, and the tags round-trip through JSON."""
    import torch
    from deeplearning4j_tpu_torch.analysis import steprecord
    t = torch.ones(4, 8)

    def step():
        src = t.sum().reshape(1).clone()            # the staging copy
        buf = torch.empty(1)                        # the receive buffer
        steprecord.note_collective("collective-permute", "sp", 2, src,
                                   (src, buf))
        buf.item()                                  # read back
        return (t * 2).sum()
    program = sc.record_step_program(step)
    tagged = [o.base for o in program.ops if o.host_staged]
    assert tagged == ["clone", "empty", "_local_scalar_dense"]
    assert [h.host_staged for h in program.host_reads] == [True]
    assert program.collectives[0].host_staged
    findings = sc.check_step_program(program)
    sc006 = [f for f in findings if f.rule == "SC006"]
    assert [f.severity for f in sc006] == [Severity.INFO]
    assert "C21" in sc006[0].message
    again = sc.StepProgram.from_json(program.to_json())
    assert [o.host_staged for o in again.ops] \
        == [o.host_staged for o in program.ops]
    assert again.host_reads == program.host_reads

    def leaky():
        (t * 2).sum().item()
        return t.sum()
    program = sc.record_step_program(leaky)
    assert "SC006" in rules_of(sc.check_step_program(program))
