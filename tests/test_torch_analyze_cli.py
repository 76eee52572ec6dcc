"""The port's umbrella analyzer (``python -m deeplearning4j_tpu_torch.
analysis.analyze``) and its fixture coverage, on the CPU: the cases of
``tests/test_analyze_cli.py`` over the port's five layers (graphcheck,
torchlint, lockcheck, shardcheck, postmortem), the whole umbrella clean
with ``--device cpu``, and the cases of ``tests/test_fixture_coverage.py``
over the port's four fixture families (GC, TL, LC, SC): every rule of
every layer has a known-bad and a known-good fixture. This file imports
no JAX."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

from deeplearning4j_tpu_torch.analysis import analyze
from deeplearning4j_tpu_torch.analysis import fixtures
from deeplearning4j_tpu_torch.analysis.graphcheck import RULES as GC_RULES
from deeplearning4j_tpu_torch.analysis.lockcheck import RULES as LC_RULES
from deeplearning4j_tpu_torch.analysis.shardcheck import RULES as SC_RULES
from deeplearning4j_tpu_torch.analysis.torchlint import RULES as TL_RULES

REPO = Path(__file__).resolve().parents[1]
MODULE = "deeplearning4j_tpu_torch.analysis.analyze"


def test_all_layers_registered():
    assert list(analyze.LAYERS) == ["graphcheck", "torchlint", "lockcheck",
                                    "shardcheck", "postmortem"]
    # the two source layers sweep the tree AND self-check; the config,
    # recorded-step and bundle layers self-check only
    for layer in ("torchlint", "lockcheck"):
        assert [s for s, _ in analyze.LAYERS[layer]] == ["sweep",
                                                         "self-check"]
    for layer in ("graphcheck", "shardcheck", "postmortem"):
        assert [s for s, _ in analyze.LAYERS[layer]] == ["self-check"]


def test_each_step_runs_its_layers_module():
    argv = {(layer, step): build(["p"], None)
            for layer, steps in analyze.LAYERS.items()
            for step, build in steps}
    assert argv[("torchlint", "sweep")] == [
        "deeplearning4j_tpu_torch.analysis.torchlint", "p"]
    assert argv[("lockcheck", "self-check")] == [
        "deeplearning4j_tpu_torch.analysis.lockcheck", "--self-check"]
    assert argv[("postmortem", "self-check")] == [
        "deeplearning4j_tpu_torch.profiling.postmortem", "--self-check"]
    # shardcheck's ranks, from a launcher that imports no torch; the card
    # unless asked for the CPU
    assert argv[("shardcheck", "self-check")] == [
        "deeplearning4j_tpu_torch.analysis.ranks", "self-check"]
    build = analyze.LAYERS["shardcheck"][0][1]
    assert build([], "cpu")[-2:] == ["--device", "cpu"]


def _fake_run(rc_by_module):
    def run(argv, **kw):
        module = argv[2].rsplit(".", 1)[-1]
        return types.SimpleNamespace(returncode=rc_by_module.get(module, 0),
                                     stdout="", stderr="")
    return run


def test_exit_code_lattice(monkeypatch, capsys):
    # all clean -> 0
    monkeypatch.setattr(analyze.subprocess, "run", _fake_run({}))
    assert analyze.main([]) == 0
    # a layer whose every step fails: its self-check broke -> 2
    monkeypatch.setattr(analyze.subprocess, "run",
                        _fake_run({"lockcheck": 1}))
    assert analyze.main(["--layer", "lockcheck"]) == 2

    # sweep-only failure (the self-check passes) -> 1
    def run(argv, **kw):
        rc = 1 if "--self-check" not in argv else 0
        return types.SimpleNamespace(returncode=rc, stdout="", stderr="")
    monkeypatch.setattr(analyze.subprocess, "run", run)
    assert analyze.main(["--layer", "lockcheck"]) == 1
    assert analyze.main(["--layer", "torchlint", "--layer", "lockcheck"]) \
        == 1

    # a broken self-check outranks findings, even beside a sweep's
    def run2(argv, **kw):
        return types.SimpleNamespace(returncode=1, stdout="", stderr="")
    monkeypatch.setattr(analyze.subprocess, "run", run2)
    assert analyze.main(["--layer", "torchlint"]) == 2
    capsys.readouterr()


def test_json_report_shape(monkeypatch, capsys):
    monkeypatch.setattr(analyze.subprocess, "run", _fake_run({}))
    assert analyze.main(["--layer", "lockcheck", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["verdict"] == "clean"
    assert report["exit_code"] == 0
    assert report["layers"] == ["lockcheck"]
    assert [s["step"] for s in report["steps"]] == ["sweep", "self-check"]
    assert all(s["seconds"] >= 0 for s in report["steps"])


def test_list_layers(capsys):
    assert analyze.main(["--list-layers"]) == 0
    out = capsys.readouterr().out.split("\n")
    assert [line.split()[0] for line in out if line] == list(analyze.LAYERS)


def test_lockcheck_layer_clean_end_to_end():
    """The real thing: the port passes its own concurrency gate through
    the umbrella, run as a module."""
    proc = subprocess.run(
        [sys.executable, "-m", MODULE, "--layer", "lockcheck"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lockcheck: clean" in proc.stdout
    assert "8 rule fixtures OK" in proc.stdout


def test_every_layer_clean_on_the_cpu():
    """``--device cpu``: every layer's self-check passes and the torchlint
    and lockcheck sweeps of the port's package are clean."""
    proc = subprocess.run(
        [sys.executable, "-m", MODULE, "--device", "cpu", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    report = json.loads(proc.stdout)
    assert proc.returncode == 0 == report["exit_code"], report
    assert report["verdict"] == "clean"
    assert [(s["layer"], s["step"], s["rc"]) for s in report["steps"]] == [
        ("graphcheck", "self-check", 0), ("torchlint", "sweep", 0),
        ("torchlint", "self-check", 0), ("lockcheck", "sweep", 0),
        ("lockcheck", "self-check", 0), ("shardcheck", "self-check", 0),
        ("postmortem", "self-check", 0)]
    out = {(s["layer"], s["step"]): s["output"] for s in report["steps"]}
    assert "graphcheck self-check: PASS" in out["graphcheck", "self-check"]
    assert out["torchlint", "sweep"] == "torchlint: clean"
    assert "11 rule fixtures OK" in out["torchlint", "self-check"]
    assert out["lockcheck", "sweep"] == "lockcheck: clean"
    assert "shardcheck self-check: PASS" in out["shardcheck", "self-check"]
    assert "bundle round-trip OK" in out["postmortem", "self-check"]


def test_the_rank_launcher_imports_no_torch_and_wants_the_card():
    """``analysis/ranks.py`` starts shardcheck's ranks without a torch
    import of its own; asked for the card where there is none, each rank
    says so and the launcher exits 2."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; import deeplearning4j_tpu_torch"
         ".analysis.ranks; print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.stdout.strip() == "False", proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis.ranks",
         "self-check"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "no CUDA device is available" in proc.stderr


# ---------------------------------------------------------------------------
# fixture coverage: every rule of every layer has its fixtures
# ---------------------------------------------------------------------------

def test_every_gc_rule_has_a_known_bad_fixture():
    covered = {rule for _, rule, _ in fixtures.KNOWN_BAD}
    assert not set(GC_RULES) - covered


def test_every_gc_rule_has_a_known_good_fixture():
    good_names = {name for name, _ in fixtures.KNOWN_GOOD}
    assert not set(GC_RULES) - set(fixtures.KNOWN_GOOD_FOR)
    dangling = {rule: name for rule, name in fixtures.KNOWN_GOOD_FOR.items()
                if name not in good_names}
    assert not dangling


def _pairs_complete(family, rules, meta):
    missing = set(rules) - set(family) - {meta}
    assert not missing, f"rules without a (bad, good) pair: {missing}"
    malformed = {r for r, pair in family.items()
                 if len(pair) != 2 or not all(
                     isinstance(s, str) and s.strip() for s in pair)}
    assert not malformed, malformed


def test_every_tl_rule_has_a_bad_good_pair():
    # TL000 is the meta rule (a reasonless suppression): it fires from the
    # suppression machinery, not on a fixture of its own
    _pairs_complete(fixtures.TL_FIXTURES, TL_RULES, "TL000")
    # the captured-code pairs a card can run: step(x) and capture(graph, x)
    for rule in ("TL001", "TL003", "TL004", "TL005", "TL006", "TL007"):
        for src in fixtures.TL_FIXTURES[rule]:
            assert "def step(x)" in src and "capture" in src, rule


def test_every_lc_rule_has_a_bad_good_pair():
    _pairs_complete(fixtures.LC_FIXTURES, LC_RULES, "LC000")


def test_every_sc_rule_has_a_known_bad_fixture():
    covered = {rule for _, rule, _ in fixtures.SC_KNOWN_BAD}
    assert not set(SC_RULES) - covered


def test_every_sc_rule_has_a_known_good_fixture():
    good_names = {name for name, _ in fixtures.SC_KNOWN_GOOD}
    assert not set(SC_RULES) - set(fixtures.SC_GOOD_FOR)
    dangling = {rule: name for rule, name in fixtures.SC_GOOD_FOR.items()
                if name not in good_names}
    assert not dangling


def test_known_bad_rules_are_registered():
    """A fixture naming an unregistered rule id would never gate."""
    for name, rule, _ in fixtures.KNOWN_BAD:
        assert rule in GC_RULES, f"KNOWN_BAD {name!r} names unknown {rule}"
    for name, rule, _ in fixtures.SC_KNOWN_BAD:
        assert rule in SC_RULES, f"SC_KNOWN_BAD {name!r} names {rule}"
    for rule in fixtures.TL_FIXTURES:
        assert rule in TL_RULES, f"TL_FIXTURES names unknown {rule}"
    for rule in fixtures.LC_FIXTURES:
        assert rule in LC_RULES, f"LC_FIXTURES names unknown {rule}"


def test_fixture_names_are_unique():
    for family in (fixtures.KNOWN_BAD, fixtures.SC_KNOWN_BAD):
        names = [name for name, *_ in family]
        assert len(names) == len(set(names)), names
    for family in (fixtures.KNOWN_GOOD, fixtures.SC_KNOWN_GOOD):
        names = [name for name, _ in family]
        assert len(names) == len(set(names)), names
