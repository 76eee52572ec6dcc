"""The port's lockcheck and source_lint (``deeplearning4j_tpu_torch/
analysis/{lockcheck,source_lint}.py``, the port's own copies) against the
JAX package's modules, on the CPU: the same (rule, severity, location,
message) lists on every ``LC_FIXTURES`` snippet and on both package trees,
the same fixture family, the CLI's self-check and sweep, and the same
suppression tables and stale findings from ``source_lint`` on the same
sources."""

import ast
from pathlib import Path

import pytest

from deeplearning4j_tpu.analysis import fixtures as jfix
from deeplearning4j_tpu.analysis import lockcheck as jlc
from deeplearning4j_tpu.analysis import source_lint as jsl
from deeplearning4j_tpu.analysis.findings import Severity as JSeverity

from deeplearning4j_tpu_torch.analysis import fixtures as pfix
from deeplearning4j_tpu_torch.analysis import lockcheck as plc
from deeplearning4j_tpu_torch.analysis import source_lint as psl
from deeplearning4j_tpu_torch.analysis.findings import Severity

ROOT = Path(__file__).resolve().parents[1]
TREES = ("deeplearning4j_tpu", "deeplearning4j_tpu_torch")


def quads(findings):
    return [(f.rule, f.severity, f.location, f.message) for f in findings]


CASES = [(rule, which) for rule in sorted(jfix.LC_FIXTURES)
         for which in ("bad", "good")]


@pytest.mark.parametrize("rule,which", CASES,
                         ids=[f"{r}-{w}" for r, w in CASES])
def test_fixture_findings_equal_the_jax_modules(rule, which):
    src = pfix.LC_FIXTURES[rule][("bad", "good").index(which)]
    path = f"<{rule}-{which}>"
    got = quads(plc.lint_source(src, path))
    assert got == quads(jlc.lint_source(src, path))
    assert [r for r, *_ in got] == ([rule] if which == "bad" else [])


def test_the_fixture_family_is_the_jax_packages():
    assert pfix.LC_FIXTURES == jfix.LC_FIXTURES
    assert plc.RULES == jlc.RULES
    assert plc.RULE_SEVERITY == jlc.RULE_SEVERITY


@pytest.mark.parametrize("tree", TREES)
def test_tree_findings_equal_the_jax_modules(tree):
    path = str(ROOT / tree)
    got = quads(plc.lint_paths([path]))
    assert got == quads(jlc.lint_paths([path]))
    assert got == []


def test_cli_self_check_sweep_and_rule_table(capsys):
    lines = []
    assert plc.self_check(report=lines.append) == 0, lines
    assert lines == ["lockcheck --self-check: 8 rule fixtures OK"]
    assert plc.main(["--self-check"]) == 0
    assert plc.main([]) == 0                      # the port's package
    assert "lockcheck: clean" in capsys.readouterr().out
    assert plc.main(["--list-rules"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in table] == sorted(plc.RULES)


def test_cli_sweep_exits_1_on_findings(tmp_path, capsys):
    bad = tmp_path / "broker.py"
    bad.write_text(pfix.LC_FIXTURES["LC001"][0])
    assert plc.main([str(bad)]) == 1
    assert "LC001" in capsys.readouterr().out


# ------------------------------------------------------------ source_lint

TOOLS = ("lockcheck", "jaxlint", "torchlint")


def _sources():
    """Every source file of both trees and every fixture snippet."""
    out = [(str(f), f.read_text(encoding="utf-8"))
           for tree in TREES for f in sorted((ROOT / tree).rglob("*.py"))]
    for family in (jfix.JL_FIXTURES, pfix.TL_FIXTURES, pfix.LC_FIXTURES):
        for rule, pair in sorted(family.items()):
            out += [(f"<{rule}-{i}>", src) for i, src in enumerate(pair)]
    return out


@pytest.mark.parametrize("tool", TOOLS)
def test_suppression_tables_equal_the_jax_modules(tool):
    """The same suppressions (line -> rule ids) and the same reasonless
    ones on every source, for each tool's grammar."""
    jre, pre = jsl.make_suppress_re(tool), psl.make_suppress_re(tool)
    assert jre.pattern == pre.pattern
    n = 0
    for path, src in _sources():
        jf, pf = [], []
        want = jsl.collect_suppressions(src, jf, path, jre, "M000",
                                        JSeverity.WARNING)
        got = psl.collect_suppressions(src, pf, path, pre, "M000",
                                       Severity.WARNING)
        assert got == want, path
        assert quads(pf) == quads(jf), path
        n += len(got)
    assert n > 0 or tool == "jaxlint"


SNIPPET = """\
x = 1  # lint: disable=R001 -- live
y = 2  # lint: disable=R001,R002 -- partly live
z = 3  # lint: disable=all -- swallows R001
w = 4  # lint: disable=all -- live through all
v = 5  # lint: disable=R009
u = 6  # lint: disable=R002,R009 -- opted out of the stale rule
"""


def test_stale_pass_and_helpers_equal_the_jax_modules():
    """The used-suppression ledger, the stale findings, the sort order and
    the helpers (``dotted``, ``iter_py_files``) give the same results."""
    severity = {"R001": "error", "R002": "warning", "R009": "warning",
                "M000": "warning"}
    results = []
    for sl, sev in ((jsl, JSeverity), (psl, Severity)):
        findings = []
        table = sl.collect_suppressions(
            SNIPPET, findings, "s.py", sl.make_suppress_re("lint"), "M000",
            sev.WARNING)
        ctx = sl.LintContext(path="s.py", suppressed=table,
                             severity=severity, findings=findings)
        tree = ast.parse(SNIPPET)
        for stmt in tree.body:
            ctx.emit("R001", stmt, "fires everywhere")
        sl.stale_suppression_pass(ctx, "R009")
        sl.sort_findings(ctx.findings)
        results.append((quads(ctx.findings), ctx.used))
    assert results[0] == results[1]
    # line 2's R002 never fired; line 5 names the stale rule itself and
    # line 6 opts out of it
    stale = [q for q in results[1][0] if q[0] == "R009"]
    assert [q[2] for q in stale] == ["s.py:2"]
    assert [q[0] for q in results[1][0]].count("M000") == 1   # line 5
    for expr in ("jax.lax.scan", "self.m", "f", "a[0].b", "f().g"):
        node = ast.parse(expr, mode="eval").body
        assert psl.dotted(node) == jsl.dotted(node)
    paths = [str(ROOT / "deeplearning4j_tpu_torch" / "analysis"),
             str(ROOT / "tools" / "lockcheck.py")]
    assert psl.iter_py_files(paths) == jsl.iter_py_files(paths)
