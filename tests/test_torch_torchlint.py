"""torchlint (``deeplearning4j_tpu_torch/analysis/torchlint.py``), the
port's counterpart of jaxlint, on the CPU: each case of
``tests/test_jaxlint.py`` on the TL rule that keeps or replaces its JL
rule (a ``jax.jit`` context becomes a CUDA graph capture, a
``torch.compile`` or a seam), then TL009-TL011 on ``autograd.Function``
subclasses, the seam table resolving against the port's tree and the
JAX package's ``jax.jit`` sites, the port's tree clean (with every
suppression reasoned) and the rule table complete. torchlint imports no
torch and runs nothing: every case is source text."""

import re
import textwrap
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.analysis import torchlint
from deeplearning4j_tpu_torch.analysis.torchlint import (
    RULES, SEAMS, Seam, lint_paths, lint_source,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"


def rules_of(src, **kw):
    return [f.rule for f in lint_source(textwrap.dedent(src), "snippet.py",
                                        **kw)]


def captured(body, head="import torch, numpy as np"):
    """``step(x, *rest)`` with ``body`` as its statements, captured by a
    ``with torch.cuda.graph`` block."""
    return (f"{head}\n\ndef step(x, *rest):\n"
            + textwrap.indent(textwrap.dedent(body), "    ")
            + "\n\ndef capture(graph, x):\n"
            "    with torch.cuda.graph(graph):\n        return step(x)\n")


# ------------------------------------------------------------- rule firing

def test_tl001_float_of_a_tensor_in_a_capture():
    assert rules_of(captured("return float(x) + 1")) == ["TL001"]


def test_tl001_item_in_a_compiled_function():
    assert rules_of("""
        import torch
        def body(x):
            return x.item()
        fast = torch.compile(body)
    """) == ["TL001"]


def test_tl001_skips_static_shape_math():
    # int(np.prod(...)) over metadata, x.shape, x.size(): host-side shape
    # math, not a scalar read
    assert rules_of(captured("""
        n = int(np.prod(rest[0]))
        m = int(x.shape[0]) + int(x.size(1)) + int(x.dim())
        return x[:n + m]
    """)) == []


def test_tl002_if_on_a_tensor_expression():
    assert rules_of(captured("""
        if torch.any(x > 0):
            return x
        return -x
    """)) == ["TL002"]


def test_tl002_allows_static_conditionals():
    assert rules_of(captured("""
        axis = rest[0] if rest else None
        if axis is not None:
            x = torch.sum(x, dim=axis)
        if torch.is_floating_point(x) and x.dim() == 2:
            x = x.float()
        if x.device.type == "cuda":
            x = x * 2
        return x
    """)) == []


def test_tl003_host_syncs():
    found = rules_of(captured("""
        y = np.asarray(x)
        print(x)
        torch.cuda.synchronize()
        z = x.cpu()
        return y, z
    """))
    assert found == ["TL003"] * 4


def test_tl004_dynamic_shapes_and_no_loop_rule():
    # TL004 replaces JL004: the output-size ops fire, an unrolled loop of
    # torch compute does not (a replay pays nothing for it)
    assert rules_of(captured("""
        a = torch.nonzero(x)
        b = x[x > 0]
        c = torch.unique(x)
        d = x.masked_select(x < 0)
        for _ in range(4):
            x = torch.tanh(x @ x)
        return a, b, c, d, x
    """)) == ["TL004"] * 4


def test_tl005_host_values_baked_in():
    assert rules_of(captured("""
        host = [1.0, 2.0]
        return (x + np.random.normal() + random.random()
                + torch.tensor(host, device=x.device)
                + torch.tensor(0.5, device=x.device))
    """, head="import torch, numpy as np, random")) \
        == ["TL005", "TL005", "TL005"]


def test_tl007_host_timer_in_capture():
    # host timers are their own rule (TL007, not TL005): the fix is to
    # time the replay, not to pass the value in
    assert rules_of(captured("""
        t0 = time.time()
        t1 = time.perf_counter()
        return x * (t1 - t0)
    """, head="import torch, time")) == ["TL007", "TL007"]


def test_tl007_span_context_in_capture():
    assert rules_of(captured("""
        tracer, stats = rest
        with tracer.span("step"):
            x = x * 2
        with stats.phase("shard"):
            x = x + 1
        with maybe_phase(stats, "listener"):
            x = x - 1
        return x
    """)) == ["TL007", "TL007", "TL007"]


def test_tl007_host_side_timing_is_clean():
    # the right place for a timer: on the host, around the replay
    assert rules_of("""
        import time, torch
        def timed_replay(graph):
            t0 = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
    """) == []


def test_tl006_rebound_static_input():
    assert rules_of("""
        import torch
        class Runner:
            def __init__(self, x):
                self.x = x
                self.graph = torch.cuda.CUDAGraph()

            def capture(self):
                self.x = self.x.contiguous()
                with torch.cuda.graph(self.graph):
                    self.out = self.x * 2

            def __call__(self, x):
                self.x = x
                self.graph.replay()
                return self.out
    """) == ["TL006"]


def test_tl006_accepts_a_copy_into_the_static_input():
    # writes in __init__ and in the capturing method are the capture's
    # own; a new input copied in place keeps the storage the graph reads
    assert rules_of("""
        import torch
        class Runner:
            def __init__(self, x):
                self.x = x
                self.graph = torch.cuda.CUDAGraph()

            def capture(self):
                self.x = self.x.contiguous()
                with torch.cuda.graph(self.graph):
                    self.out = self.x * 2

            def __call__(self, x):
                self.x.copy_(x)
                self.graph.replay()
                self.last = self.out.clone()
                return self.last
    """) == []


def test_decorated_compile_and_graphed_callables_are_captured():
    assert rules_of("""
        import torch
        @torch.compile(mode="reduce-overhead")
        def f(x):
            return bool(x)
    """) == ["TL001"]
    assert rules_of("""
        import torch
        def g(x):
            return x.tolist()
        graphed = torch.cuda.make_graphed_callables((g,), (torch.ones(1),))
    """) == ["TL001"]


def test_nested_function_inherits_captured_context():
    assert rules_of(captured("""
        def inner(y):
            return float(y)
        return inner(x)
    """)) == ["TL001"]


def test_method_called_from_a_capture_is_captured():
    assert rules_of("""
        import torch
        class Runner:
            def _step(self, x):
                return x.item()

            def capture(self, graph, x):
                with torch.cuda.graph(graph):
                    self.out = self._step(x)
    """) == ["TL001"]


def test_uncaptured_function_is_not_linted():
    # the same hazards OUTSIDE any captured context: no findings
    assert rules_of("""
        import numpy as np, time, torch
        def host_helper(x):
            t0 = time.time()
            if x.sum() > 0:
                x = float(x.sum()) + np.random.normal()
            torch.cuda.synchronize()
            return x, t0, torch.nonzero(x)
    """) == []


def test_cli_self_check_passes():
    """``--self-check``: every rule's bad fixture fires exactly its rule,
    every good twin is clean."""
    lines = []
    assert torchlint.self_check(report=lines.append) == 0, lines
    assert lines == ["torchlint --self-check: 11 rule fixtures OK"]


# ------------------------------------------------------------- suppression

def test_suppression_with_reason_silences():
    assert rules_of(captured(
        "return x.cpu()  # torchlint: disable=TL003 -- demo, never run")) \
        == []


def test_suppression_without_reason_is_tl000():
    assert rules_of(captured("return x.cpu()  # torchlint: disable=TL003")) \
        == ["TL000"]


def test_tl006_suppressible_on_its_line():
    src = """
        import torch
        class Runner:
            def capture(self, graph):
                with torch.cuda.graph(graph):
                    self.out = self.x * 2

            def reset(self, x):
                self.x = x{}
    """
    assert rules_of(src.format(
        "  # torchlint: disable=TL006 -- capture() runs again next")) == []
    assert rules_of(src.format("")) == ["TL006"]


def test_suppress_all():
    assert rules_of(captured(
        "return float(x)  # torchlint: disable=all -- test scaffolding")) \
        == []


def test_suppression_only_covers_its_line():
    assert rules_of(captured("""
        a = float(x)  # torchlint: disable=TL001 -- known host scalar
        b = float(rest[0])
        return a + b
    """)) == ["TL001"]


# ------------------------------------------------- TL008 stale suppressions

def test_tl008_stale_suppression_fires():
    assert rules_of(captured(
        "return x + 1  # torchlint: disable=TL001 -- was a read once")) \
        == ["TL008"]


def test_tl008_live_suppression_is_silent():
    assert rules_of(captured(
        "return float(x)  # torchlint: disable=TL001 -- known host scalar")) \
        == []


def test_tl008_stale_disable_all_fires():
    assert rules_of(captured(
        "return x + 1  # torchlint: disable=all -- nothing to silence")) \
        == ["TL008"]


def test_tl008_partial_stale_names_only_the_dead_id():
    findings = lint_source(captured(
        "return float(x)  # torchlint: disable=TL001,TL004 -- mixed"),
        "snippet.py")
    assert [f.rule for f in findings] == ["TL008"]
    assert "TL004" in findings[0].message
    assert "TL001" not in findings[0].message


def test_tl008_reasonless_and_stale_both_fire():
    assert sorted(rules_of(captured(
        "return x + 1  # torchlint: disable=TL001"))) == ["TL000", "TL008"]


# ------------------------------------------------ autograd.Function rules

FUNCTION = """
import torch
from torch.autograd.function import once_differentiable
from deeplearning4j_tpu_torch.analysis.steprecord import note_launch


def _launch(x):
    return x * 3


def kernel_fwd(x):
    if x.is_cuda:
        return _launch(x)
    note_launch("k", "plain", 0, x)
    return x * 3


def kernel_bwd(g):
    note_launch("k_bwd", "kernel", 0, g)
    return g * 3


def wrapper(g):
    return kernel_bwd(g)


class Triple(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, flag):
        {save}
        return kernel_fwd(x) * scale

    @staticmethod{once}
    def backward(ctx, grad):
        {read}
        return {ret}
"""


def function(save="ctx.save_for_backward(x)", read="x, = ctx.saved_tensors",
             once="\n    @once_differentiable",
             ret="wrapper(grad) * x, None, None"):
    return FUNCTION.format(save=save, read=read, once=once, ret=ret)


def test_a_well_formed_kernel_function_is_clean():
    assert rules_of(function()) == []


@pytest.mark.parametrize("ret,want", [
    ("wrapper(grad) * x, None", ["TL009"]),
    ("(wrapper(grad) * x, None, None, None)", ["TL009"]),
    ("wrapper(grad) * x, None, None", []),
    ("helper(grad, x)", []),           # not a literal tuple: not counted
])
def test_tl009_gradient_count(ret, want):
    assert rules_of(function(ret=ret)) == want


def test_tl009_counts_forward_inputs_without_ctx_under_setup_context():
    src = """
        import torch
        class Mul(torch.autograd.Function):
            @staticmethod
            def forward(x, y):
                return x * y

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.save_for_backward(*inputs)

            @staticmethod
            def backward(ctx, grad):
                x, y = ctx.saved_tensors
                return {}
    """
    assert rules_of(src.format("grad * y, grad * x")) == []
    assert rules_of(src.format("(grad * y,)")) == ["TL009"]


def test_tl010_saved_tensors_mismatch():
    assert rules_of(function(save="ctx.scale = scale")) == ["TL010"]
    assert rules_of(function(read="x = None",
                             ret="wrapper(grad), None, None")) == ["TL010"]


def test_tl011_kernel_backward_needs_once_differentiable():
    # wrapper() reaches kernel_bwd(), whose note_launch is a "kernel" one
    assert rules_of(function(once="")) == ["TL011"]
    # a backward that reaches only a plain launch (or none) needs nothing
    plain = function(once="", ret="grad * 3 * x, None, None")
    assert rules_of(plain) == []


def test_the_ports_functions_and_captures_are_found():
    """What the sweep looks at on the port's tree: the two capture blocks
    and the methods they call, the seams, and every autograd.Function."""
    import ast
    from deeplearning4j_tpu_torch.analysis.source_lint import LintContext
    seen, functions = {}, {}
    for f in sorted(PKG.rglob("*.py")):
        tree = ast.parse(f.read_text())
        scopes = torchlint._Scopes()
        scopes.visit(tree)
        ctx = LintContext(path=str(f), suppressed={},
                          severity=torchlint.RULE_SEVERITY)
        roots, _ = torchlint._captured_roots(
            tree, scopes, torchlint.seams_for(str(f)), ctx)
        assert ctx.findings == []
        rel = str(f.relative_to(PKG))
        names = sorted(q for i, q in scopes.qualname.items() if i in roots)
        if names:
            seen[rel] = names
        classes = [c.name for c in ast.walk(tree)
                   if isinstance(c, ast.ClassDef)
                   and torchlint._is_autograd_function(c)]
        if classes:
            functions[rel] = classes
    assert seen == {
        "keras/batching.py": ["PredictRunner._infer"],
        "keras/generation.py": ["StepRunner._step"],
        "nn/graph.py": ["ComputationGraph._infer_fn.infer",
                        "ComputationGraph.decode_fns.decode",
                        "ComputationGraph.decode_fns.prefill",
                        "ComputationGraph.paged_decode_fn.paged_decode"],
        "nn/multilayer.py": ["MultiLayerNetwork._infer_fn.infer"],
    }
    assert functions == {
        "ops/flash_attention.py": ["FlashAttentionFunction"],
        "ops/fused_lstm.py": ["FusedLSTMFunction"],
        "parallel/mesh.py": ["_SumOverRanks", "_SumForward", "_CopyToGroup",
                             "_GatherDim", "_GatherReduceScatter",
                             "_RingShift", "_SendStage", "_RecvStage"],
        "parallel/sequence.py": ["_Tie"],
    }


# ------------------------------------------------------------ the seams

def test_every_seam_resolves_and_mirrors_a_jax_jit_site():
    """Each seam names a function of its file in the port's tree, and the
    reference site it mirrors (``path:line``) holds a ``jax.jit``."""
    import ast
    for seam in SEAMS:
        tree = ast.parse((PKG / seam.path).read_text())
        scopes = torchlint._Scopes()
        scopes.visit(tree)
        assert seam.qualname in scopes.by_qualname, seam
        m = re.match(r"(deeplearning4j_tpu/\S+):(\d+)", seam.mirrors)
        assert m, seam
        lines = (ROOT / m.group(1)).read_text().splitlines()
        assert "jax.jit" in lines[int(m.group(2)) - 1], seam


def test_a_seam_that_names_nothing_is_a_finding():
    src = "import torch\n\nclass Net:\n    def infer_fn(self):\n" \
          "        def infer(x):\n            return x.item()\n" \
          "        return infer\n"
    live = Seam("net.py", "Net.infer_fn.infer", "a jit site")
    gone = Seam("net.py", "Net.old_fn.infer", "a jit site")
    assert rules_of(src, seams=[live]) == ["TL001"]
    findings = lint_source(src, "net.py", seams=[gone])
    assert [(f.rule, f.location) for f in findings] == [("TL008", "net.py:0")]
    assert "Net.old_fn.infer" in findings[0].message
    assert [s.qualname for s in torchlint.seams_for("a/nn/graph.py")] == [
        s.qualname for s in SEAMS if s.path == "nn/graph.py"]


# ---------------------------------------------------------------- the gate

def test_port_source_tree_is_lint_clean():
    """The acceptance gate: no unsuppressed finding over the port's
    package. New code that trips a rule must be fixed or carry a reasoned
    suppression."""
    findings = lint_paths([str(PKG)])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_suppressions_carry_reasons_and_name_rules():
    """Every torchlint / lockcheck suppression in the port's tree names its
    rules (never ``all``) and gives a reason."""
    pat = re.compile(r"#\s*(torchlint|lockcheck):\s*disable=([^#]*)")
    for f in sorted(PKG.rglob("*.py")):
        for n, line in enumerate(f.read_text().splitlines(), 1):
            m = pat.search(line)
            if not m or f.name in ("torchlint.py", "lockcheck.py",
                                   "source_lint.py", "fixtures.py"):
                continue
            ids, _, reason = m.group(2).partition("--")
            where = f"{f.relative_to(ROOT)}:{n}"
            assert reason.strip(), where
            assert "all" not in ids.lower().split(","), where
            assert all(re.fullmatch(r"(TL|LC)\d{3}", i.strip())
                       for i in ids.split(",")), where


def test_rule_table_is_complete():
    assert set(RULES) == {f"TL{i:03d}" for i in range(12)}
    assert set(torchlint.RULE_SEVERITY) == set(RULES)
    assert set(torchlint.JAX_RULE) == set(RULES)
