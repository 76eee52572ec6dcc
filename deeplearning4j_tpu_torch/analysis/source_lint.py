"""source_lint: the machinery the port's source lints share (the JAX
package's ``analysis/source_lint.py``, kept as the port's own copy).

torchlint (TL rules: hazards in code a CUDA graph captures and in
``torch.autograd.Function``s) and lockcheck (LC rules: concurrency
hazards in the threaded host code) share one suppression and reporting
discipline:

- inline suppressions: ``# <tool>: disable=<RULE>[,<RULE>] -- <reason>``
  (``disable=all`` silences every rule on the line)
- the reason is mandatory: a reasonless suppression fires the tool's
  meta rule (TL000 / LC000)
- used-suppression tracking: a suppression must silence a finding on
  its line, or the tool's stale-suppression rule (TL008 / LC007) flags
  it before it can swallow a future finding of that rule

The grammar, the messages and the order of the findings are the JAX
package's, so both packages' lockcheck report the same findings on the
same source.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set

from deeplearning4j_tpu_torch.analysis.findings import Finding, Severity


def make_suppress_re(tool: str) -> "re.Pattern[str]":
    """The inline-suppression comment pattern for one tool name,
    e.g. ``# torchlint: disable=TL004 -- shape fixed by the bucket``."""
    return re.compile(
        r"#\s*" + re.escape(tool)
        + r":\s*disable=([A-Za-z0-9_,\s]+?)(?:\s*--\s*(.*))?$")


def collect_suppressions(source: str, findings: List[Finding], path: str,
                         suppress_re: "re.Pattern[str]", meta_rule: str,
                         meta_severity: Severity) -> Dict[int, Set[str]]:
    """line -> suppressed rule ids ({'all'} suppresses everything).
    Reasonless suppressions produce ``meta_rule`` findings."""
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = suppress_re.search(tok.string)
            if not m:
                continue
            ids = {s.strip().upper() if s.strip().lower() != "all" else "all"
                   for s in m.group(1).split(",") if s.strip()}
            out.setdefault(tok.start[0], set()).update(ids)
            if not (m.group(2) or "").strip():
                findings.append(Finding(
                    meta_rule, meta_severity,
                    f"{path}:{tok.start[0]}",
                    "suppression without a reason",
                    "append '-- <why this is safe>' to the comment"))
    except tokenize.TokenError:
        pass
    return out


@dataclass
class LintContext:
    """Per-file lint state: suppression table in, findings out, plus the
    used-suppression ledger the stale-suppression post-pass reads."""
    path: str
    suppressed: Dict[int, Set[str]]
    severity: Dict[str, Severity]
    findings: List[Finding] = field(default_factory=list)
    # line -> suppression ids that actually silenced a finding there;
    # the stale-suppression post-pass reports the declared-but-unused
    # remainder
    used: Dict[int, Set[str]] = field(default_factory=dict)

    def emit(self, rule: str, node: ast.AST, message: str, hint: str = ""):
        line = getattr(node, "lineno", 0)
        dis = self.suppressed.get(line, set())
        if "all" in dis or rule in dis:
            self.used.setdefault(line, set()).update(
                dis & {"all", rule})
            return
        self.findings.append(Finding(
            rule, self.severity[rule], f"{self.path}:{line}", message, hint))


def stale_suppression_pass(ctx: LintContext, stale_rule: str) -> None:
    """Flag suppressions that silenced nothing on their line. A
    ``disable=all`` is live if ANY finding was swallowed there; explicit
    ids are checked one by one. ``disable=<stale_rule>`` on the line
    opts the line out (self-referential suppressions cannot be
    "used")."""
    for line, ids in sorted(ctx.suppressed.items()):
        if stale_rule in ids or "all" in ids and ctx.used.get(line):
            continue
        stale = sorted(
            i for i in ids
            if i not in ctx.used.get(line, set())
            and (i != "all" or not ctx.used.get(line)))
        if stale:
            ctx.findings.append(Finding(
                stale_rule, ctx.severity[stale_rule], f"{ctx.path}:{line}",
                "suppression suppresses nothing on this line "
                f"({', '.join('all' if s == 'all' else s for s in stale)}"
                " never fired here)",
                "delete the stale comment — it would silently swallow "
                "a future finding of that rule"))


def sort_findings(findings: List[Finding]) -> None:
    """Stable file-then-line order, shared by every per-file linter."""
    findings.sort(key=lambda f: (f.location.rsplit(":", 1)[0],
                                 int(f.location.rsplit(":", 1)[1])))


def iter_py_files(paths: List[str]) -> List[Path]:
    """The .py files under the given files/directories, sorted."""
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        else:
            files.append(pp)
    return files


def dotted(node: ast.AST) -> Optional[str]:
    """'jax.lax.scan' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
