"""Finding: one static-analysis diagnostic (the JAX package's
``analysis/findings.py``, kept as the port's own copy). It carries a
stable rule id, a severity, a location (a layer or vertex name, or a
mesh term such as ``dp=8``), the defect and a hint: the config-time
checks of the reference (``InputType.getOutputType``, the preprocessor
insertion), collected instead of raised on the first."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class Severity:
    """Ordered severities. ``ERROR`` findings gate (the CLI exits 1);
    ``WARNING`` and ``INFO`` inform."""
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _ORDER = {ERROR: 2, WARNING: 1, INFO: 0}

    @classmethod
    def rank(cls, s: str) -> int:
        return cls._ORDER[s]


@dataclass
class Finding:
    rule: str                 # stable id, e.g. "GC002"
    severity: str             # Severity.ERROR | WARNING | INFO
    location: str             # layer / vertex name, or a mesh term
    message: str              # what is wrong
    hint: str = ""            # how to fix it

    def __str__(self) -> str:
        s = f"{self.location}: {self.severity}: {self.message} [{self.rule}]"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


def max_severity(findings: List[Finding]) -> Optional[str]:
    """The highest severity present, or None for an empty list."""
    if not findings:
        return None
    return max(findings, key=lambda f: Severity.rank(f.severity)).severity


def has_errors(findings: List[Finding]) -> bool:
    return any(f.severity == Severity.ERROR for f in findings)


def format_findings(findings: List[Finding], header: str = "") -> str:
    lines = [header] if header else []
    lines += [str(f) for f in findings]
    n_err = sum(f.severity == Severity.ERROR for f in findings)
    n_warn = sum(f.severity == Severity.WARNING for f in findings)
    lines.append(f"{len(findings)} finding(s): {n_err} error(s), "
                 f"{n_warn} warning(s)")
    return "\n".join(lines)
