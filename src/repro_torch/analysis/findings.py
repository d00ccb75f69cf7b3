"""Finding model for the codesign lint engine.

A `Finding` is one rule violation anchored to a source location.  Severities
are ordered (`info < warn < error`) so the CLI's `--fail-on` threshold and
the reporters can sort/filter without string games.  Shape-audit findings
additionally carry the architecture name (`arch`) they were raised for, and
— wherever the analytic cost model can price the fix — a `fix_hint` that
quotes the predicted gain (e.g. "pad vocab 50257 -> 50304, est. +4.1%
lm_head GEMM").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SEVERITIES = ("info", "warn", "error")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}


def severity_at_least(sev: str, threshold: str) -> bool:
    return _SEV_ORDER[sev] >= _SEV_ORDER[threshold]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at file:line."""

    file: str
    line: int
    rule_id: str
    severity: str  # info | warn | error
    message: str
    fix_hint: str = ""
    arch: str = ""  # config name, for registry-audit findings

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def sort_key(self):
        return (-_SEV_ORDER[self.severity], self.file, self.line, self.rule_id)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(**d)


def sort_findings(findings) -> list:
    return sorted(findings, key=lambda f: f.sort_key)


def count_by_severity(findings) -> dict:
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] += 1
    return counts


def worst_severity(findings) -> Optional[str]:
    worst = None
    for f in findings:
        if worst is None or _SEV_ORDER[f.severity] > _SEV_ORDER[worst]:
            worst = f.severity
    return worst
