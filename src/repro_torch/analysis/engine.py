"""Orchestrator: run every pass over a file set, apply suppressions.

`analyze()` is the one entry point the CLI, the tests and chip_smoke's
`analysis` phase share.  Pass order:

  1. engine checks (ANA001 parse errors of Python files, ANA002 bad pragmas
     of any file) per file;
  2. per-file passes — kernel contract over CUDA sources (KRN101-102) and
     capture hygiene over Python (JIT2xx);
  3. the cross-module checks over the whole set: launch geometry (KRN103:
     wrappers' tiles against their CUDA sources) and the tuned-op contract
     (KRN104-107);
  4. the registry shape audit (SHP1xx), unless disabled — it is keyed on
     the port's config *registry*, not the scanned paths.

Per-line pragmas (`# repro: noqa[...]`, `// repro: noqa[...]` in CUDA) are
applied to the other passes' findings here (the shape audit applies its
own, since its findings are anchored across files it did not scan).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Set

from . import jit_hygiene, kernel_contract
from .findings import Finding, sort_findings
from .source import SourceFile, engine_findings, iter_cuda_files, iter_python_files, \
    load_source

# the port's own package: what a bare `python -m repro_torch.analysis` scans
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    files_scanned: int

    def with_rules(self, rule_ids: Set[str]) -> "AnalysisResult":
        return AnalysisResult(
            [f for f in self.findings if f.rule_id in rule_ids],
            self.files_scanned)


def _suppressed(sf: SourceFile, f: Finding) -> bool:
    return sf.suppressions.is_suppressed(f.line, f.rule_id)


def analyze(paths: Sequence[str] = (PACKAGE_DIR,), registry_audit: bool = True,
            hw_name: str = "h100", tp: int = 1,
            include_smoke: bool = True,
            rules: Optional[Set[str]] = None) -> AnalysisResult:
    files = [load_source(p) for p in iter_python_files(list(paths))
             + iter_cuda_files(list(paths))]
    findings: List[Finding] = []

    for sf in files:
        findings.extend(engine_findings(sf))
        if sf.tree is None and not sf.is_cuda:
            continue
        for f in kernel_contract.check_file(sf) + jit_hygiene.check_file(sf):
            if not _suppressed(sf, f):
                findings.append(f)

    by_path = {sf.path: sf for sf in files}
    for f in (kernel_contract.check_launch_geometry(files)
              + kernel_contract.check_tuned_contract(files)):
        sf = by_path.get(f.file)
        if sf is None or not _suppressed(sf, f):
            findings.append(f)

    if registry_audit:
        from .shape_audit import audit_registry
        findings.extend(audit_registry(hw_name=hw_name, tp=tp,
                                       include_smoke=include_smoke))

    if rules is not None:
        findings = [f for f in findings if f.rule_id in rules]
    return AnalysisResult(sort_findings(findings), len(files))
