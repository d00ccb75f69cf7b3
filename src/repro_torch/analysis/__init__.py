"""repro_torch.analysis — the codesign lint engine of the PyTorch/CUDA port.

Static checks that turn the paper's co-design guidelines and the port's
kernel/obs contracts into a CI gate, with the JAX package's rule IDs, CLI
and `Finding` / `AnalysisResult` API:

  * **shape audit** (SHP1xx): every registered config's vocab / head_dim /
    d_ff / expert / SSM shapes against the target hardware's tile geometry
    (the H100 by default), violations priced through the analytic GEMM
    model;
  * **kernel contract** (KRN1xx): the CUDA sources' accumulators and
    tensor-core products (f32, s32 for int8), the wrappers' launch
    geometry against what the sources instantiate, and the cross-module
    tuned-op contract (ops lookup <-> autotuner <-> candidates lattice <->
    shared-memory / instantiated-tile bound);
  * **capture hygiene** (JIT2xx): obs instrumentation, host RNG/clocks,
    mutable defaults and mutated-global capture in code torch.compile
    traces or a CUDA graph captures.

Run it:  ``python -m repro_torch.analysis --fail-on error`` (the package)
Suppress: ``# repro: noqa[RULE]`` on the offending line (``//`` in CUDA).
Catalog:  ``python -m repro_torch.analysis --list-rules``.
"""
from .engine import AnalysisResult, analyze
from .findings import (Finding, count_by_severity, severity_at_least,
                       sort_findings, worst_severity)
from .rules import RULES, Rule, get_rule
from .shape_audit import audit_config, audit_registry

__all__ = [
    "analyze", "AnalysisResult", "Finding", "RULES", "Rule", "get_rule",
    "audit_config", "audit_registry", "sort_findings", "count_by_severity",
    "severity_at_least", "worst_severity",
]
