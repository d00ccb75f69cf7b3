"""CLI: ``python -m repro_torch.analysis [PATHS] --fail-on {warn,error}``.

Exit status: 1 when any finding at or above the ``--fail-on`` threshold
survives suppression, else 0 — this is the CI gate.  ``--format json``
emits the machine report (uploaded as a CI artifact); ``--list-rules``
prints the rule catalog.  With no PATHS it scans the port's own package
(Python and CUDA sources), wherever it is run from.
"""
from __future__ import annotations

import argparse
import sys

from .engine import PACKAGE_DIR, analyze
from .findings import count_by_severity, severity_at_least
from .reporters import render_json, render_text
from .rules import RULES


def _list_rules(stream) -> None:
    by_pass = {}
    for r in RULES.values():
        by_pass.setdefault(r.pass_name, []).append(r)
    for pass_name in ("shape", "kernel", "jit", "engine"):
        stream.write(f"[{pass_name}]\n")
        for r in sorted(by_pass.get(pass_name, []),
                        key=lambda r: r.rule_id):
            stream.write(f"  {r.rule_id}  {r.name:<28} "
                         f"{r.default_severity:<5} {r.doc}\n")
    stream.write("\nsuppress with: `# repro: noqa[RULE]` "
                 "(comma-separate for several; bare noqa = all)\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="codesign lint: shape efficiency, CUDA kernel and "
                    "tuned-op contract, torch.compile / CUDA graph capture "
                    "hygiene")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to scan (default: the "
                         "repro_torch package)")
    ap.add_argument("--fail-on", choices=("warn", "error"), default="error",
                    help="exit 1 when a finding at/above this severity "
                         "survives (default: error)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--output", default=None,
                    help="write the report here instead of stdout")
    ap.add_argument("--hw", default="h100",
                    help="hardware target for the shape audit: h100, "
                         "a100, v100 or tpu_v5e (default: h100)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree for the shape audit")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule IDs to run (default: all)")
    ap.add_argument("--no-registry-audit", action="store_true",
                    help="skip the SHP config-registry audit")
    ap.add_argument("--no-smoke", action="store_true",
                    help="exclude smoke configs from the shape audit")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        _list_rules(sys.stdout)
        return 0

    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(RULES)
        if unknown:
            ap.error(f"unknown rule id(s): {sorted(unknown)}")

    paths = args.paths or [PACKAGE_DIR]
    result = analyze(paths, registry_audit=not args.no_registry_audit,
                     hw_name=args.hw, tp=args.tp,
                     include_smoke=not args.no_smoke, rules=rules)

    stream = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.format == "json":
            render_json(result.findings, stream, meta={
                "paths": paths, "hw": args.hw, "tp": args.tp,
                "fail_on": args.fail_on,
                "files_scanned": result.files_scanned})
        else:
            render_text(result.findings, stream)
    finally:
        if args.output:
            stream.close()

    gating = [f for f in result.findings
              if severity_at_least(f.severity, args.fail_on)]
    if gating:
        counts = count_by_severity(gating)
        sys.stderr.write(
            f"FAIL: {len(gating)} finding(s) at severity >= "
            f"{args.fail_on} ({counts['error']} error, "
            f"{counts['warn']} warn)\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
