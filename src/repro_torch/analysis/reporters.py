"""Finding reporters: human text and machine JSON."""
from __future__ import annotations

import json
from typing import List, Optional, TextIO

from .findings import Finding, count_by_severity, sort_findings

_SEV_TAG = {"info": "I", "warn": "W", "error": "E"}


def render_text(findings: List[Finding], stream: TextIO,
                verbose: bool = True) -> None:
    """flake8-style `file:line: SEV RULE message` lines, worst first."""
    for f in sort_findings(findings):
        tag = _SEV_TAG.get(f.severity, "?")
        arch = f" [{f.arch}]" if f.arch and f"[{f.arch}]" not in f.message \
            else ""
        stream.write(f"{f.file}:{f.line}: {tag} {f.rule_id}{arch} "
                     f"{f.message}\n")
        if verbose and f.fix_hint:
            stream.write(f"    fix: {f.fix_hint}\n")
    counts = count_by_severity(findings)
    total = len(findings)
    if total:
        stream.write(
            f"\n{total} finding{'s' if total != 1 else ''} "
            f"({counts['error']} error, {counts['warn']} warn, "
            f"{counts['info']} info)\n")
    else:
        stream.write("no findings\n")


def render_json(findings: List[Finding], stream: TextIO,
                meta: Optional[dict] = None) -> None:
    doc = {
        "findings": [f.to_json() for f in sort_findings(findings)],
        "counts": count_by_severity(findings),
    }
    if meta:
        doc["meta"] = meta
    json.dump(doc, stream, indent=2, sort_keys=True)
    stream.write("\n")
