"""Summarize an observability dump:

    PYTHONPATH=src python -m repro_torch.obs.view OBS_DUMP_DIR [--top 12]

Reads the files `obs.export_all` wrote (trace.json, metrics.json, and
optionally drift.json / compiles.json) and prints:

  * top spans — total/mean/p50/p99 wall time grouped by span name;
  * step-time percentiles — the `decode_step` spans (the engine's
    steady-state heartbeat);
  * kernel dispatch table — which impl (the CUDA kernel or the plain
    version) and launch geometry every kernel wrapper call chose, one row
    per distinct (op, impl, shape) (from the `dispatch` instant events);
  * compile table — every recorded kernel-library build (the sources'
    digest, wall time, whether the watchdog was armed);
  * drift table — predicted vs measured per engine program site, with the
    calibration-free `rel_drift` column (see `obs.drift`).

`render_summary` returns the same report as lines.  The JAX package's
`obs/view.py`, with the same tables.
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np


def _load(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def top_spans(trace: dict, top: int = 12) -> List[str]:
    by_name = defaultdict(list)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X":
            by_name[ev["name"]].append(ev["dur"])
    out = ["| span | count | total ms | mean ms | p50 ms | p99 ms |",
           "|---|---|---|---|---|---|"]
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    for name, durs in ranked:
        out.append(f"| {name} | {len(durs)} | {sum(durs) / 1e3:.2f} "
                   f"| {sum(durs) / len(durs) / 1e3:.3f} "
                   f"| {_pct(durs, 50) / 1e3:.3f} "
                   f"| {_pct(durs, 99) / 1e3:.3f} |")
    if len(out) == 2:
        out.append("| (no spans) | | | | | |")
    return out


def step_percentiles(trace: dict, name: str = "decode_step") -> List[str]:
    durs = [ev["dur"] for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev["name"] == name]
    if not durs:
        return [f"(no `{name}` spans)"]
    return [f"{name}: {len(durs)} steps | "
            f"p50 {_pct(durs, 50) / 1e3:.3f} ms | "
            f"p90 {_pct(durs, 90) / 1e3:.3f} ms | "
            f"p99 {_pct(durs, 99) / 1e3:.3f} ms | "
            f"mean {sum(durs) / len(durs) / 1e3:.3f} ms"]


def dispatch_table(trace: dict, top: int = 20) -> List[str]:
    rows = [ev for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "i" and ev.get("cat") == "dispatch"]
    if not rows:
        return ["(no dispatch records — kernels ran with obs disabled or "
                "on the jnp path)"]
    seen = {}
    for ev in rows:
        a = ev.get("args", {})
        key = (ev["name"], a.get("impl"), tuple(a.get("shape", [])))
        if key not in seen:
            seen[key] = a
    out = ["| op | impl | shape | blocks | tuned hit |",
           "|---|---|---|---|---|"]
    for (op, impl, shape), a in list(seen.items())[:top]:
        blocks = ",".join(f"{k}={v}" for k, v in a.get("blocks", {}).items())
        out.append(f"| {op} | {impl} | {'x'.join(map(str, shape))} "
                   f"| {blocks or '-'} | {a.get('tuned_hit')} |")
    return out


def compile_table(compiles: Optional[dict], trace: dict) -> List[str]:
    recs = None
    if compiles is not None:
        recs = [(r["key"], r["wall_s"], r["armed"])
                for r in compiles.get("records", [])]
    else:  # fall back to the mirrored trace instants
        recs = [(ev["args"].get("key", "?"), ev["args"].get("wall_s", 0.0),
                 ev["args"].get("armed", False))
                for ev in trace.get("traceEvents", [])
                if ev.get("ph") == "i" and ev.get("cat") == "compile"]
    if not recs:
        return ["(no compiles recorded)"]
    out = ["| program | compile ms | armed |", "|---|---|---|"]
    for key, wall_s, armed in recs:
        flag = "**VIOLATION**" if armed else ""
        out.append(f"| {key[:90]} | {wall_s * 1e3:.1f} | {flag} |")
    n_armed = sum(1 for _, _, a in recs if a)
    out.append("")
    out.append(f"{len(recs)} compiles total, {n_armed} while armed.")
    return out


def drift_table(drift: Optional[dict]) -> List[str]:
    if not drift or not drift.get("rows"):
        return ["(no drift data — run the engine with obs enabled)"]
    out = [f"hardware model: {drift.get('hw_name', '?')}", "",
           "| site | count | predicted ms | measured p50 ms | ratio | "
           "rel drift |", "|---|---|---|---|---|---|"]
    for r in drift["rows"]:
        ratio = f"{r['ratio']:.1f}x" if r.get("ratio") else "n/a"
        rel = f"{r['rel_drift']:.2f}" if r.get("rel_drift") else "n/a"
        out.append(f"| {r['site']} | {r['count']} | {r['predicted_ms']:.3f} "
                   f"| {r['measured_p50_ms']:.3f} | {ratio} | {rel} |")
    return out


def metrics_lines(metrics: Optional[dict]) -> List[str]:
    if not metrics:
        return ["(no metrics.json)"]
    out = []
    if metrics.get("counters"):
        out.append("counters: " + ", ".join(
            f"{k}={v:g}" for k, v in metrics["counters"].items()))
    if metrics.get("gauges"):
        out.append("gauges: " + ", ".join(
            f"{k}={v:g}" for k, v in metrics["gauges"].items()))
    for name, s in (metrics.get("histograms") or {}).items():
        if s.get("count"):
            out.append(f"hist {name}: n={s['count']} mean={s['mean']:.4g} "
                       f"p50={s['p50']:.4g} p99={s['p99']:.4g} "
                       f"std={s['std']:.4g}")
        else:
            out.append(f"hist {name}: empty")
    return out or ["(empty metrics)"]


def render_summary(dump_dir: str, top: int = 12) -> List[str]:
    """The full report as markdown-ish lines (the CLI prints these)."""
    trace = _load(os.path.join(dump_dir, "trace.json")) or {}
    metrics = _load(os.path.join(dump_dir, "metrics.json"))
    drift = _load(os.path.join(dump_dir, "drift.json"))
    compiles = _load(os.path.join(dump_dir, "compiles.json"))

    out = [f"# obs summary: {dump_dir}", ""]
    out += ["## Top spans", ""] + top_spans(trace, top) + [""]
    out += ["## Step time", ""] + step_percentiles(trace) + [""]
    out += ["## Kernel dispatch", ""] + dispatch_table(trace) + [""]
    out += ["## Compiles", ""] + compile_table(compiles, trace) + [""]
    out += ["## Drift (predicted vs measured)", ""] + drift_table(drift) + [""]
    out += ["## Metrics", ""] + metrics_lines(metrics)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize an obs.export_all dump directory.")
    ap.add_argument("dump_dir", help="directory written by obs.export_all")
    ap.add_argument("--top", type=int, default=12,
                    help="span rows in the top-spans table")
    args = ap.parse_args(argv)
    trace_path = os.path.join(args.dump_dir, "trace.json")
    if not os.path.exists(trace_path):
        ap.error(f"{trace_path} not found — did obs.export_all run?")
    try:
        print("\n".join(render_summary(args.dump_dir, args.top)))
    except BrokenPipeError:  # `view DIR | head` closing the pipe is fine
        os.close(1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
