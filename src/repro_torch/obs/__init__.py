"""Observability layer of the port: span tracing, metrics, the build
watchdog, drift (the JAX package's `obs`, same names and API).

  * `obs.trace`         — nestable host-clock spans, exported as Chrome
    trace-event JSON (Perfetto-loadable) with `torch.profiler.record_function`
    pass-through, so a `torch.profiler` capture puts each CUDA kernel under
    the engine site that launched it;
  * `obs.metrics`       — counters / gauges / histograms with JSON and
    Prometheus text snapshots;
  * `obs.compile_watch` — records every kernel-library build
    (`kernels/_build.py`) and, when armed, *fails* on one;
  * `obs.drift`         — predicted (analytic / MeasuredProfile, at the
    H100) vs measured step time, per engine step shape;
  * `obs.view`          — `python -m repro_torch.obs.view DUMP_DIR`
    summarizes a dump (top spans, step percentiles, dispatch table, build
    table, drift table).

Everything is OFF by default and costs one bool check when disabled:
instrumented call sites test `obs.enabled()` (or take the shared no-op span)
before they build an event — no events, no allocation, no device sync.
`obs.enable()` flips the flag (or set REPRO_OBS=1 before launch).

`record_dispatch` records each distinct (op, impl, site, shape, blocks) once
per `enable()`: the JAX package calls it once per lowered program, and the
eager port, which reaches the wrapper on every launch (~1,600 a serve
pass), would otherwise flood the trace buffer.  `dispatch.{op}.{impl}` so
counts distinct launch shapes, as JAX's counts programs; the wrappers'
own launch counters keep counting launches.

    from repro_torch import obs
    obs.enable()
    ... run the engine / train loop ...
    obs.export_all("obs_dump", drift=engine.drift)
    # then: python -m repro_torch.obs.view obs_dump
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from .compile_watch import CompileRecord, CompileWatch, UnexpectedCompile
from .drift import DriftMonitor
from .metrics import REGISTRY, MetricsRegistry
from .trace import NULL_SPAN, Tracer

__all__ = [
    "enable", "disable", "enabled", "span", "instant", "counter", "gauge",
    "histogram", "record_dispatch", "get_tracer", "get_metrics",
    "export_all", "reset", "Tracer", "MetricsRegistry", "CompileWatch",
    "CompileRecord", "UnexpectedCompile", "DriftMonitor", "NULL_SPAN",
]

_enabled = os.environ.get("REPRO_OBS", "") not in ("", "0")
_tracer = Tracer()
_dispatched: set = set()     # record_dispatch keys seen since enable()


def enable(capacity: Optional[int] = None,
           annotate_device: bool = True) -> None:
    """Turn instrumentation on (optionally resizing the trace buffer)."""
    global _enabled, _tracer
    if capacity is not None and capacity != _tracer.capacity:
        _tracer = Tracer(capacity=capacity, annotate_device=annotate_device)
    else:
        _tracer.annotate_device = annotate_device
    _dispatched.clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def get_tracer() -> Tracer:
    return _tracer


def get_metrics() -> MetricsRegistry:
    return REGISTRY


# -- hot-path helpers: one bool check when disabled ---------------------------


def span(name: str, cat: str = "engine", **args):
    """Timed span context manager; shared no-op when disabled."""
    if not _enabled:
        return NULL_SPAN
    return _tracer.span(name, cat, **args)


def instant(name: str, cat: str = "engine", **args) -> None:
    if _enabled:
        _tracer.instant(name, cat, **args)


def counter(name: str):
    return REGISTRY.counter(name)


def gauge(name: str):
    return REGISTRY.gauge(name)


def histogram(name: str, sample_cap: int = 1024):
    return REGISTRY.histogram(name, sample_cap)


def record_dispatch(op: str, *, impl: str, shape, site: str = "",
                    blocks: Optional[Dict[str, int]] = None,
                    tuned_hit: Optional[bool] = None) -> None:
    """Annotate one kernel-dispatch decision (op, impl — "cuda" for the
    hand-written kernel, "plain" for its plain PyTorch version — problem
    shape, and the launch geometry).  Called from the kernel wrappers; each
    distinct (op, impl, site, shape, blocks) is recorded once per
    `enable()`, so the dump shows exactly which impl and geometry every
    model site ended up with, however many launches it took."""
    if not _enabled:
        return
    key = (op, impl, site, tuple(shape), tuple(sorted((blocks or {}).items())))
    if key in _dispatched:
        return
    _dispatched.add(key)
    REGISTRY.counter(f"dispatch.{op}.{impl}").inc()
    if tuned_hit is not None:
        REGISTRY.counter(
            f"dispatch.{op}.cache_{'hit' if tuned_hit else 'miss'}").inc()
    _tracer.instant(op, cat="dispatch", impl=impl, site=site,
                    shape=list(shape), blocks=dict(blocks or {}),
                    tuned_hit=tuned_hit)


# -- export -------------------------------------------------------------------


def export_all(dump_dir: str, *, drift: Optional[DriftMonitor] = None,
               watch: Optional[CompileWatch] = None) -> Dict[str, str]:
    """Write trace.json / metrics.json / metrics.prom (and drift.json /
    compiles.json when given) into `dump_dir`; returns the paths written.
    `python -m repro_torch.obs.view <dump_dir>` summarizes the result."""
    import json

    os.makedirs(dump_dir, exist_ok=True)
    paths: Dict[str, str] = {}

    paths["trace"] = os.path.join(dump_dir, "trace.json")
    _tracer.save(paths["trace"])
    paths["metrics"] = os.path.join(dump_dir, "metrics.json")
    REGISTRY.save(paths["metrics"])
    paths["prometheus"] = os.path.join(dump_dir, "metrics.prom")
    with open(paths["prometheus"], "w") as f:
        f.write(REGISTRY.to_prometheus())
    if drift is not None:
        paths["drift"] = os.path.join(dump_dir, "drift.json")
        drift.save(paths["drift"])
    if watch is not None:
        paths["compiles"] = os.path.join(dump_dir, "compiles.json")
        with open(paths["compiles"], "w") as f:
            json.dump(watch.to_json(), f, indent=2)
    return paths


def reset() -> None:
    """Clear the trace buffer, the metrics registry and the dispatch keys
    seen (test hook)."""
    _tracer.clear()
    REGISTRY.clear()
    _dispatched.clear()
