"""Metrics registry: counters, gauges, histograms with JSON + Prometheus
text snapshots.

The registry is the aggregate sibling of the span tracer (`obs.trace`):
spans answer "where did this step's time go", metrics answer "how many / how
much over the whole run" (tokens emitted, blocks evicted, queue depth,
per-step latency distribution).  Instruments are created on first use and
are individually thread-safe; `snapshot()` / `to_prometheus()` render the
whole registry.

Histograms keep exact count/sum/min/max plus a bounded reservoir of the
most recent samples for percentile estimates — decode-step times are
stationary enough in steady state that a recency window is the right
percentile base, and it bounds memory on long runs.

A copy of the JAX package's `obs/metrics.py` (pure numpy), one to one.
"""
from __future__ import annotations

import json
import re
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional

import numpy as np

_PROM_SAFE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PROM_SAFE.sub("_", name)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Sum/count/min/max plus a recency reservoir for percentiles."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples", "_lock")

    def __init__(self, name: str, sample_cap: int = 1024):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: deque = deque(maxlen=sample_cap)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._samples.append(v)

    def observe_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            return float(np.percentile(np.asarray(self._samples, np.float64), p))

    def summary(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            xs = np.asarray(self._samples, np.float64)
            return {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min,
                "max": self.max,
                "p50": float(np.percentile(xs, 50)),
                "p90": float(np.percentile(xs, 90)),
                "p99": float(np.percentile(xs, 99)),
                "std": float(xs.std()),
            }


class MetricsRegistry:
    """Name -> instrument map; instruments are created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, sample_cap: int = 1024) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, sample_cap)
            return h

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary() for n, h in sorted(hists.items())},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters/gauges literal; histograms
        as summaries with p50/p90/p99 quantiles)."""
        snap = self.snapshot()
        out: List[str] = []
        for name, v in snap["counters"].items():
            pn = _prom_name(name)
            out.append(f"# TYPE {pn} counter")
            out.append(f"{pn} {v:g}")
        for name, v in snap["gauges"].items():
            pn = _prom_name(name)
            out.append(f"# TYPE {pn} gauge")
            out.append(f"{pn} {v:g}")
        for name, s in snap["histograms"].items():
            pn = _prom_name(name)
            out.append(f"# TYPE {pn} summary")
            if s["count"]:
                for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                    out.append(f'{pn}{{quantile="{q}"}} {s[key]:g}')
                out.append(f"{pn}_sum {s['sum']:g}")
            out.append(f"{pn}_count {s['count']}")
        return "\n".join(out) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


REGISTRY = MetricsRegistry()
