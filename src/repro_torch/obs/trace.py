"""Host-side span tracer: nestable timed spans on the engine clock.

One `Tracer` owns a thread-safe ring buffer of trace events.  `span(...)`
is a context manager recording one Chrome trace-event "complete" ("X")
event on exit; `instant(...)` records a point event ("i").  The buffer
exports as Chrome trace-event JSON (`to_chrome` / `save`) — the dump loads
directly in Perfetto / chrome://tracing, with span nesting recovered from
interval containment per thread track.

When `annotate_device=True` every span also enters a
`torch.profiler.record_function` range of the same name, so a concurrent
`torch.profiler.profile(...)` capture puts each CUDA kernel under the
engine site whose host code launched it (`decode_step`, `prefill`,
`prepare_append`, `sample`).  The range is entered only then: a span
without it costs two clock reads and one buffer append.

The tracer is deliberately dumb and cheap: no sampling, no aggregation
(that is `obs.metrics`), one lock around a bounded deque.  The module-level
enable flag lives in `repro_torch.obs.__init__`; disabled call sites get a
shared no-op span and never touch this module's state.  (The JAX package's
`obs/trace.py`, with `jax.profiler.TraceAnnotation` replaced by
`record_function`.)
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

DEFAULT_CAPACITY = 65536


class NullSpan:
    """Shared no-op span handed out when tracing is disabled (and the safe
    default for `dur_s` readers)."""

    __slots__ = ()
    dur_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = NullSpan()


class Span:
    """One live span; records an "X" event into its tracer on exit."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0_us", "_ann", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0_us = 0.0
        self._ann = None
        self.dur_s = 0.0

    def __enter__(self):
        tr = self._tr
        stack = tr._stack()
        stack.append(self.name)
        if tr.annotate_device:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0_us = tr._now_us()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        t1 = tr._now_us()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self.dur_s = (t1 - self._t0_us) * 1e-6
        tr._append({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self._t0_us, "dur": t1 - self._t0_us,
            "pid": tr.pid, "tid": threading.get_ident(),
            "args": dict(self.args, depth=len(stack)),
        })
        return False


class Tracer:
    """Thread-safe bounded event buffer with Chrome trace-event export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 annotate_device: bool = True):
        self.capacity = capacity
        self.annotate_device = annotate_device
        self.pid = os.getpid()
        self.dropped = 0
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.perf_counter()

    # -- internals -----------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(ev)

    # -- recording -----------------------------------------------------------

    def span(self, name: str, cat: str = "host", **args) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        self._append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now_us(), "pid": self.pid,
            "tid": threading.get_ident(), "args": args,
        })

    # -- reading / export ----------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0
        self._t0 = time.perf_counter()

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (loads in Perfetto as-is)."""
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": "repro_torch"},
        }]
        return {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def span_durations_us(events: List[dict],
                      name: Optional[str] = None) -> List[float]:
    """Durations (us) of the "X" events, optionally filtered by name —
    the helper `view` and the drift/step-percentile reports share."""
    return [e["dur"] for e in events
            if e.get("ph") == "X" and (name is None or e["name"] == name)]
