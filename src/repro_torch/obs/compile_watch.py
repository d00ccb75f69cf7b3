"""Build watchdog: observe every kernel-library build, and optionally FAIL
on one.

The JAX package's `CompileWatch` records every XLA compile and, once armed,
fails on one: steady-state serving must never re-jit.  The port runs
eagerly and compiles in one place only, `kernels/_build.py` `build()`: the
`nvcc` build of `kernels/csrc/` at first use (or the load of a finished
build of the same sources from `build/kernels/`), once per process.  So
this watch records each build:

  * every `build()` that resolves the library is recorded as
    `(key, wall s)`, the key naming the library file (the sources' digest)
    and whether nvcc ran or an earlier build was loaded;
  * after `arm()`, any further build is a *violation*: with
    `raise_on_violation=True` (default) `UnexpectedCompile` is raised from
    inside `build()` itself, so the kernel call that needed it is on the
    stack; `check()` re-raises for callers that prefer to poll.

`install()` adds the watch to `_build.BUILD_HOOKS` and `uninstall()` takes
it out; use the instance as a context manager for scoped watching.  Records
are mirrored into `obs.trace` / `obs.metrics` when observability is
enabled.  Same API as the JAX package's; with one signal to watch (JAX
cross-checks two), `backend_compiles` is the number of builds recorded.
A CUDA-graph capture watch comes once the port captures graphs.

What it can catch today: `build()` caches the library per process, so
once a kernel has run nothing in the port resolves it again, and an armed
watch records no build in steady state by construction.  It guards that
promise for whatever later breaks it (CUDA graphs, JIT-compiled kernels,
a code path that drops the cache); chip_smoke's obs serve phase drops
`_build._LIBRARY` under an armed watch and requires the next kernel call
to raise `UnexpectedCompile`, so the watch is shown able to fire.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List


class UnexpectedCompile(RuntimeError):
    """An armed CompileWatch saw a build it was promised would not happen."""


@dataclasses.dataclass(frozen=True)
class CompileRecord:
    key: str          # "<library file> <nvcc build | loaded>"
    name: str
    wall_s: float
    armed: bool       # recorded while the watch was armed (= a violation)
    t_s: float        # process-clock time of the record


class CompileWatch:
    """Record (and optionally forbid) kernel-library builds.  See module
    docstring."""

    def __init__(self, raise_on_violation: bool = True):
        self.raise_on_violation = raise_on_violation
        self.records: List[CompileRecord] = []
        self.violations: List[CompileRecord] = []
        self.armed = False
        self._rec_lock = threading.Lock()

    @property
    def backend_compiles(self) -> int:
        return len(self.records)

    # -- install / uninstall -------------------------------------------------

    def install(self) -> "CompileWatch":
        from ..kernels import _build
        if self._on_build not in _build.BUILD_HOOKS:
            _build.BUILD_HOOKS.append(self._on_build)
        return self

    def uninstall(self) -> None:
        from ..kernels import _build
        if self._on_build in _build.BUILD_HOOKS:
            _build.BUILD_HOOKS.remove(self._on_build)

    def __enter__(self) -> "CompileWatch":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- arming --------------------------------------------------------------

    def arm(self) -> None:
        """From now on, every build is a violation.  Call after warmup /
        `Engine.calibrate_step_s()`."""
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def check(self) -> None:
        """Raise UnexpectedCompile if any build happened while armed."""
        if self.violations:
            keys = ", ".join(v.key for v in self.violations[:4])
            raise UnexpectedCompile(
                f"{len(self.violations)} unexpected build(s) while armed: {keys}")

    # -- event sink ----------------------------------------------------------

    def _on_build(self, lib) -> None:
        """`_build.build()`'s hook: `lib` is the library just built or loaded
        (`_build.Library`: its path names the sources' digest)."""
        how = "nvcc build" if lib.build_s > 0 else "loaded"
        with self._rec_lock:
            rec = CompileRecord(key=f"{lib.path.name} {how}", name=lib.path.name,
                                wall_s=float(lib.build_s), armed=self.armed,
                                t_s=time.perf_counter())
            self.records.append(rec)
            if self.armed:
                self.violations.append(rec)
        self._mirror(rec)
        if rec.armed and self.raise_on_violation:
            raise UnexpectedCompile(
                f"unexpected build while armed: {rec.key} ({rec.wall_s * 1e3:.1f} ms)")

    def _mirror(self, rec: CompileRecord) -> None:
        """Copy the record into the obs trace/metrics when enabled."""
        from . import enabled, get_metrics, get_tracer
        if not enabled():
            return
        get_tracer().instant("compile", cat="compile", key=rec.key,
                             wall_s=rec.wall_s, armed=rec.armed)
        get_metrics().counter("compile.count").inc()
        get_metrics().histogram("compile.wall_s").observe(rec.wall_s)
        if rec.armed:
            get_metrics().counter("compile.violations").inc()

    # -- export --------------------------------------------------------------

    def table(self) -> List[dict]:
        return [dataclasses.asdict(r) for r in self.records]

    def to_json(self) -> dict:
        return {
            "records": self.table(),
            "violations": [dataclasses.asdict(r) for r in self.violations],
            "backend_compiles": self.backend_compiles,
            "armed": self.armed,
        }
