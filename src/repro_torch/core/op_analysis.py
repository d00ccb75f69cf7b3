"""Counting one rank's step: FLOPs, HBM bytes and collective bytes (the
port's counterpart of the JAX package's `core/hlo_analysis.py`).

JAX counts a compiled program: it walks the post-SPMD HLO text.  The port
runs eagerly, so it counts what runs: a `TorchDispatchMode` sees every aten
op of the step (on the CPU, on the card, or traced on the meta device,
where nothing is computed), and the kernel wrappers and collectives report
themselves.  The fields are JAX's `Counts` (`flops`, `bytes`, `coll`,
`dots`, `loops`, `s2_bytes`) and `as_dict` gives JAX's keys.

Counting rules:
  flops     — what JAX counts, dot ops only: 2 M N K for every aten mm /
              addmm / bmm / baddbmm (what `matmul`, `linear` and `einsum`
              dispatch to); convolutions and elementwise ops count nothing.
  bytes     — the eager program's own traffic: input plus output bytes of
              each aten op that touches memory.  Views, metadata and
              allocations count nothing; copies and dtype casts count
              (in eager they are real traffic).
  s2_bytes  — JAX's `_is_s2` rule: the bytes of ops whose output has two
              equal dims of at least 2048 (naive attention's s^2 tensors).
  kernels   — a hand-written kernel is charged as the kernel, whatever
              device runs it: each public wrapper dispatches (plain
              version, launch or meta outputs) inside one `kernel(name,
              cost)` block, which charges its `cost` function's numbers
              once; nothing inside is counted, neither aten ops nor the
              kernels it calls (a backward's cost lists its tile GEMMs).
              A CPU run, a CUDA run and a meta trace of a step count the
              same.  With no counter on, the block is a shared null
              context and `cost` is not called.
  coll      — the collectives' wire bytes by kind (`parallel/comm.py`'s
              census): output bytes in the wire's dtype.
  loops     — JAX's trip counts: `repeat("microbatch", n)` runs the train
              step's microbatch loop; under `count(trace_one=True)` only
              its first pass runs and is counted n times (the HLO walk's
              rule for a while body), the per-step rest (clip, optimizer)
              once.

`Counter.peak_bytes` is the most bytes that the storages made inside held
at once (read after each op; storages nothing holds any more are dropped
before a new peak is taken); storages made before, such as the step's
arguments, are not in it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.multiprocessing.reductions import StorageWeakRef

# JAX's kinds, and the pipeline's broadcast (`parallel/comm.py` records it;
# the HLO walk has no such kind)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}
# ops that move no tensor data: allocations, metadata, aliasing
_FREE = {_aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
         _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
         _aten.alias.default, _aten.lift_fresh.default, _aten._unsafe_view.default,
         _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default,
         _aten.sym_storage_offset.default, _aten.is_same_size.default,
         _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
         _aten._local_scalar_dense.default}


@dataclasses.dataclass
class Counts:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    dots: float = 0.0
    loops: Dict[str, int] = dataclasses.field(default_factory=dict)
    s2_bytes: float = 0.0  # bytes moved through s^2 attention tensors
    # {kernel: {"launches", "flops", "bytes"}} of the hand-written kernels charged
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "dots": self.dots,
                "coll": dict(self.coll), "coll_total": self.coll_total,
                "loops": dict(self.loops)}


def _is_s2(shape) -> bool:
    """JAX's rule: two equal dims of at least 2048 (not logits' (s, v))."""
    big = [d for d in shape if d >= 2048]
    return len(big) >= 2 and len(set(big)) < len(big)


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(func, args) -> float:
    """2 M N K of an aten mm / addmm / bmm / baddbmm."""
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class Counter(TorchDispatchMode):
    """The counting mode: `Counts` of what runs inside (`.counts`).  Use
    through `count()`."""

    def __init__(self, trace_one: bool = False):
        super().__init__()
        self.counts = Counts()
        self.trace_one = trace_one
        self.mult = 1
        self.opaque = 0
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # --- what the wrappers and the collectives report ---------------------------------
    def charge(self, kernel: str, flops: float, nbytes: float) -> None:
        c, k = self.counts, self.mult
        c.flops += flops * k
        c.bytes += nbytes * k
        row = c.kernels.setdefault(kernel, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += k
        row["flops"] += flops * k
        row["bytes"] += nbytes * k

    def collective(self, kind: str, nbytes: float) -> None:
        self.counts.coll[kind] = self.counts.coll.get(kind, 0.0) + nbytes * self.mult

    # --- live storages ----------------------------------------------------------------
    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live:
                n = st.nbytes()
                self.live[key] = (StorageWeakRef(st), n)
                self.live_bytes += n
        # live_bytes counts freed storages until a sweep: an upper bound, so
        # the peak moves only after a sweep confirms it
        if self.live_bytes > self.peak_bytes:
            for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
                self.live_bytes -= self.live.pop(key)[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        self._track(outs)
        if self.opaque or func.namespace not in ("aten", "prims") or func in _FREE \
                or func.is_view:
            return out
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(map(_nbytes, outs))
        c, k = self.counts, self.mult
        c.bytes += nbytes * k
        if any(_is_s2(t.shape) for t in outs):
            c.s2_bytes += nbytes * k
        if func in _DOTS:
            c.flops += dot_flops(func, args) * k
            c.dots += k
        return out


_ACTIVE: list = []


@contextlib.contextmanager
def count(trace_one: bool = False):
    """Count what runs inside; yields the `Counter` (its `.counts` and
    `.peak_bytes` are final when the block ends)."""
    from ..parallel import comm
    c = Counter(trace_one)
    _ACTIVE.append(c)
    try:
        with c, comm.listen(c.collective):
            yield c
    finally:
        _ACTIVE.remove(c)


class _Opaque:
    """Holds a counter's opaque depth up for a `with` block."""
    __slots__ = ("c",)

    def __init__(self, c: Counter):
        self.c = c

    def __enter__(self):
        self.c.opaque += 1

    def __exit__(self, *exc):
        self.c.opaque -= 1


_NULL = contextlib.nullcontext()


def kernel(name: Optional[str], cost):
    """The block a kernel wrapper dispatches in.  With a counter on, the
    kernel `name` is charged `cost()` (FLOPs, bytes) once, or, with `name`
    None, each launch of the list `cost()` gives ((kernel, FLOPs, bytes));
    nothing inside is counted.  With none on, a shared null context."""
    if not _ACTIVE:
        return _NULL
    c = _ACTIVE[-1]
    if not c.opaque:
        for launch in (cost() if name is None else [(name, *cost())]):
            c.charge(*launch)
    return _Opaque(c)


def repeat(name: str, n: int) -> Iterator[int]:
    """range(n) for a loop of n identical passes (JAX's while loop with a
    known trip count): recorded in `loops`; under `count(trace_one=True)`
    only pass 0 runs, counted n times."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is None:
        yield from range(n)
        return
    c.counts.loops[name] = n
    if not c.trace_one:
        yield from range(n)
        return
    c.mult *= n
    try:
        yield 0
    finally:
        c.mult //= n
