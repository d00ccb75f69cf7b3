"""Kernel contract checker (KRN rules) over the port's CUDA sources and its
tuned-op plumbing.

Three layers:

**Per-file CUDA checks** (every `.cu` / `.cuh` in the analyzed set):

  * KRN101 — an accumulator declared at a half-precision type: a wmma
    `fragment<accumulator, ..., T>` or an array whose name holds `acc`, at
    half, __half, __nv_bfloat16 or bf16.
  * KRN102 — every tensor-core product accumulates wide: the D (and C)
    type of a `wgmma.mma_async` / `mma.sync` PTX string is f32 for float
    operands (bf16, f16, tf32, e4m3, e5m2) and s32 for s8 / u8 operands; a
    `wmma::mma_sync(d, a, b, c)`'s d fragment is declared float (int for
    integer operands).  A PTX string assembled from pieces cannot be read,
    and is not checked.

**Launch geometry** (KRN103; runs when a Python file that calls a C entry
and the CUDA sources defining that entry are both analyzed):

  A wrapper's geometry constants — the module-level `*_TILE` (one tile) and
  `*_TILES` (a tuple of tiles; a `*_TILES` that is a single int is a count,
  not a tile) of a Python file that calls `lib.<entry>(` — are held to the
  launches they reach.  A launch is one Python function that calls C
  entries; a constant reaches the launching functions that read it
  (directly or through a constant built from it), that its readers call,
  and that call its readers (up to the first that launches).  For each such
  launch, one of its entries must instantiate each tile, reading only the
  code that entry reaches in its translation unit (the `.cu` file and the
  headers it includes): its body and every function named there,
  transitively, function-like macros expanded in place.  A tile (rows,
  columns) is instantiated where that code dispatches on it (a chain
  `tm == r && tn == c`, or a guard `tm != R || tn != C` that admits it
  alone, the values literal or `constexpr` / `#define` names) or where a
  template call's first two arguments are (r, c), after the template
  parameters of the function holding the call are bound for each of its
  instantiations.  A one-dimensional tile t must be a value of a dispatch
  chain or a `case`.  A constant that no launching function reaches is held
  to one launch of every entry its file calls.  Where one function picks
  between two entries at run time, a tile is held to either of them.

**Cross-module tuned-op contract** (runs when the analyzed set contains an
`autotune_*` entry point, i.e. `tuning/search.py` is in scope):

  Every tuning-cache *lookup* (`lookup(op, shape, ...)` in `kernels/*/ops.py`
  or the serving engine) is matched against the `TunedConfig(op=...,
  shape=...)` entries the autotuners *write*:

  * KRN104 — a looked-up op that nothing writes (tuned=True silently never
    hits);
  * KRN105 — lookup/write shape-key arity mismatch (the key never matches);
  * KRN106 — an autotune entry point (writing directly or through a writer
    helper) with no `*_candidates` lattice sweep, or a lattice bounded by
    no feasibility model: shared memory within `SMEM_LIMIT`, or the
    wrappers' geometry constants, which KRN103 holds to what the CUDA
    library instantiates;
  * KRN107 — a written op that nothing in the analyzed tree consults.

  Op names and shape keys resolve statically, as the JAX package resolves
  them (constants, conditional expressions, local assignments, helpers
  returning string literals or constant-prefix f-strings:
  `fused_mlp_{mlp_type}` matches as the prefix pattern ``fused_mlp_*``),
  and through the port's idiom besides: a name that is a parameter of the
  function holding the lookup or write (`_best(op, shape, ...)`,
  `paged_geometry(op, key_shape, ...)`, `keyed_matmul(op=...)`) resolves at
  each of that function's call sites in the analyzed tree (its default
  where a call passes none), up the call chain, and `fn.__name__` of a
  function passed in resolves to that function's name.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .source import SourceFile, load_source

_LOOKUP_NAMES = {"lookup", "_tuning_lookup"}
_SMEM_BOUND = "SMEM_LIMIT"
_MAX_CHAIN = 6  # call sites followed up from a lookup or write


# -- small AST helpers --------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func) or ""


def _last_attr(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _resolve_name_assignment(scope: Optional[ast.AST], name: str,
                             before_line: int) -> Optional[ast.expr]:
    """Last `name = <expr>` in `scope` before `before_line`."""
    if scope is None:
        return None
    found = None
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and node.lineno < before_line:
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    found = node.value
    return found


def _params(fn: ast.AST) -> List[ast.arg]:
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs


def _is_param(scope: Optional[ast.AST], name: str) -> bool:
    if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    a = scope.args
    names = {p.arg for p in _params(scope)}
    names |= {v.arg for v in (a.vararg, a.kwarg) if v is not None}
    return name in names


def _stored(scope: Optional[ast.AST], name: str) -> bool:
    return scope is not None and any(
        isinstance(n, ast.Name) and n.id == name and isinstance(n.ctx, ast.Store)
        for n in ast.walk(scope))


def _names_referenced(fn: ast.AST) -> set:
    return {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)} | {
        _last_attr(_dotted(n)) for n in ast.walk(fn)
        if isinstance(n, ast.Attribute) and _dotted(n)}


# -- the analyzed tree's functions and calls ----------------------------------


@dataclasses.dataclass(eq=False)
class _Def:
    node: ast.FunctionDef
    sf: SourceFile


class _Index:
    """Function definitions by name (several files may define one name),
    the calls of each name, and each file's functions by line span."""

    def __init__(self, files: Sequence[SourceFile]):
        self.defs: Dict[str, List[_Def]] = {}
        self.calls: Dict[str, List[Tuple[ast.Call, SourceFile]]] = {}
        self._spans: Dict[str, List[ast.FunctionDef]] = {}
        for sf in files:
            spans = []
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.defs.setdefault(node.name, []).append(_Def(node, sf))
                    spans.append(node)
                elif isinstance(node, ast.Call):
                    self.calls.setdefault(_last_attr(_call_name(node)), []).append((node, sf))
            self._spans[sf.path] = spans

    def enclosing(self, sf: SourceFile, node: ast.AST) -> Optional[ast.FunctionDef]:
        """Innermost function of `sf` holding `node` (by line span)."""
        best = None
        for fn in self._spans.get(sf.path, ()):
            end = max(getattr(fn, "end_lineno", fn.lineno), fn.lineno)
            if fn.lineno <= node.lineno <= end and (best is None or fn.lineno > best.lineno):
                best = fn
        return best

    def resolve(self, name: str, sf: SourceFile, bare: bool) -> List[_Def]:
        """Definitions a call of `name` in `sf` may reach: a bare name that
        `sf` defines is its own; anything else may be any of them."""
        found = self.defs.get(name, [])
        if bare:
            own = [d for d in found if d.sf is sf]
            if own:
                return own
        return found

    def callers(self, d: _Def) -> List[Tuple[ast.Call, SourceFile]]:
        out = []
        for call, sf in self.calls.get(d.node.name, []):
            bare = isinstance(call.func, ast.Name)
            if any(x.node is d.node for x in self.resolve(d.node.name, sf, bare)):
                out.append((call, sf))
        return out

    def def_of(self, fn: ast.AST) -> Optional[_Def]:
        for d in self.defs.get(getattr(fn, "name", ""), []):
            if d.node is fn:
                return d
        return None


# -- resolving op names and shape keys through call chains --------------------


@dataclasses.dataclass(eq=False)
class _Frame:
    """A function as one call chain reached it: `bindings` maps its
    parameters to (argument expression, the caller's frame); None where the
    chain ends at this function (its parameters are not known yet)."""

    scope: Optional[ast.AST]
    sf: SourceFile
    bindings: Optional[Dict[str, Tuple[Optional[ast.expr], "_Frame"]]]


class _NeedsCaller(Exception):
    def __init__(self, frame: _Frame):
        super().__init__()
        self.frame = frame


def _bind(call: Optional[ast.Call], fn: ast.FunctionDef, fn_sf: SourceFile,
          caller: Optional[_Frame]) -> Dict[str, Tuple[Optional[ast.expr], _Frame]]:
    """fn's parameters as `call` (None: a call passing nothing) binds them:
    positional and keyword arguments in the caller's frame, then defaults."""
    a = fn.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    if (call is not None and positional and positional[0] in ("self", "cls")
            and isinstance(call.func, ast.Attribute)):
        positional = positional[1:]
    out: Dict[str, Tuple[Optional[ast.expr], _Frame]] = {}
    if call is not None:
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred) or i >= len(positional):
                break
            out[positional[i]] = (arg, caller)
        for k in call.keywords:
            if k.arg is not None:
                out[k.arg] = (k.value, caller)
    at_def = _Frame(fn, fn_sf, {})
    pos_all = [p.arg for p in a.posonlyargs + a.args]
    for p, d in zip(pos_all[len(pos_all) - len(a.defaults):], a.defaults):
        out.setdefault(p, (d, at_def))
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out.setdefault(p.arg, (d, at_def))
    return out


class _Resolver:
    def __init__(self, index: _Index):
        self.index = index

    def _param(self, frame: _Frame, name: str):
        if frame.bindings is None:
            raise _NeedsCaller(frame)
        return frame.bindings.get(name, (None, frame))

    def ops(self, expr: Optional[ast.expr], frame: _Frame, depth: int = 0) -> List[str]:
        if depth > 12 or expr is None:
            return []
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return [expr.value]
        if isinstance(expr, ast.IfExp):
            return (self.ops(expr.body, frame, depth + 1)
                    + self.ops(expr.orelse, frame, depth + 1))
        if isinstance(expr, ast.JoinedStr):
            if expr.values and isinstance(expr.values[0], ast.Constant):
                return [str(expr.values[0].value) + "*"]
            return ["*"]
        if isinstance(expr, ast.Name):
            val = _resolve_name_assignment(frame.scope, expr.id, expr.lineno)
            if val is not None:
                return self.ops(val, frame, depth + 1)
            if _is_param(frame.scope, expr.id):
                e, f = self._param(frame, expr.id)
                return self.ops(e, f, depth + 1)
            return []
        if isinstance(expr, ast.Attribute) and expr.attr == "__name__":
            return self.fn_names(expr.value, frame, depth + 1)
        if isinstance(expr, ast.Call):
            callee = _last_attr(_call_name(expr))
            names: List[str] = []
            for d in self.index.resolve(callee, frame.sf, isinstance(expr.func, ast.Name)):
                inner = _Frame(d.node, d.sf, _bind(expr, d.node, d.sf, frame))
                for node in ast.walk(d.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        names.extend(self.ops(node.value, inner, depth + 1))
            return names
        return []

    def fn_names(self, expr: ast.expr, frame: _Frame, depth: int) -> List[str]:
        """Names of the functions `expr` may hold (for `expr.__name__`)."""
        if depth > 12 or not isinstance(expr, ast.Name):
            return []
        val = _resolve_name_assignment(frame.scope, expr.id, expr.lineno)
        if val is not None:
            return self.fn_names(val, frame, depth + 1)
        if _is_param(frame.scope, expr.id):
            e, f = self._param(frame, expr.id)
            return [] if e is None else self.fn_names(e, f, depth + 1)
        if _stored(frame.scope, expr.id):  # a loop target or the like: unknown
            return []
        return [expr.id] if expr.id in self.index.defs else []

    def arity(self, expr: Optional[ast.expr], frame: _Frame, depth: int = 0) -> Optional[int]:
        if depth > 12 or expr is None:
            return None
        if isinstance(expr, (ast.Tuple, ast.List)):
            return len(expr.elts)
        if (isinstance(expr, ast.Call) and _call_name(expr) in ("tuple", "list")
                and len(expr.args) == 1):
            return self.arity(expr.args[0], frame, depth + 1)
        if isinstance(expr, ast.Name):
            val = _resolve_name_assignment(frame.scope, expr.id, expr.lineno)
            if val is not None:
                return self.arity(val, frame, depth + 1)
            if _is_param(frame.scope, expr.id):
                e, f = self._param(frame, expr.id)
                return self.arity(e, f, depth + 1)
        return None

    def _frame(self, scope, sf: SourceFile, chain: list) -> _Frame:
        if not chain:
            return _Frame(scope, sf, None)
        site = chain[0]
        if site is None:  # no caller in the analyzed tree: the defaults stand
            return _Frame(scope, sf, _bind(None, scope, sf, None))
        call, csf = site
        caller = self._frame(self.index.enclosing(csf, call), csf, chain[1:])
        return _Frame(scope, sf, _bind(call, scope, sf, caller))

    def instances(self, op_expr, shape_expr, node: ast.AST,
                  sf: SourceFile) -> List[Tuple[List[str], Optional[int], str]]:
        """(ops, arity, context) of a lookup or write at `node`, once per
        call chain that resolves its op: the context names the function the
        chain started in (where the op's value came from)."""
        scope = self.index.enclosing(sf, node)
        out = []
        work: List[list] = [[]]
        while work:
            chain = work.pop()
            try:
                frame = self._frame(scope, sf, chain)
                ops = self.ops(op_expr, frame)
                arity = self.arity(shape_expr, frame)
            except _NeedsCaller as e:
                d = self.index.def_of(e.frame.scope)
                if d is None or len(chain) >= _MAX_CHAIN:
                    continue
                callers = self.index.callers(d)
                if callers:
                    work.extend(chain + [c] for c in callers)
                else:
                    work.append(chain + [None])
                continue
            if ops:
                top = next((c for c in reversed(chain) if c is not None), None)
                ctx_fn = (self.index.enclosing(top[1], top[0]) if top is not None else scope)
                out.append((ops, arity, getattr(ctx_fn, "name", "<module>")))
        return out


@dataclasses.dataclass
class _OpRef:
    ops: List[str]  # resolved names; trailing '*' = prefix pattern
    arity: Optional[int]
    file: str
    line: int
    context: str  # the function the op's value came from


def _op_matches(lookup_op: str, writer_op: str) -> bool:
    for a, b in ((lookup_op, writer_op), (writer_op, lookup_op)):
        if a.endswith("*") and b.startswith(a[:-1]):
            return True
    return lookup_op == writer_op


def _refs(resolver: _Resolver, names, is_site, op_shape) -> List[_OpRef]:
    """The resolved lookups or writes: the calls of `names` that `is_site`
    accepts, their (op, shape) expressions given by `op_shape`."""
    out: List[_OpRef] = []
    seen = set()
    for name in sorted(names):
        for node, sf in resolver.index.calls.get(name, []):
            if not is_site(node):
                continue
            op_expr, shape_expr = op_shape(node)
            for ops, arity, ctx in resolver.instances(op_expr, shape_expr, node, sf):
                key = (tuple(ops), arity, sf.path, node.lineno, ctx)
                if key not in seen:
                    seen.add(key)
                    out.append(_OpRef(ops, arity, sf.path, node.lineno, ctx))
    return out


def _writes(index: _Index, fn: ast.AST, depth: int = 0) -> bool:
    """Does `fn` construct a TunedConfig, itself or through a helper?"""
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        name = _last_attr(_call_name(n))
        if name == "TunedConfig":
            return True
        if depth < 2 and not name.startswith("autotune_") and any(
                _writes(index, d.node, depth + 1) for d in index.defs.get(name, [])
                if d.node is not fn):
            return True
    return False


def check_tuned_contract(files: Sequence[SourceFile]) -> List[Finding]:
    """The cross-module contract registry check (KRN104-107)."""
    parsed = [sf for sf in files if sf.tree is not None]
    index = _Index(parsed)
    autotune_defs = [d for n, ds in index.defs.items() if n.startswith("autotune_")
                     for d in ds]
    if not autotune_defs:
        return []  # search module not in scope; nothing to cross-check

    resolver = _Resolver(index)
    findings: List[Finding] = []

    writers = _refs(resolver, {"TunedConfig"}, lambda n: True,
                    lambda n: (_kw(n, "op"), _kw(n, "shape")))
    lookups = _refs(resolver, _LOOKUP_NAMES, lambda n: len(n.args) >= 2,
                    lambda n: (n.args[0], n.args[1]))

    # KRN104/KRN105: every lookup must have a writer at the same arity
    reported = set()
    for ref in lookups:
        for op in ref.ops:
            matches = [w for w in writers
                       if any(_op_matches(op, wop) for wop in w.ops)]
            if not matches:
                key = ("KRN104", ref.file, ref.line, op)
                if key not in reported:
                    reported.add(key)
                    findings.append(Finding(
                        ref.file, ref.line, "KRN104", "error",
                        f"tuning-cache lookup for op {op!r} "
                        f"(in {ref.context}) has no autotune entry point "
                        f"writing it — tuned=True can never hit",
                        fix_hint="add an autotune_* entry in tuning/search.py "
                                 "persisting TunedConfig(op=...) for this op"))
                continue
            if ref.arity is not None and not any(
                    w.arity == ref.arity for w in matches
                    if w.arity is not None):
                warities = sorted({w.arity for w in matches
                                   if w.arity is not None})
                key = ("KRN105", ref.file, ref.line, op, ref.arity)
                if key not in reported:
                    reported.add(key)
                    findings.append(Finding(
                        ref.file, ref.line, "KRN105", "error",
                        f"lookup key for op {op!r} (in {ref.context}) has "
                        f"{ref.arity} shape elements but the autotuner "
                        f"persists {warities or '?'} — the key never matches "
                        f"and tuned=True silently falls back",
                        fix_hint="make the ops.py lookup tuple and the "
                                 "TunedConfig shape tuple the same arity"))

    # KRN107: writers nothing consults
    for w in writers:
        for op in w.ops:
            if not any(_op_matches(lop, op)
                       for ref in lookups for lop in ref.ops):
                key = ("KRN107", w.file, w.line, op)
                if key not in reported:
                    reported.add(key)
                    findings.append(Finding(
                        w.file, w.line, "KRN107", "warn",
                        f"autotuner persists op {op!r} (in {w.context}) but "
                        f"nothing in the analyzed tree looks it up",
                        fix_hint="consult it via tuned=True, or drop the "
                                 "entry"))

    # KRN106: every autotune entry sweeps a candidates lattice that a
    # feasibility model bounds
    bounds = {_SMEM_BOUND} | {name for sf in parsed for name, _, _ in geometry_constants(sf)}

    def bounded(fn: ast.AST, depth: int = 0) -> bool:
        names = _names_referenced(fn)
        if names & bounds:
            return True
        if depth >= 3:
            return False
        return any(bounded(d.node, depth + 1) for n in names
                   if not n.startswith("autotune_") for d in index.defs.get(n, [])
                   if d.node is not fn)

    for d in autotune_defs:
        fn, name = d.node, d.node.name
        if not _writes(index, fn):
            continue
        cand_names = sorted(n for n in _names_referenced(fn)
                            if n.endswith("_candidates"))
        if not cand_names:
            findings.append(Finding(
                d.sf.path, fn.lineno, "KRN106", "error",
                f"{name} persists tuned entries without sweeping a "
                f"*_candidates lattice — launch geometries would bypass "
                f"what the CUDA library instantiates",
                fix_hint="enumerate candidates via tuning/candidates.py "
                         "and measure each"))
            continue
        for cn in cand_names:
            cdefs = index.defs.get(cn, [])
            if cdefs and not any(bounded(c.node) for c in cdefs):
                findings.append(Finding(
                    d.sf.path, fn.lineno, "KRN106", "error",
                    f"{name}: candidates lattice {cn} is bounded by no "
                    f"feasibility model (SMEM_LIMIT, or the wrappers' "
                    f"*_TILE / *_TILES geometry constants) — candidates "
                    f"could be launches the library refuses",
                    fix_hint=f"draw {cn}'s tiles from the kernel's geometry "
                             f"constants, or bound it by SMEM_LIMIT (see "
                             f"tuning/candidates.py)"))
    return findings


# -- geometry constants (KRN103) ----------------------------------------------

_TILE_NAME = re.compile(r"^(?:\w+_)?TILES?$")


def _const_value(node: ast.expr, env: Dict[str, object]):
    """An int, or a (nested) tuple of ints, from a constant expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = [_const_value(e, env) for e in node.elts]
        return None if any(v is None for v in vals) else tuple(vals)
    return None


def _is_tile(v) -> bool:
    return isinstance(v, int) or (isinstance(v, tuple) and len(v) == 2
                                  and all(isinstance(x, int) for x in v))


def geometry_constants(sf: SourceFile) -> List[Tuple[str, int, list]]:
    """(name, line, tiles) of a file's module-level `*_TILE` / `*_TILES`
    constants: a `*_TILE` is one tile, a `*_TILES` a tuple of tiles; a tile
    is an int or an (rows, columns) pair of ints."""
    if sf.tree is None:
        return []
    env: Dict[str, object] = {}
    out = []
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        pairs = []
        for t in targets:
            if isinstance(t, ast.Name):
                pairs.append((t.id, value))
            elif (isinstance(t, ast.Tuple) and isinstance(value, ast.Tuple)
                  and len(t.elts) == len(value.elts)):
                pairs += [(e.id, v) for e, v in zip(t.elts, value.elts)
                          if isinstance(e, ast.Name)]
        for name, v in pairs:
            val = _const_value(v, env)
            env[name] = val
            if val is None or not _TILE_NAME.match(name):
                continue
            if name.endswith("TILES"):
                if isinstance(val, tuple) and val and all(_is_tile(x) for x in val):
                    out.append((name, node.lineno, list(val)))
            elif _is_tile(val):
                out.append((name, node.lineno, [val]))
    return out


# -- reading the CUDA sources -------------------------------------------------

_ENTRY_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')
_INCLUDE_RE = re.compile(r'#\s*include\s+"([^"]+)"')
_CONSTEXPR_RE = re.compile(
    r"\bconstexpr\s+(?:unsigned\s+)?(?:int|long|short|size_t|unsigned|int32_t|int64_t|uint32_t)"
    r"\s+([^;{}()]+);")
_DEFINE_RE = re.compile(r"^[ \t]*#[ \t]*define[ \t]+(\w+)[ \t]+([^\n]+)$", re.M)
_MACRO_RE = re.compile(r"^[ \t]*#[ \t]*define[ \t]+(\w+)\(([^)]*)\)((?:[^\n]*\\\n)*[^\n]*)$",
                       re.M)
_VALUE = r"(?:\w+(?:\.|->))*\w+"
_EQ_CHAIN = re.compile(rf"{_VALUE}\s*==\s*{_VALUE}(?:\s*&&\s*{_VALUE}\s*==\s*{_VALUE})*")
_NE_CHAIN = re.compile(rf"{_VALUE}\s*!=\s*{_VALUE}(?:\s*\|\|\s*{_VALUE}\s*!=\s*{_VALUE})*")
_CASE_RE = re.compile(r"\bcase\s+([\w:]+)\s*:")
_TCALL_RE = re.compile(r"\b(\w+)\s*<([^<>;{}()]*)>\s*\(")
_TEMPLATE_RE = re.compile(r"\btemplate\s*<([^<>]*)>")
_INT_RE = re.compile(r"^(\d+)[uUlL]*$")


def _split_top(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "<([{":
            depth += 1
        elif ch in ">)]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [x.strip() for x in out]


def _c_int(expr: str, env: Dict[str, Optional[int]]) -> Optional[int]:
    """An integer C expression of literals and known names, else None."""
    expr = expr.strip()
    m = _INT_RE.match(expr)
    if m:
        return int(m.group(1))
    if expr in ("true", "false"):
        return int(expr == "true")
    if re.fullmatch(r"\w+", expr):
        return env.get(expr)
    if not re.fullmatch(r"[\w\s+\-*/%()]+", expr):
        return None
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
    except SyntaxError:
        return None

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name):
            v = env.get(n.id)
            if v is None:
                raise ValueError(n.id)
            return v
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        if isinstance(n, ast.BinOp) and isinstance(
                n.op, (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod)):
            a, b = ev(n.left), ev(n.right)
            if isinstance(n.op, (ast.FloorDiv, ast.Mod)) and b == 0:
                raise ValueError("division by zero")
            return {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}.get(
                type(n.op), a // b if isinstance(n.op, ast.FloorDiv) else a % b)
        raise ValueError(type(n).__name__)
    try:
        return ev(tree)
    except (ValueError, TypeError):
        return None


def _constants(code: str) -> Dict[str, Optional[int]]:
    env: Dict[str, Optional[int]] = {}
    for m in _CONSTEXPR_RE.finditer(code):
        for decl in _split_top(m.group(1)):
            name, eq, val = decl.partition("=")
            name = name.strip()
            if eq and re.fullmatch(r"\w+", name):
                v = _c_int(val, env)
                if v is not None:
                    env[name] = v
    for m in _DEFINE_RE.finditer(code):
        v = _c_int(m.group(2), env)
        if v is not None:
            env.setdefault(m.group(1), v)
    return env


def _expand_macros(skel: str) -> str:
    """`skel` with each function-like macro expanded where it is invoked
    (its definition blanked), to a fixed point of a few rounds, so that a
    dispatch a macro writes lies inside the function that invokes it."""
    macros = {}
    for m in _MACRO_RE.finditer(skel):
        macros[m.group(1)] = ([p.strip() for p in m.group(2).split(",")],
                              m.group(3).replace("\\\n", " "))
    if not macros:
        return skel
    skel = _MACRO_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), skel)
    call = re.compile(rf"\b({'|'.join(map(re.escape, macros))})\s*\(([^()]*)\)")

    def expand(m: re.Match) -> str:
        params, body = macros[m.group(1)]
        args = _split_top(m.group(2))
        if len(args) != len(params):
            return m.group(0)
        for p, a in zip(params, args):
            body = re.sub(rf"\b{re.escape(p)}\b", a, body)
        return body
    for _ in range(4):
        grown = call.sub(expand, skel)
        if grown == skel:
            break
        skel = grown
    return skel


def _match_close(s: str, i: int, open_ch: str, close_ch: str) -> int:
    depth = 0
    for j in range(i, len(s)):
        if s[j] == open_ch:
            depth += 1
        elif s[j] == close_ch:
            depth -= 1
            if depth == 0:
                return j
    return len(s)


def _template_functions(skel: str) -> List[Tuple[str, List[str], int, int]]:
    """(name, template parameter names, body start, body end) of every
    function template of a skeleton (struct templates are skipped)."""
    out = []
    for m in _TEMPLATE_RE.finditer(skel):
        params = []
        for p in _split_top(m.group(1)):
            p = p.split("=")[0].strip()
            ids = re.findall(r"\w+", p)
            if ids:
                params.append(ids[-1])
        end = m.end()
        brace, semi = skel.find("{", end), skel.find(";", end)
        if brace < 0 or (0 <= semi < brace):
            continue
        decl = skel[end:brace].rstrip()
        decl = re.sub(r"(\bconst|\bnoexcept|->\s*[\w:<>\s]+)\s*$", "", decl).rstrip()
        if not decl.endswith(")"):
            continue
        depth, j = 0, len(decl) - 1
        while j >= 0:
            depth += {")": 1, "(": -1}.get(decl[j], 0)
            if depth == 0:
                break
            j -= 1
        name = re.search(r"(\w+)\s*$", decl[:j])
        if name:
            out.append((name.group(1), params, brace, _match_close(skel, brace, "{", "}")))
    return out


_NOT_FUNCTIONS = {"if", "for", "while", "switch", "return", "sizeof", "catch", "decltype",
                  "alignof", "alignas", "static_assert", "__launch_bounds__", "__align__"}
_FUNC_TAIL = re.compile(r"\s*(?:(?:const|noexcept|override)\b\s*|->\s*[\w:<>\s*&]+?)*\{")


def _functions(skel: str) -> Dict[str, List[Tuple[int, int]]]:
    """name -> the (body start, body end) of each function defined in a
    skeleton (overloads and templates alike)."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    for m in re.finditer(r"\b(\w+)\s*\(", skel):
        if m.group(1) in _NOT_FUNCTIONS:
            continue
        close = _match_close(skel, m.end() - 1, "(", ")")
        tail = _FUNC_TAIL.match(skel, close + 1)
        if tail:
            brace = tail.end() - 1
            out.setdefault(m.group(1), []).append(
                (brace, _match_close(skel, brace, "{", "}")))
    return out


@dataclasses.dataclass
class CudaGeometry:
    """What the code an entry reaches dispatches on and instantiates."""

    chains: Set[tuple]     # value tuples of dispatch chains and cases
    templates: Set[tuple]  # argument tuples of template calls

    def has(self, tile) -> bool:
        """A pair (r, c) is instantiated by neighbouring values of a
        dispatch chain or the first two arguments of a template call; a
        one-dimensional tile t only by a value of a dispatch chain or a
        `case` (a template's first argument is as often a head dim or a
        width as a tile)."""
        if isinstance(tile, int):
            return any(tile in c for c in self.chains)
        r, c = tile
        return (any(ch[i:i + 2] == (r, c) for ch in self.chains for i in range(len(ch) - 1))
                or any(t[:2] == (r, c) for t in self.templates))


class CudaUnit:
    """The sources of one translation unit (a `.cu` file and the headers it
    includes), read once: macros expanded, functions indexed."""

    def __init__(self, sources: Sequence[SourceFile]):
        self.env = _constants("\n".join(sf.code for sf in sources))
        self.text = _expand_macros("\n".join(sf.skeleton for sf in sources))
        self.functions = _functions(self.text)
        self.templates = _template_functions(self.text)

    def reached(self, entry: str) -> List[Tuple[int, int]]:
        """The bodies of the functions `entry` reaches: every function whose
        name appears in a reached body, transitively (a name shared by
        overloads reaches each)."""
        seen, work, spans = set(), [entry], []
        while work:
            name = work.pop()
            if name in seen or name not in self.functions:
                continue
            seen.add(name)
            for a, b in self.functions[name]:
                spans.append((a, b))
                work += [w for w in set(re.findall(r"\w+", self.text[a:b]))
                         if w in self.functions]
        return spans

    def geometry(self, entry: str) -> CudaGeometry:
        """The dispatch chains, cases and template instantiations inside
        the functions `entry` reaches, each template call's arguments bound
        for every instantiation of the function template holding it."""
        spans = self.reached(entry)

        def inside(pos: int) -> bool:
            return any(a <= pos <= b for a, b in spans)
        env, text = self.env, self.text

        def values(chain: str, op: str) -> tuple:
            return tuple(_c_int(part.split(op)[1], env) for part in re.split(r"&&|\|\|", chain))
        chains = {values(m.group(0), "==") for m in _EQ_CHAIN.finditer(text) if inside(m.start())}
        chains |= {values(m.group(0), "!=") for m in _NE_CHAIN.finditer(text)
                   if inside(m.start())}
        chains |= {(_c_int(m.group(1), env),) for m in _CASE_RE.finditer(text)
                   if inside(m.start())}

        calls = [(m.group(1), _split_top(m.group(2)), m.start())
                 for m in _TCALL_RE.finditer(text) if inside(m.start())]

        def holder(pos: int):
            best = None
            for f in self.templates:
                if f[2] <= pos <= f[3] and (best is None or f[2] > best[2]):
                    best = f
            return best
        holders = [holder(pos) for _, _, pos in calls]
        insts: Dict[str, Set[tuple]] = {}
        for _ in range(8):  # bind each holder's instantiations, to a fixed point
            grew = False
            for (name, args, _), h in zip(calls, holders):
                bindings = [{}]
                if h is not None:
                    bindings += [dict(zip(h[1], t)) for t in insts.get(h[0], ())]
                for bnd in bindings:
                    scope = {**env, **{k: v for k, v in bnd.items() if v is not None}}
                    t = tuple(_c_int(a, scope) for a in args)
                    if t not in insts.setdefault(name, set()):
                        insts[name].add(t)
                        grew = True
            if not grew:
                break
        return CudaGeometry(chains, {t for ts in insts.values() for t in ts})


def _with_includes(sf: SourceFile, by_path: Dict[str, SourceFile],
                   by_name: Dict[str, List[SourceFile]]) -> List[SourceFile]:
    """sf and the headers it includes (`#include "x"`), transitively: from
    the analyzed set (beside sf, else by file name), else from disk."""
    out, work, seen = [], [sf], set()
    while work:
        f = work.pop()
        if f.path in seen:
            continue
        seen.add(f.path)
        out.append(f)
        for inc in _INCLUDE_RE.findall(f.code):
            p = os.path.normpath(os.path.join(os.path.dirname(f.path), inc))
            hit = by_path.get(p) or next(iter(by_name.get(os.path.basename(inc), [])), None)
            if hit is None and os.path.isfile(p):
                hit = by_path[p] = load_source(p)
            if hit is not None:
                work.append(hit)
    return sorted(out, key=lambda f: f.path)


def launches_of_constants(tree: ast.AST, entries: Set[str]) -> Dict[str, List[Set[str]]]:
    """Module-level name -> the launches a value read under that name
    reaches, each the set of C entries (`lib.<entry>(` calls) of one
    launching function: the functions that read the name (directly, or
    through a module-level constant built from it), the functions they
    call, and their callers up to the first that launches.  A name that no
    launching function reaches maps to one launch of every entry the module
    calls."""
    funcs: Dict[str, List[ast.AST]] = {}
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(n.name, []).append(n)
    reads, calls, launches = {}, {}, {}
    for name, defs in funcs.items():
        nodes = [x for d in defs for x in ast.walk(d)]
        reads[name] = {x.id for x in nodes if isinstance(x, ast.Name)}
        called = [x.func for x in nodes if isinstance(x, ast.Call)]
        calls[name] = {f.id for f in called if isinstance(f, ast.Name) and f.id in funcs}
        launches[name] = {f.attr for f in called
                          if isinstance(f, ast.Attribute) and f.attr in entries}
    callers: Dict[str, Set[str]] = {}
    for name, cs in calls.items():
        for c in cs:
            callers.setdefault(c, set()).add(name)
    built_from: Dict[str, Set[str]] = {}  # module constant -> the names it is built of
    for node in getattr(tree, "body", []):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            used = {x.id for x in ast.walk(node.value) if isinstance(x, ast.Name)}
            for t in targets:
                for x in ast.walk(t):
                    if isinstance(x, ast.Name):
                        built_from.setdefault(x.id, set()).update(used)
    everything = set().union(*launches.values()) if launches else set()

    def reach(const: str) -> List[Set[str]]:
        names = {const}
        while True:
            more = {k for k, v in built_from.items() if v & names} - names
            if not more:
                break
            names |= more
        users = [f for f, r in reads.items() if r & names]
        launchers: Set[str] = set()
        for step in (calls, callers):  # down from the readers, then up
            work, seen = list(users), set()
            while work:
                f = work.pop()
                if f in seen:
                    continue
                seen.add(f)
                if launches[f]:
                    launchers.add(f)
                if step is calls or not launches[f]:
                    work += step.get(f, ())
        groups = [launches[f] for f in sorted(launchers)]
        return groups or ([everything] if everything else [])
    return {name: reach(name) for name in built_from}


def check_launch_geometry(files: Sequence[SourceFile]) -> List[Finding]:
    """KRN103: every tile of a wrapper's geometry constants is one that
    each launch it reaches can take: one of the C entries of that launching
    function dispatches on it or instantiates it."""
    cuda = [sf for sf in files if sf.is_cuda]
    if not cuda:
        return []
    entries: Dict[str, SourceFile] = {}  # entry -> the source defining it
    for sf in cuda:
        for m in _ENTRY_RE.finditer(sf.code):
            if _FUNC_TAIL.match(sf.code, _match_close(sf.code, m.end() - 1, "(", ")") + 1):
                entries[m.group(1)] = sf
    by_path = {sf.path: sf for sf in cuda}
    by_name: Dict[str, List[SourceFile]] = {}
    for sf in cuda:
        by_name.setdefault(os.path.basename(sf.path), []).append(sf)
    units: Dict[str, CudaUnit] = {}
    geometries: Dict[str, CudaGeometry] = {}

    def geometry(entry: str) -> CudaGeometry:
        if entry not in geometries:
            path = entries[entry].path
            if path not in units:
                units[path] = CudaUnit(_with_includes(entries[entry], by_path, by_name))
            geometries[entry] = units[path].geometry(entry)
        return geometries[entry]
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        consts = geometry_constants(sf)
        if not consts:
            continue
        reached = launches_of_constants(sf.tree, set(entries))
        for name, line, tiles in consts:
            for tile in tiles:
                refusing = [sorted(g) for g in reached.get(name, ())
                            if not any(geometry(e).has(tile) for e in g)]
                if not refusing:
                    continue
                shown = tile if isinstance(tile, int) else f"{tile[0]} x {tile[1]}"
                where = " and ".join(
                    " or ".join(f"{e} ({os.path.basename(entries[e].path)})" for e in g)
                    for g in refusing)
                findings.append(Finding(
                    sf.path, line, "KRN103", "error",
                    f"{name} holds the tile {shown}, which {where} neither "
                    f"dispatches on nor instantiates: a launch the wrapper "
                    f"can choose and its C entry refuses",
                    fix_hint=f"instantiate {shown} in the entry's dispatch, or "
                             f"drop it from {name}"))
    return findings


# -- per-file CUDA checks (KRN101, KRN102) ------------------------------------

_LOW_TYPES = r"(?:__half2?|half2?|__nv_bfloat162?|nv_bfloat162?|bf16(?:x2)?|bf162)"
_FRAG_RE = re.compile(r"\bfragment\s*<\s*(?:[\w:]*::)?(\w+)\s*,([^<>;{}]*)>\s*([^;(){}]*);")
_ACC_ARRAY_RE = re.compile(rf"(?<![\w:])(?:[\w]+::)?({_LOW_TYPES})\s+(\w*acc\w*)\s*\[")
_WGMMA_RE = re.compile(r"wgmma\.mma_async(?:\.sp)?\.sync\.aligned\.m\d+n\d+k\d+"
                       r"\.(\w+)\.(\w+)\.(\w+)")
_MMA_RE = re.compile(r"\bmma\.sync\.aligned\.m\d+n\d+k\d+((?:\.\w+)+)")
_MMA_SYNC_RE = re.compile(r"\bmma_sync\s*\(\s*([\w.\[\]]+)\s*,\s*([\w.\[\]]+)")
_FLOAT_PTX = {"bf16", "f16", "tf32", "e4m3", "e5m2", "f32", "f64"}
_INT_PTX = {"s8", "u8", "s4", "u4", "b1"}
_INT_WMMA = {"signed char", "unsigned char", "char", "int8_t", "uint8_t", "precision::s4",
             "precision::u4", "precision::b1", "experimental::precision::s4",
             "experimental::precision::u4", "experimental::precision::b1"}


def _want_accum(operand: str) -> Optional[str]:
    if operand in _INT_PTX:
        return "s32"
    if operand in _FLOAT_PTX:
        return "f64" if operand == "f64" else "f32"
    return None


def _krn102(sf: SourceFile, pos: int, what: str, acc: str, operand: str,
            want: str) -> Finding:
    return Finding(
        sf.path, sf.line_at(pos), "KRN102", "error",
        f"{what} accumulates at {acc} over {operand} operands; the tensor "
        f"cores would round every partial sum to {acc}",
        fix_hint=f"accumulate at {want} and convert on the final store")


def _fragments(code: str) -> Dict[str, Tuple[str, str]]:
    """name -> (use, element type) of every wmma fragment declared."""
    out = {}
    for m in _FRAG_RE.finditer(code):
        use, args = m.group(1), _split_top(m.group(2))
        for decl in _split_top(m.group(3)):
            name = re.match(r"(\w+)", decl)
            if name and args:
                elem = args[3] if use in ("matrix_a", "matrix_b") and len(args) > 3 else args[-1]
                out[name.group(1)] = (use, elem.strip())
    return out


def check_file(sf: SourceFile) -> List[Finding]:
    """Per-file KRN checks: KRN101 and KRN102 over a CUDA source.  A Python
    file has none of its own (the port has no Pallas bodies); its launch
    geometry is KRN103's, which needs its CUDA sources beside it."""
    if not sf.is_cuda:
        return []
    out: List[Finding] = []
    code = sf.code
    frags = _fragments(code)
    for m in _FRAG_RE.finditer(code):
        elem = _split_top(m.group(2))[-1]
        if m.group(1) == "accumulator" and re.fullmatch(rf"(?:[\w]+::)?{_LOW_TYPES}", elem):
            out.append(Finding(
                sf.path, sf.line_at(m.start()), "KRN101", "error",
                f"wmma accumulator fragment declared at {elem}; accumulators "
                f"must be float (int for integer products)",
                fix_hint="declare the fragment at float and convert on the "
                         "final store"))
    for m in _ACC_ARRAY_RE.finditer(sf.skeleton):
        out.append(Finding(
            sf.path, sf.line_at(m.start()), "KRN101", "error",
            f"accumulator array {m.group(2)} declared at {m.group(1)}; "
            f"accumulators must be float (int for integer products)",
            fix_hint="declare the accumulator at float and pack to bf16 on "
                     "the final store"))
    for m in _WGMMA_RE.finditer(code):
        acc, a, b = m.groups()
        want = _want_accum(a)
        if want is not None and acc != want:
            out.append(_krn102(sf, m.start(), "wgmma.mma_async", acc, a, want))
    for m in _MMA_RE.finditer(code):
        types = [t for t in m.group(1).split(".")
                 if t and t not in ("row", "col", "satfinite")]
        if len(types) < 3:
            continue
        acc, a = types[0], types[1]
        want = _want_accum(a)
        if want is not None and (acc != want or (len(types) > 3 and types[3] != want)):
            out.append(_krn102(sf, m.start(), "mma.sync", acc, a, want))
    for m in _MMA_SYNC_RE.finditer(sf.skeleton):
        d, a = (re.match(r"\w+", x.split(".")[-1]).group(0) for x in m.groups())
        if d not in frags:
            continue
        acc = frags[d][1]
        a_type = frags.get(a, ("", ""))[1]
        want = "int" if a_type in _INT_WMMA else "float"
        if acc != want:
            out.append(_krn102(sf, m.start(), "wmma::mma_sync", acc, a_type or "?", want))
    return out

