"""Capture hygiene (JIT rules) — keep traced and captured programs pure.

The port has no `jax.jit`.  Its counterparts, where host code runs once and
what it did is then replayed, are the regions `torch.compile` traces and
CUDA graphs capture.  The obs layer's contract is that instrumentation
lives *outside* them: a span or counter there fires once, at trace or
capture time, and records nothing on replay, while the trace looks
instrumented.  Host-side RNG and clocks freeze to their first values.  This
pass finds those hazards statically, with the JAX package's logic
(`repro.analysis.jit_hygiene`) over the port's roots.

Scope: functions *reachable from a root within the same module* —

  * defs decorated with ``@torch.compile`` / ``@torch.compile(...)`` /
    ``@functools.partial(torch.compile, ...)``,
  * defs passed to ``torch.compile(f)``,
  * defs passed to ``torch.cuda.make_graphed_callables(f, ...)`` (or a
    tuple of them),
  * defs called inside a ``with torch.cuda.graph(...)`` block, whose own
    statements are checked as a captured region too,

plus anything those call locally.  Cross-module reachability is out of
scope, as in JAX's pass.

Rules:

  * JIT201 — obs call (span/counter/record_dispatch/...) inside traced or
    captured code.
  * JIT202 — host RNG / clock (`time.*`, `random.*`, `np.random.*`,
    `datetime.*`) inside traced or captured code: freezes to a constant.
  * JIT203 — mutable default argument on a traced function: shared across
    every trace.
  * JIT204 — traced or captured code declares `global`, or reads a
    module-level mutable (list/dict/set) that the module mutates: captured
    once, later mutation never reaches the replay.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .findings import Finding
from .source import SourceFile

_OBS_CALLS = {"span", "instant", "counter", "gauge", "histogram",
              "record_dispatch", "enable", "disable", "export_all"}
_HOST_EFFECT_ROOTS = {"time", "random", "datetime"}


def _dotted(node: ast.AST) -> Optional[str]:
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


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _is_compile_name(name: Optional[str]) -> bool:
    return name == "torch.compile"


def _is_compile_expr(node: ast.expr) -> bool:
    """torch.compile, torch.compile(...), or functools.partial(torch.compile, ...)."""
    if _is_compile_name(_dotted(node)):
        return True
    if isinstance(node, ast.Call):
        cn = _call_name(node)
        if _last(cn) == "partial" and node.args:
            return _is_compile_expr(node.args[0])
        return _is_compile_name(cn)
    return False


def _is_graph_ctx(node: ast.expr) -> bool:
    """torch.cuda.graph(...) (the capture context)."""
    if not isinstance(node, ast.Call):
        return False
    parts = _call_name(node).split(".")
    return parts[-1] == "graph" and "cuda" in parts[:-1]


def _fn_names_in(expr: ast.expr) -> List[str]:
    """Local function names referenced by a callable-ish argument."""
    if isinstance(expr, ast.Name):
        return [expr.id]
    if isinstance(expr, (ast.Tuple, ast.List)):
        return [n for e in expr.elts for n in _fn_names_in(e)]
    if isinstance(expr, ast.Call):
        cn = _call_name(expr)
        if _last(cn) == "partial" and expr.args:
            return _fn_names_in(expr.args[0])
    return []


def _collect_defs(nodes) -> Dict[str, ast.FunctionDef]:
    defs: Dict[str, ast.FunctionDef] = {}
    for node in nodes:
        if isinstance(node, ast.FunctionDef):
            defs.setdefault(node.name, node)
    return defs


def _capture_blocks(nodes) -> List[ast.With]:
    return [n for n in nodes if isinstance(n, ast.With)
            and any(_is_graph_ctx(item.context_expr) for item in n.items)]


def _collect_roots(nodes, defs: Dict[str, ast.FunctionDef],
                   blocks: List[ast.With]) -> Set[str]:
    roots: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.FunctionDef):
            if any(_is_compile_expr(dec) for dec in node.decorator_list):
                roots.add(node.name)
        elif isinstance(node, ast.Call) and node.args:
            name = _call_name(node)
            # torch.compile(fn), torch.cuda.make_graphed_callables(fn | (f, g), ...)
            if _is_compile_name(name) or _last(name) == "make_graphed_callables":
                roots.update(fn for fn in _fn_names_in(node.args[0]) if fn in defs)

    # with torch.cuda.graph(g): every local def the block calls is captured
    for block in blocks:
        for stmt in block.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    callee = _last(_call_name(node))
                    if callee in defs:
                        roots.add(callee)
    return roots


def _reachable(roots: Set[str],
               defs: Dict[str, ast.FunctionDef]) -> Set[str]:
    seen: Set[str] = set()
    work = [r for r in roots if r in defs]
    while work:
        name = work.pop()
        if name in seen:
            continue
        seen.add(name)
        fn = defs[name]
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _last(_call_name(node))
                if callee in defs and callee not in seen:
                    work.append(callee)
    return seen


def _module_mutables(tree: ast.AST) -> Dict[str, int]:
    """Module-level names bound to mutable list/dict/set values that the
    module also *mutates* somewhere (a frozen-in-practice constant dict is a
    legitimate capture; one that code appends to is not)."""
    bound: Dict[str, int] = {}
    for node in getattr(tree, "body", []):
        targets = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp,
                                     ast.SetComp))
        if isinstance(value, ast.Call) and _last(
                _call_name(value)) in ("list", "dict", "set",
                                       "defaultdict", "deque"):
            mutable = True
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                bound[t.id] = node.lineno

    mutated: Set[str] = set()
    _MUTATORS = {"append", "extend", "add", "update", "pop", "popitem",
                 "setdefault", "clear", "insert", "remove", "discard"}
    for node in ast.walk(tree):
        # d[k] = v / del d[k] / d[k] += v
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign,
                                                         ast.Delete))
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)):
                    mutated.add(t.value.id)
        # d.update(...) etc.
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
                and isinstance(node.func.value, ast.Name)):
            mutated.add(node.func.value.id)
        # global d; d = ...
        if isinstance(node, ast.Global):
            mutated.update(node.names)
    return {n: ln for n, ln in bound.items() if n in mutated}


def _mutable_defaults(fn: ast.FunctionDef) -> List[ast.expr]:
    out = []
    for d in list(fn.args.defaults) + [d for d in fn.args.kw_defaults
                                       if d is not None]:
        if isinstance(d, (ast.List, ast.Dict, ast.Set)):
            out.append(d)
        elif isinstance(d, ast.Call) and _last(
                _call_name(d)) in ("list", "dict", "set"):
            out.append(d)
    return out


def _local_bindings(fn: Optional[ast.FunctionDef]) -> Set[str]:
    if fn is None:
        return set()
    bound = {a.arg for a in (fn.args.args + fn.args.kwonlyargs
                             + fn.args.posonlyargs)}
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                     (ast.Store,
                                                      ast.Del)):
            bound.add(node.id)
        elif isinstance(node, ast.FunctionDef) and node is not fn:
            bound.add(node.name)
    return bound


def _enclosing(tree: ast.AST, target: ast.AST) -> Optional[ast.FunctionDef]:
    best = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.lineno <= target.lineno <= max(
                getattr(node, "end_lineno", node.lineno), node.lineno):
            if best is None or node.lineno > best.lineno:
                best = node
    return best


def _check_region(sf: SourceFile, what: str, nodes, local: Set[str],
                  mutables: Dict[str, int]) -> List[Finding]:
    """JIT201, JIT202 and JIT204 over the AST nodes of one traced function
    or captured block (`what` names it in the messages)."""
    out: List[Finding] = []
    flagged: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.Call):
            cname = _call_name(node)
            if not cname:
                continue
            head, tail = cname.split(".")[0], _last(cname)

            # JIT201: obs instrumentation inside traced code
            if head == "obs" and tail in _OBS_CALLS:
                out.append(Finding(
                    sf.path, node.lineno, "JIT201", "error",
                    f"obs.{tail}() inside {what}: fires once at trace or "
                    f"capture time, then records nothing on replay",
                    fix_hint="hoist it to the caller outside the compiled "
                             "or captured region"))

            # JIT202: host RNG / clocks inside traced code
            host = (head in _HOST_EFFECT_ROOTS and head not in local) or \
                cname.startswith(("np.random.", "numpy.random."))
            if host:
                out.append(Finding(
                    sf.path, node.lineno, "JIT202", "error",
                    f"host effect {cname}() inside {what}: freezes to its "
                    f"value at trace or capture time",
                    fix_hint="draw on the device with a torch.Generator, "
                             "or pass the value in as a tensor argument"))

        # JIT204: `global` in traced code, and reads of module-level
        # mutables the module actually mutates (one finding per name)
        elif isinstance(node, ast.Global):
            out.append(Finding(
                sf.path, node.lineno, "JIT204", "error",
                f"{what} declares global {', '.join(node.names)}: module "
                f"state mutated from traced or captured code changes at "
                f"trace or capture time only",
                fix_hint="return the value and update module state in the "
                         "caller outside the region"))
        elif (isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in mutables
                and node.id not in local
                and node.id not in flagged):
            flagged.add(node.id)
            out.append(Finding(
                sf.path, node.lineno, "JIT204", "error",
                f"{what} reads module-level mutable {node.id!r}; captured "
                f"once, later mutation never reaches the replay",
                fix_hint="pass it as an argument or freeze it to a tuple"))
    return out


def check_file(sf: SourceFile) -> List[Finding]:
    if sf.tree is None:
        return []
    nodes = list(ast.walk(sf.tree))
    defs = _collect_defs(nodes)
    blocks = _capture_blocks(nodes)
    roots = _collect_roots(nodes, defs, blocks)
    if not roots and not blocks:
        return []
    traced = _reachable(roots, defs)
    mutables = _module_mutables(sf.tree)
    out: List[Finding] = []

    for name in sorted(traced):
        fn = defs[name]

        # JIT203: mutable defaults on the traced def itself
        for d in _mutable_defaults(fn):
            out.append(Finding(
                sf.path, d.lineno, "JIT203", "error",
                f"traced function {name!r} has a mutable default "
                f"argument; it is shared across every trace",
                fix_hint="default to None and construct inside, or make "
                         "it a static tuple"))
        out += _check_region(sf, f"traced function {name!r}", ast.walk(fn),
                             _local_bindings(fn), mutables)

    for block in blocks:
        nodes = [n for stmt in block.body for n in ast.walk(stmt)]
        out += _check_region(sf, f"the torch.cuda.graph block at line {block.lineno}", nodes,
                             _local_bindings(_enclosing(sf.tree, block)), mutables)
    return out
