"""Source loading + per-line `# repro: noqa[...]` pragma suppression.

Pragma syntax (modeled on flake8's noqa, namespaced so generic linters
ignore it):

    x = do_thing()          # repro: noqa[KRN102]
    y = other_thing()       # repro: noqa[KRN101,JIT201]
    z = last_thing()        # repro: noqa          <- suppresses every rule

A suppression applies to findings anchored on its line.  Unknown rule IDs
inside the brackets raise ANA002 (a typo'd suppression that silently stops
suppressing is worse than noise).

CUDA sources (`.cu`, `.cuh`) take the same pragma in a `//` comment
(`acc[i] += x;  // repro: noqa[KRN101]`).  They are not parsed: a
`SourceFile` of one carries `code`, the text with its comments blanked
(string literals kept, since the PTX of a product lives in one), and
`skeleton`, the code with the string literals' contents blanked too, both
the text's length with its newlines in place, so an offset in either is a
line of the file.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding
from .rules import RULES

NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\s*\[(?P<rules>[A-Za-z0-9_,\s]*)\])?")
CUDA_NOQA_RE = re.compile(
    r"//\s*repro:\s*noqa(?:\s*\[(?P<rules>[A-Za-z0-9_,\s]*)\])?")
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass
class Suppressions:
    """Per-file map of line -> suppressed rule IDs (None = all rules)."""

    by_line: Dict[int, Optional[Set[str]]]
    unknown: List[Tuple[int, str]]  # (line, bad rule id) for ANA002

    def is_suppressed(self, line: int, rule_id: str) -> bool:
        if line not in self.by_line:
            return False
        rules = self.by_line[line]
        return rules is None or rule_id in rules


def _iter_comments(text: str, lines: List[str]):
    """(line, comment_text) pairs — real comments only, via tokenize, so a
    docstring *showing* the pragma syntax never counts as a suppression.
    Falls back to a whole-line scan if the file does not tokenize."""
    try:
        import io
        import tokenize

        toks = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, line in enumerate(lines, start=1):
            yield i, line
        return
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            yield tok.start[0], tok.string


def _suppressions(comments, regex) -> Suppressions:
    by_line: Dict[int, Optional[Set[str]]] = {}
    unknown: List[Tuple[int, str]] = []
    for i, comment in comments:
        m = regex.search(comment)
        if not m:
            continue
        spec = m.group("rules")
        if spec is None:
            by_line[i] = None  # bare noqa: everything
            continue
        ids = {r.strip() for r in spec.split(",") if r.strip()}
        for rid in ids:
            if rid not in RULES:
                unknown.append((i, rid))
        by_line[i] = ids
    return Suppressions(by_line=by_line, unknown=unknown)


def scan_pragmas(text: str, lines: List[str]) -> Suppressions:
    return _suppressions(_iter_comments(text, lines), NOQA_RE)


def lex_cuda(text: str) -> Tuple[str, str, List[Tuple[int, str]]]:
    """(code, skeleton, comments) of a C++ source: `code` blanks every
    comment, `skeleton` also the contents of string and character literals
    (their quotes stay), each of the text's length with its newlines kept;
    `comments` are the `//` comments as (line, text)."""
    code, skel = list(text), list(text)
    comments: List[Tuple[int, str]] = []
    i, n, line = 0, len(text), 1

    def blank(a: int, b: int, both: bool) -> None:
        for j in range(a, b):
            if text[j] != "\n":
                skel[j] = " "
                if both:
                    code[j] = " "

    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, text[i:j]))
            blank(i, j, True)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            line += text.count("\n", i, j)
            blank(i, j, True)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            blank(i + 1, min(j, n), False)
            i = j + 1
        else:
            i += 1
    return "".join(code), "".join(skel), comments


def scan_cuda_pragmas(text: str, lines: List[str]) -> Suppressions:
    return _suppressions(lex_cuda(text)[2], CUDA_NOQA_RE)


@dataclasses.dataclass
class SourceFile:
    path: str
    text: str
    lines: List[str]
    tree: Optional[ast.AST]  # None when the file does not parse (or is CUDA)
    parse_error: Optional[str]
    suppressions: Suppressions
    code: Optional[str] = None      # CUDA: the text, comments blanked
    skeleton: Optional[str] = None  # CUDA: ... and literals' contents too

    @property
    def is_cuda(self) -> bool:
        return self.code is not None

    def find_line(self, needle: str, default: int = 1) -> int:
        """First 1-based line containing `needle` (shape-audit attribution:
        point the finding at the offending literal, so a noqa pragma on that
        line suppresses it naturally)."""
        for i, text in enumerate(self.lines, start=1):
            if needle in text:
                return i
        return default

    def line_at(self, offset: int) -> int:
        """1-based line of a character offset into `text` (or `code`)."""
        return self.text.count("\n", 0, offset) + 1


def load_source(path: str) -> SourceFile:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    lines = text.splitlines()
    if path.endswith(CUDA_SUFFIXES):
        code, skel, comments = lex_cuda(text)
        return SourceFile(path=path, text=text, lines=lines, tree=None, parse_error=None,
                          suppressions=_suppressions(comments, CUDA_NOQA_RE), code=code,
                          skeleton=skel)
    tree: Optional[ast.AST] = None
    err: Optional[str] = None
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        err = f"{e.msg} (line {e.lineno})"
    return SourceFile(path=path, text=text, lines=lines, tree=tree,
                      parse_error=err,
                      suppressions=scan_pragmas(text, lines))


def _iter_files(paths: List[str], suffixes: Tuple[str, ...]) -> List[str]:
    out: List[str] = []
    seen: Set[str] = set()

    def add(p: str):
        p = os.path.normpath(p)
        if p not in seen:
            seen.add(p)
            out.append(p)

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(suffixes):
                add(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            for name in sorted(files):
                if name.endswith(suffixes):
                    add(os.path.join(root, name))
    return out


def iter_python_files(paths: List[str]) -> List[str]:
    """Expand files/directories into a sorted, deduped .py file list
    (skipping __pycache__ and hidden directories)."""
    return _iter_files(paths, (".py",))


def iter_cuda_files(paths: List[str]) -> List[str]:
    """The same walk over CUDA sources (.cu, .cuh)."""
    return _iter_files(paths, CUDA_SUFFIXES)


def engine_findings(sf: SourceFile) -> List[Finding]:
    """Findings the loader itself raises: parse errors and bad pragmas."""
    out: List[Finding] = []
    if sf.parse_error is not None:
        out.append(Finding(sf.path, 1, "ANA001", "error",
                           f"syntax error: {sf.parse_error}"))
    for line, rid in sf.suppressions.unknown:
        out.append(Finding(
            sf.path, line, "ANA002", "warn",
            f"pragma names unknown rule {rid!r}",
            fix_hint="check the rule catalog: python -m repro_torch.analysis "
                     "--list-rules"))
    return out
