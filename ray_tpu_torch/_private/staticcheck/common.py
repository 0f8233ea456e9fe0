"""Shared infrastructure for the static-analysis passes.

Counterpart of ``ray_tpu/_private/staticcheck/common.py``.  Everything
here is stdlib-only: ``rtpu check`` imports neither torch nor JAX and runs
with no cluster and no card.  A pass is a function ``check(root) ->
list[Violation]`` where ``root`` is a repo root (a directory holding a
``ray_tpu_torch/`` tree); passing a fixture tree instead of the real repo
is how the checker tests itself.

Every pass reads its files through ``source``.  Within one run
(``one_parse_per_file``) a file is read once and parsed once, however
many passes and helpers ask for it, and its AST nodes are walked once and
kept by type (``Source.nodes``); nothing is kept after the run.
"""

from __future__ import annotations

import ast
import bisect
import collections
import contextlib
import fnmatch
import os
from dataclasses import dataclass, field

PACKAGE = "ray_tpu_torch"


def repo_root() -> str:
    """The repo root this package was imported from (…/ray_tpu_torch/../)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


@dataclass(frozen=True)
class Violation:
    """One finding: a rule broken at a specific source location.

    ``rule`` is ``<pass>/<kind>`` (e.g. ``drift/opcode``); allowlist
    entries match on it plus the path and a message substring.
    """

    rule: str
    path: str  # relative to root, forward slashes
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Allow:
    """One allowlist entry.  ``reason`` is mandatory and must say *why*
    the finding is acceptable: a bare suppression is itself a check
    failure (see ``validate_allowlist``)."""

    rule: str  # exact rule, or a fnmatch pattern like "locks/*"
    path: str  # fnmatch pattern on the relative path
    match: str  # substring that must occur in the violation message ("" = any)
    reason: str

    def covers(self, v: Violation) -> bool:
        return (fnmatch.fnmatchcase(v.rule, self.rule)
                and fnmatch.fnmatchcase(v.path, self.path)
                and (not self.match or self.match in v.message))


@dataclass
class Report:
    violations: list[Violation] = field(default_factory=list)
    suppressed: list[tuple[Violation, Allow]] = field(default_factory=list)
    unused_allows: list[Allow] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def apply_allowlist(violations: list[Violation],
                    allows: list[Allow]) -> Report:
    report = Report()
    used: set[int] = set()
    for v in violations:
        hit = next((a for a in allows if a.covers(v)), None)
        if hit is None:
            report.violations.append(v)
        else:
            report.suppressed.append((v, hit))
            used.add(id(hit))
    report.unused_allows = [a for a in allows if id(a) not in used]
    return report


def validate_allowlist(allows: list[Allow]) -> list[str]:
    """Every entry must carry a real reason string (the acceptance bar
    for shipping a suppression instead of a fix)."""
    errors = []
    for a in allows:
        if not (a.reason or "").strip():
            errors.append(f"allowlist entry {a.rule!r} on {a.path!r} has no reason")
    return errors


class Source:
    """One file's text, and for Python its AST, parsed on first use."""

    __slots__ = ("rel", "text", "_tree", "_error", "_nodes", "_cc")

    def __init__(self, rel: str, text: str):
        self.rel, self.text = rel, text
        self._tree = self._error = self._nodes = self._cc = None

    @property
    def tree(self) -> ast.Module:
        """The module's AST; raises the parse's ``SyntaxError``."""
        if self._tree is None and self._error is None:
            try:
                self._tree = ast.parse(self.text)
            except SyntaxError as e:
                self._error = e
        if self._error is not None:
            raise self._error
        return self._tree

    def nodes(self, kind: type) -> list:
        """Every node of the AST of type ``kind``, in the order
        ``ast.walk`` gives them (one walk per file, shared by the passes)."""
        if self._nodes is None:
            self._nodes = _index(self.tree)
        return self._nodes.get(kind, [])

    @property
    def cc_code(self) -> str:
        """``strip_cc_noise`` of the text, computed once."""
        if self._cc is None:
            self._cc = strip_cc_noise(self.text)
        return self._cc


def _index(tree: ast.AST) -> dict[type, list]:
    """The nodes of ``tree`` by type, each list in ``ast.walk``'s
    breadth-first order (the same walk, without its generators)."""
    by_type: dict[type, list] = {}
    queue = collections.deque([tree])
    pop, push, AST = queue.popleft, queue.append, ast.AST
    while queue:
        node = pop()
        kind = type(node)
        bucket = by_type.get(kind)
        if bucket is None:
            bucket = by_type[kind] = []
        bucket.append(node)
        for name in node._fields:
            value = getattr(node, name, None)
            if isinstance(value, list):
                for item in value:
                    if isinstance(item, AST):
                        push(item)
            elif isinstance(value, AST):
                push(value)
    return by_type


_RUN_CACHE: dict[str, Source] | None = None


@contextlib.contextmanager
def one_parse_per_file():
    """Within the block (one ``run``) every file is read and parsed once,
    whichever passes ask for it; outside it each ``source`` call reads
    the file afresh, so nothing is held between runs."""
    global _RUN_CACHE
    _RUN_CACHE = {}
    try:
        yield
    finally:
        _RUN_CACHE = None


def source(root: str, rel: str) -> Source | None:
    """The ``Source`` of one file by repo-relative path; None if absent
    (fixture trees carry only the files their pass needs)."""
    path = os.path.abspath(os.path.join(root, *rel.split("/")))
    if _RUN_CACHE is not None and path in _RUN_CACHE:
        return _RUN_CACHE[path]
    try:
        with open(path, errors="replace") as fh:
            src = Source(rel, fh.read())
    except FileNotFoundError:
        return None
    if _RUN_CACHE is not None:
        _RUN_CACHE[path] = src
    return src


def walk_files(root: str, exts: tuple[str, ...],
               subdir: str = PACKAGE) -> list[Source]:
    """Every matching source under root/subdir, sorted within each
    directory, as cached ``Source``s."""
    base = os.path.join(root, subdir)
    out = []
    for dirpath, dirnames, files in os.walk(base):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build", ".git")]
        for f in sorted(files):
            if f.endswith(exts):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      root).replace(os.sep, "/")
                src = source(root, rel)
                if src is not None:
                    out.append(src)
    return out


def read_source(root: str, rel: str) -> str | None:
    """Read one file by repo-relative path; None if absent."""
    src = source(root, rel)
    return None if src is None else src.text


class LineIndex:
    """Offset -> 1-based line number for regex matches over whole files."""

    def __init__(self, text: str):
        self._starts = [0]
        pos = text.find("\n")
        while pos >= 0:
            self._starts.append(pos + 1)
            pos = text.find("\n", pos + 1)

    def line(self, offset: int) -> int:
        return bisect.bisect_right(self._starts, offset)


def strip_cc_noise(text: str) -> str:
    """Blank out C++ comments and string/char literals, preserving
    offsets and newlines, so regexes over the remainder can't match
    inside prose or log strings."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        if ch == "/" and nxt == "/":
            while i < n and text[i] != "\n":
                out[i] = " "
                i += 1
        elif ch == "/" and nxt == "*":
            out[i] = out[i + 1] = " "
            i += 2
            while i < n and not (text[i] == "*" and i + 1 < n
                                 and text[i + 1] == "/"):
                if text[i] != "\n":
                    out[i] = " "
                i += 1
            if i < n:
                out[i] = " "
                if i + 1 < n:
                    out[i + 1] = " "
                i += 2
        elif ch in ("\"", "'"):
            quote = ch
            out[i] = " "
            i += 1
            while i < n and text[i] != quote:
                if text[i] == "\\":
                    out[i] = " "
                    i += 1
                    if i < n and text[i] != "\n":
                        out[i] = " "
                    i += 1
                    continue
                if text[i] != "\n":
                    out[i] = " "
                i += 1
            if i < n:
                out[i] = " "
                i += 1
        else:
            i += 1
    return "".join(out)

