"""Pass 2: concurrency analysis.

Counterpart of ``ray_tpu/_private/staticcheck/locks.py`` over the port's
tree: the C++ side reads ``ray_tpu_torch/native/*.cc``, the Python side
the port's ``_private/scheduler.py``, ``cluster_scheduler.py`` and
``node.py``.

C++ side: parse ``std::lock_guard`` / ``std::unique_lock`` acquisitions
per function in every ``native/*.cc``, tracking brace scopes so a
guard's lifetime ends with its enclosing block.  From the acquisitions
we build a per-file lock-order graph (edges A -> B when B is acquired
while A is held, with mutexes normalized to their *class* — ``cs->mu``
and ``it->second->mu`` are the same per-ClientState lock) and report
order inversions and cycles.  While any mutex is held we also flag
blocking syscalls (and calls to ``*Locked`` helpers that perform them —
the repo convention is that a ``FooLocked`` function runs under its
owner's mutex).

Python side: an AST pass over the scheduler stack flagging blocking
calls (``time.sleep``, socket send/recv, ``.get()``/``.result()`` on
refs or futures, ``subprocess.run``) made while lexically inside a
``with <lock>:`` block.
"""

from __future__ import annotations

import ast
import re

from ray_tpu_torch._private.staticcheck.common import (
    LineIndex,
    Violation,
    source,
    walk_files,
)

_ACQUIRE = re.compile(
    r"\b(?:std::)?(?:lock_guard|unique_lock|scoped_lock)\s*<[^>]*>\s*"
    r"(\w+)\s*[({]([^;]*?)[)}]\s*;")
_RELOCK = re.compile(r"\b(\w+)\.(unlock|lock)\s*\(\s*\)")
# Syscalls (and this repo's thin IO wrappers) that park the thread on
# the kernel: holding a mutex across one stalls every contender.
_BLOCKING = re.compile(
    r"\b(read|write|pread|pwrite|readv|writev|recv|send|sendmsg|recvmsg|"
    r"accept|connect|poll|select|sleep|usleep|nanosleep|fsync|fdatasync|"
    r"open|fopen|unlink|ftruncate|ReadFull|WriteFull|SendAll|RecvAll|"
    r"send_all|recv_full|recv_all)\s*\(")
_LOCKED_CALL = re.compile(r"\b(\w+Locked)\s*\(")
_SCOPE_KEYWORD = re.compile(r"\b(namespace|class|struct|union|enum)\b[^;()]*$")
_FN_SIG = re.compile(r"(\w+)\s*\([^;{}]*\)\s*(?:const|noexcept|override|\s)*$")


def normalize_mutex(expr: str) -> str | None:
    """Reduce a mutex expression to its lock *class*: the final member
    name.  ``cs->mu``, ``it->second->mu`` and ``slot->mu`` all guard one
    ClientState, and the class is what a lock-order discipline is about.
    """
    expr = expr.split(",")[0]  # unique_lock(mu, std::defer_lock) & co
    expr = expr.replace("&", "").replace("*", "").strip()
    if not expr or "(" in expr:
        return None  # e.g. unique_lock lk(MutexFor(id)) — dynamic, skip
    name = re.split(r"->|\.", expr)[-1].strip()
    return name or None


class _Scope:
    __slots__ = ("kind", "locks")

    def __init__(self, kind: str):
        self.kind = kind  # "function" | "container" | "block"
        self.locks: list[str] = []  # guard variable names born here


def _classify_scope(prev_chunk: str, in_function: bool) -> tuple[str, str]:
    """(kind, name) for the scope opened by a ``{`` preceded by
    ``prev_chunk`` (text back to the last ``;``/``{``/``}``)."""
    chunk = prev_chunk.strip()
    if in_function:
        return "block", ""
    if _SCOPE_KEYWORD.search(chunk):
        return "container", ""
    if chunk.endswith("="):
        return "container", ""  # aggregate initializer
    m = _FN_SIG.search(chunk)
    if m:
        return "function", m.group(1)
    return "container", ""


def _scan_cc_file(stripped: str):
    """Yield per-file facts: ('edge', a, b, line, fn), ('blocking', name,
    line, fn, held), ('locked_call', callee, line, fn, held), and
    ('body_blocking', fn, name, line) for direct blocking calls anywhere
    in fn (fuel for one-level *Locked propagation).  ``stripped`` is the
    file's text through ``strip_cc_noise``."""
    idx = LineIndex(stripped)

    events: list[tuple[int, str, object]] = []
    for i, ch in enumerate(stripped):
        if ch in "{}":
            events.append((i, ch, None))
    for m in _ACQUIRE.finditer(stripped):
        events.append((m.start(), "acquire", m))
    for m in _RELOCK.finditer(stripped):
        events.append((m.start(), "relock", m))
    for m in _BLOCKING.finditer(stripped):
        events.append((m.start(), "blocking", m))
    for m in _LOCKED_CALL.finditer(stripped):
        events.append((m.start(), "locked_call", m))
    events.sort(key=lambda e: (e[0], e[1] in "{}"))

    scopes: list[_Scope] = []
    held: list[tuple[str, str]] = []  # (guard var, lock class) in order
    fn_stack: list[str] = []
    last_break = 0  # offset after the last ; { or } seen at a boundary

    for off, kind, payload in events:
        if kind == "{":
            # chunk between the previous statement boundary and this brace
            seg = stripped[last_break:off]
            cut = max(seg.rfind(";"), seg.rfind("}"), seg.rfind("{"))
            chunk = seg[cut + 1:] if cut >= 0 else seg
            in_fn = any(s.kind == "function" for s in scopes)
            skind, name = _classify_scope(chunk, in_fn)
            scopes.append(_Scope(skind))
            if skind == "function":
                fn_stack.append(name)
            last_break = off + 1
        elif kind == "}":
            if scopes:
                top = scopes.pop()
                for var in top.locks:
                    held[:] = [h for h in held if h[0] != var]
                if top.kind == "function" and fn_stack:
                    fn_stack.pop()
            last_break = off + 1
        elif kind == "acquire":
            m = payload
            if "defer_lock" in m.group(2):
                continue
            lock = normalize_mutex(m.group(2))
            if lock is None or not scopes:
                continue
            line = idx.line(off)
            fn = fn_stack[-1] if fn_stack else "?"
            for _, held_class in held:
                if held_class != lock:
                    yield ("edge", held_class, lock, line, fn)
                else:
                    yield ("self", lock, lock, line, fn)
            scopes[-1].locks.append(m.group(1))
            held.append((m.group(1), lock))
        elif kind == "relock":
            var, what = payload.group(1), payload.group(2)
            if what == "unlock":
                held[:] = [h for h in held if h[0] != var]
            else:
                for s in reversed(scopes):
                    if var in s.locks:
                        cls = None
                        # re-lock of a known guard: recover its class from
                        # any earlier acquisition of the same var
                        for m2 in _ACQUIRE.finditer(stripped):
                            if m2.group(1) == var:
                                cls = normalize_mutex(m2.group(2))
                                break
                        if cls:
                            held.append((var, cls))
                        break
        elif kind in ("blocking", "locked_call"):
            name = payload.group(1)
            line = idx.line(off)
            fn = fn_stack[-1] if fn_stack else "?"
            if fn_stack:
                yield ("body_" + kind, fn, name, line)
            if held:
                held_classes = sorted({h[1] for h in held})
                yield (kind, name, line, fn, held_classes)


def _check_cc(root: str, violations: list[Violation]) -> None:
    for src in walk_files(root, (".cc",), subdir="ray_tpu_torch/native"):
        rel = src.rel
        edges: dict[tuple[str, str], list[tuple[int, str]]] = {}
        blocking: list[tuple[str, int, str, list[str]]] = []
        locked_calls: list[tuple[str, int, str, list[str]]] = []
        body_blocking: dict[str, tuple[str, int]] = {}
        body_calls: dict[str, set[str]] = {}
        for fact in _scan_cc_file(src.cc_code):
            if fact[0] == "edge":
                _, a, b, line, fn = fact
                edges.setdefault((a, b), []).append((line, fn))
            elif fact[0] == "self":
                _, a, _, line, fn = fact
                violations.append(Violation(
                    "locks/self-deadlock", rel, line,
                    f"{fn}: acquires {a} while already holding {a} "
                    "(std::mutex is not reentrant)"))
            elif fact[0] == "blocking":
                _, name, line, fn, held = fact
                blocking.append((name, line, fn, held))
            elif fact[0] == "locked_call":
                _, name, line, fn, held = fact
                locked_calls.append((name, line, fn, held))
            elif fact[0] == "body_blocking":
                _, fn, name, line = fact
                body_blocking.setdefault(fn, (name, line))
            elif fact[0] == "body_locked_call":
                _, fn, name, line = fact
                body_calls.setdefault(fn, set()).add(name)
        # Transitive closure: a *Locked helper that only calls another
        # *Locked helper that blocks (EvictOneLocked -> SpillLocked ->
        # open/write) still blocks its caller.
        changed = True
        while changed:
            changed = False
            for fn, callees in body_calls.items():
                if fn in body_blocking:
                    continue
                for callee in callees:
                    if callee in body_blocking:
                        inner, line = body_blocking[callee]
                        body_blocking[fn] = (f"{callee} -> {inner}", line)
                        changed = True
                        break
        # Pairwise inversions: both A->B and B->A observed.
        seen_pairs = set()
        for (a, b), sites in sorted(edges.items()):
            if (b, a) in edges and (b, a) not in seen_pairs:
                seen_pairs.add((a, b))
                line, fn = sites[0]
                rline, rfn = edges[(b, a)][0]
                violations.append(Violation(
                    "locks/order-inversion", rel, line,
                    f"lock order inversion: {fn} acquires {a} then {b} "
                    f"(line {line}) but {rfn} acquires {b} then {a} "
                    f"(line {rline})"))
        # Longer cycles (A->B->C->A) that pairwise checking misses.
        adj: dict[str, set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        for cyc in _cycles(adj):
            if len(cyc) <= 2:
                continue  # pairwise case above
            line, fn = edges[(cyc[0], cyc[1])][0]
            violations.append(Violation(
                "locks/order-cycle", rel, line,
                "lock-order cycle: " + " -> ".join(cyc + [cyc[0]])))
        for name, line, fn, held in blocking:
            violations.append(Violation(
                "locks/blocking-under-mutex", rel, line,
                f"{fn}: blocking call {name}() while holding "
                f"{', '.join(held)}"))
        for name, line, fn, held in locked_calls:
            if name in body_blocking:
                inner, _ = body_blocking[name]
                violations.append(Violation(
                    "locks/blocking-under-mutex", rel, line,
                    f"{fn}: calls {name}() (which does blocking {inner}()) "
                    f"while holding {', '.join(held)}"))


def _cycles(adj: dict[str, set[str]]) -> list[list[str]]:
    """Minimal cycle enumeration via DFS; good enough for graphs with a
    handful of lock classes."""
    cycles = []
    def dfs(start, node, path, visited):
        for nxt in sorted(adj.get(node, ())):
            if nxt == start and len(path) > 1:
                cycles.append(list(path))
            elif nxt not in visited and nxt > start:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)
    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return cycles


# ---------------------------------------------------------------------------
# Python side: blocking calls under a held threading lock.

_PY_LOCK_FILES = (
    "ray_tpu_torch/_private/scheduler.py",
    "ray_tpu_torch/_private/cluster_scheduler.py",
    "ray_tpu_torch/_private/node.py",
)
_LOCK_NAME = re.compile(r"(^|_)(lock|mu|mutex)$", re.I)
_SOCKET_METHODS = {"recv", "recv_into", "send", "sendall", "sendmsg",
                   "recvmsg", "accept", "connect"}
_REFISH = re.compile(r"(^|_)(ref|refs|fut|future|futures)($|_)", re.I)


def _ctx_name(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _recv_name(node: ast.expr) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class _PyLockVisitor(ast.NodeVisitor):
    def __init__(self, rel: str, violations: list[Violation]):
        self.rel = rel
        self.violations = violations
        self.lock_depth = 0
        self.lock_name = ""

    def visit_With(self, node: ast.With):
        lockish = [i for i in node.items
                   if (n := _ctx_name(i.context_expr)) and _LOCK_NAME.search(n)]
        if lockish:
            self.lock_depth += 1
            prev = self.lock_name
            self.lock_name = _ctx_name(lockish[0].context_expr) or "lock"
            for stmt in node.body:
                self.visit(stmt)
            self.lock_name = prev
            self.lock_depth -= 1
        else:
            self.generic_visit(node)

    # A nested def/lambda runs later, likely without the lock.
    def visit_FunctionDef(self, node: ast.FunctionDef):
        saved, self.lock_depth = self.lock_depth, 0
        self.generic_visit(node)
        self.lock_depth = saved

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call):
        if self.lock_depth:
            msg = self._blocking_reason(node)
            if msg:
                self.violations.append(Violation(
                    "locks/py-blocking-under-lock", self.rel, node.lineno,
                    f"{msg} while holding {self.lock_name}"))
        self.generic_visit(node)

    def _blocking_reason(self, node: ast.Call) -> str | None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if fn.attr == "sleep" and isinstance(base, ast.Name) \
                    and base.id == "time":
                return "time.sleep()"
            if fn.attr in ("run", "check_output", "check_call") \
                    and isinstance(base, ast.Name) \
                    and base.id == "subprocess":
                return f"subprocess.{fn.attr}()"
            if fn.attr in _SOCKET_METHODS:
                name = _recv_name(base)
                if "sock" in name.lower() or "conn" in name.lower():
                    return f"socket {name}.{fn.attr}()"
            if fn.attr in ("get", "result"):
                name = _recv_name(base)
                if _REFISH.search(name):
                    return f"{name}.{fn.attr}() (blocks on a remote result)"
        return None


def _check_py(root: str, violations: list[Violation]) -> None:
    for rel in _PY_LOCK_FILES:
        src = source(root, rel)
        if src is None:
            continue
        try:
            tree = src.tree
        except SyntaxError as e:
            violations.append(Violation(
                "locks/py-parse-error", rel, e.lineno or 1, str(e)))
            continue
        _PyLockVisitor(rel, violations).visit(tree)


def check(root: str) -> list[Violation]:
    violations: list[Violation] = []
    _check_cc(root, violations)
    _check_py(root, violations)
    return violations
