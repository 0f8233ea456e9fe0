"""Pass 3: hot-path purity over ``train/``, ``parallel/`` and ``llm/``.

Counterpart of ``ray_tpu/_private/staticcheck/purity.py``.  JAX's pass
looks inside ``jax.jit``-ed functions; the port's counterpart of traced
code is *captured* code, which replays without running its Python:

- a function decorated with, or passed by name to, ``torch.compile``,
  ``torch.jit.script``, ``torch.jit.trace`` or
  ``torch.cuda.make_graphed_callables`` (also as ``functools.partial(...)``
  or a called decorator such as ``torch.compile(mode=...)``);
- the body of a ``with torch.cuda.graph(...)`` block.

Two rule families, with JAX's rule ids so that allowlist patterns and
``--json`` readers see the same names:

- Inside captured code nothing may read the wall clock
  (``purity/wallclock-in-jit``: the capture bakes one reading into every
  replay) or host RNG state (``purity/rng-in-jit``), and nothing may force
  a host sync (``purity/host-sync-in-jit``): a sync breaks a compiled
  graph and is illegal while a CUDA graph captures.

- Outside captured code, host syncs on the hot path must sit inside a
  GoodputTracker bracket (``with gp.step() as st`` / ``with
  st.phase(...)`` / ``with gp.compile_bracket()``), so the stall is
  attributed to a step phase instead of vanishing into untimed wall
  clock (``purity/host-sync-unbracketed``).  Host-side code with a reason
  to sync (e.g. sampling on the host) is allowlisted per file.

A host sync is ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` with
no arguments, ``np.asarray``, ``torch.cuda.synchronize()``, or a
``.synchronize()`` on an event or a stream.
"""

from __future__ import annotations

import ast

from ray_tpu_torch._private.staticcheck.common import Violation, walk_files

_HOT_SUBDIRS = ("ray_tpu_torch/train", "ray_tpu_torch/parallel",
                "ray_tpu_torch/llm")

_WALLCLOCK = {"time", "perf_counter", "monotonic", "time_ns",
              "perf_counter_ns", "monotonic_ns"}
_HOST_RNG = {"random", "randint", "randrange", "choice", "shuffle",
             "uniform", "sample", "normal", "default_rng", "urandom",
             "uuid4", "getrandbits"}
_RNG_MODULES = {"random", "os", "uuid"}
_BRACKET_ATTRS = {"step", "phase", "compile_bracket"}
# dotted suffixes of the calls that capture a function
_CAPTURE = ("torch.compile", "jit.script", "jit.trace",
            "make_graphed_callables")
_TENSOR_SYNCS = {"item", "tolist", "cpu", "numpy"}


def _dotted(node: ast.expr) -> str:
    """'np.random.default_rng' for nested attributes, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _numpy_aliases(src) -> set[str]:
    return {a.asname or "numpy" for node in src.nodes(ast.Import)
            for a in node.names if a.name == "numpy"}


def _is_capture(node: ast.expr) -> bool:
    """``torch.compile`` and its kin, bare, called with options, or
    wrapped in ``partial``."""
    d = _dotted(node)
    if d and any(d == c or d.endswith("." + c) for c in _CAPTURE):
        return True
    if isinstance(node, ast.Call):
        return _is_capture(node.func) or any(_is_capture(a)
                                             for a in node.args)
    return False


def _is_graph_capture(node: ast.expr) -> bool:
    """``with torch.cuda.graph(g):``."""
    return isinstance(node, ast.Call) and (
        _dotted(node.func) == "graph"
        or _dotted(node.func).endswith("cuda.graph"))


def captured_names(src) -> set[str]:
    """Function names that end up captured in one cached module:
    decorated with a capture or passed by name (alone or in a tuple) to a
    capture call anywhere in it."""
    names = {node.name
             for kind in (ast.FunctionDef, ast.AsyncFunctionDef)
             for node in src.nodes(kind)
             if any(_is_capture(d) for d in node.decorator_list)}
    for node in src.nodes(ast.Call):
        if node.args and _is_capture(node.func):
            first = node.args[0]
            elts = first.elts if isinstance(first, ast.Tuple) else [first]
            names.update(e.id for e in elts if isinstance(e, ast.Name))
    return names


class _PurityVisitor(ast.NodeVisitor):
    def __init__(self, rel: str, captured: set[str], np_aliases: set[str],
                 violations: list[Violation]):
        self.rel = rel
        self.captured = captured
        self.np = np_aliases
        self.violations = violations
        self.capture_depth = 0
        self.bracket_depth = 0

    def visit_FunctionDef(self, node: ast.FunctionDef):
        entered = node.name in self.captured
        if entered:
            self.capture_depth += 1
        self.generic_visit(node)
        if entered:
            self.capture_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_With(self, node: ast.With):
        exprs = [i.context_expr for i in node.items]
        bracket = any(isinstance(e, ast.Call)
                      and isinstance(e.func, ast.Attribute)
                      and e.func.attr in _BRACKET_ATTRS for e in exprs)
        graph = any(_is_graph_capture(e) for e in exprs)
        for item in node.items:
            self.visit(item)
        self.bracket_depth += bracket
        self.capture_depth += graph
        for stmt in node.body:
            self.visit(stmt)
        self.capture_depth -= graph
        self.bracket_depth -= bracket

    def _sync(self, node: ast.Call, dotted: str, head: str,
              tail: str) -> str | None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and not node.args \
                and not node.keywords and fn.attr in _TENSOR_SYNCS:
            return f".{fn.attr}()"
        if head in self.np and tail == "asarray":
            return f"{dotted}()"
        if isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
            return f"{dotted or 'synchronize'}()" \
                if dotted.startswith("torch.") else ".synchronize()"
        return None

    def visit_Call(self, node: ast.Call):
        dotted = _dotted(node.func)
        head = dotted.split(".")[0] if dotted else ""
        tail = dotted.split(".")[-1] if dotted else ""
        captured = self.capture_depth > 0

        if captured:
            if head == "time" and tail in _WALLCLOCK:
                self._emit("purity/wallclock-in-jit", node,
                           f"{dotted}() inside captured code (the capture "
                           "bakes one reading into every replay)")
            elif tail in _HOST_RNG and (
                    (head in self.np and ".random." in f".{dotted}.")
                    or head in _RNG_MODULES):
                self._emit("purity/rng-in-jit", node,
                           f"{dotted}() inside captured code (host RNG "
                           "replays one draw; draw from a torch.Generator "
                           "instead)")

        sync = self._sync(node, dotted, head, tail)
        if sync:
            if captured:
                self._emit("purity/host-sync-in-jit", node,
                           f"{sync} inside captured code (a sync breaks "
                           "the compiled graph and is illegal during CUDA "
                           "graph capture)")
            elif not self.bracket_depth:
                self._emit("purity/host-sync-unbracketed", node,
                           f"{sync} outside a GoodputTracker step/phase "
                           "bracket (stall is unattributed)")
        self.generic_visit(node)

    def _emit(self, rule: str, node: ast.AST, msg: str):
        self.violations.append(
            Violation(rule, self.rel, getattr(node, "lineno", 1), msg))


def check(root: str) -> list[Violation]:
    violations: list[Violation] = []
    for sub in _HOT_SUBDIRS:
        for src in walk_files(root, (".py",), subdir=sub):
            try:
                tree = src.tree
            except SyntaxError as e:
                violations.append(Violation(
                    "purity/parse-error", src.rel, e.lineno or 1, str(e)))
                continue
            visitor = _PurityVisitor(src.rel, captured_names(src),
                                     _numpy_aliases(src), violations)
            visitor.visit(tree)
    return violations
