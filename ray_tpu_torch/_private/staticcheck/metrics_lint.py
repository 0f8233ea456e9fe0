"""Pass 4: Prometheus metrics / span naming discipline.

Counterpart of ``ray_tpu/_private/staticcheck/metrics_lint.py`` over the
port's tree.  Statically scans every ``Counter(...)`` / ``Gauge(...)`` /
``Histogram(...)`` construction in ``ray_tpu_torch/`` and the dashboard
renderer (``ray_tpu_torch/dashboard/``):

- family names are valid Prometheus identifiers (lowercase snake) and
  do not pre-bake the ``ray_tpu_`` prefix (the renderer applies it
  idempotently; double-prefixed source names mask collisions);
- every family carries a non-empty description: that string IS the
  ``# HELP`` line the dashboard emits;
- one family is registered at exactly one construction site (two sites
  with one name either double-count or fight over kind/help);
- every family the renderer hardcodes (``fam("…")``) carries the
  ``ray_tpu_`` prefix, and the renderer both emits ``# HELP``/``# TYPE``
  and applies the prefix to pushed families;
- SLO rules (any string literal in the tree parsing under
  ``_private/slo.py``'s grammar) reference only families that exist:
  ctor-registered, dict-literal-synthesized (``{"name": ..., "kind":
  ...}``), or the TSDB's runtime ``node_*`` / ``resource_*`` namespace;
- the reverse direction: a ctor-registered family whose name appears in
  no OTHER file of the port's own tree (``ray_tpu_torch/``, the port's
  tests ``tests/test_torch_*.py``, ``chip_smoke.py`` and the root ``.md``
  files, skipping any ``/staticcheck/`` path) is flagged as unconsumed.
  A mention in the JAX package (``ray_tpu/``) is not a use of a port
  family: the two trees are judged apart;
- every family listed in ``util/metrics.py``'s ``EXEMPLAR_FAMILIES`` is
  constructed as a ``Histogram``.

The port spells many family names as a prefix plus a suffix (so that the
JAX package's lint, which reads literal names across the checkout, keeps
seeing the JAX families as its own).  A name here is resolved from a
string literal, a module-level string constant, a class-level one read
as ``self.NAME``, a local alias of either, ``+`` between those, and the
rows of a module-level tuple table that a comprehension or ``for`` loop
unpacks (``for key, cls, suffix, help_ in _FAMILIES``): such a family is
reported at its row.  The constructor may then be a row's class too
(``cls(...)`` or ``getattr(M, cls)(...)``).
"""

from __future__ import annotations

import ast
import os
import re

from ray_tpu_torch._private.staticcheck.common import (
    PACKAGE,
    Violation,
    source,
    walk_files,
)

_METRIC_CTORS = {"Counter", "Gauge", "Histogram"}
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


class _Kind(str):
    """A metric class named by a table row (``Histogram``), as a value."""


def _literal_str(node: ast.expr | None) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstring_prefix(node: ast.expr) -> str | None:
    """First literal chunk of an f-string, or the whole literal."""
    lit = _literal_str(node)
    if lit is not None:
        return lit
    if isinstance(node, ast.JoinedStr) and node.values:
        return _literal_str(node.values[0])
    return None


def _row_value(node: ast.expr):
    """A table cell as a binding: a string, a metric class, or None."""
    lit = _literal_str(node)
    if lit is not None:
        return lit
    if isinstance(node, ast.Name) and node.id in _METRIC_CTORS:
        return _Kind(node.id)
    return None


def _span(node: ast.AST) -> tuple:
    return (node.lineno, node.col_offset, node.end_lineno,
            node.end_col_offset)


def _within(inner: tuple, outer: tuple) -> bool:
    return outer[:2] <= inner[:2] and inner[2:] <= outer[2:]


class _Resolver:
    """String values of one module's names: its module-level constants
    and tables, its classes' constants, and (set per call) the enclosing
    functions' locals, class and table loops."""

    def __init__(self, src):
        self.module: dict = {}
        self.tables: dict[str, list[ast.Tuple]] = {}
        self.classes: dict[str, dict] = {}
        self.scopes: list[dict] = []     # enclosing functions' locals
        self.cls: str | None = None      # the enclosing class
        for stmt in src.tree.body:
            self._assign(stmt, self.module)
        for node in src.nodes(ast.ClassDef):
            env = self.classes.setdefault(node.name, {})
            for stmt in node.body:
                self._assign(stmt, env)

    def _assign(self, stmt: ast.stmt, env: dict) -> None:
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        else:
            return
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if env is self.module and isinstance(value, (ast.Tuple,
                                                         ast.List)) \
                    and value.elts and all(isinstance(e, ast.Tuple)
                                           for e in value.elts):
                self.tables[t.id] = value.elts
                continue
            resolved = self.resolve(value, env)
            if resolved is None:
                env.pop(t.id, None)
            elif env.get(t.id, resolved) != resolved:
                env[t.id] = None  # two values: ambiguous
            else:
                env[t.id] = resolved

    def function_env(self, node: ast.AST) -> dict:
        """The string locals a function assigns (an alias like ``p =
        _FAMILY_PREFIX``)."""
        env: dict = {}
        for stmt in ast.walk(node):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                self._assign(stmt, env)
        return env

    def _lookup(self, name: str, env: dict | None):
        if env and name in env:
            return env[name]
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return self.module.get(name)

    def resolve(self, node: ast.expr | None, env: dict | None = None):
        """The string (or row class) ``node`` evaluates to, or None."""
        if node is None:
            return None
        if isinstance(node, ast.Constant):
            return node.value if isinstance(node.value, str) else None
        if isinstance(node, ast.Name):
            return self._lookup(node.id, env)
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name):
            owner = node.value.id
            if owner in ("self", "cls"):
                owner = self.cls
            value = self.classes.get(owner, {}).get(node.attr)
            return value if isinstance(value, str) else None
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self.resolve(node.left, env)
            right = self.resolve(node.right, env)
            if isinstance(left, str) and isinstance(right, str) \
                    and not isinstance(left, _Kind) \
                    and not isinstance(right, _Kind):
                return left + right
        return None

    def kind(self, func: ast.expr, env: dict | None) -> str | None:
        if isinstance(func, ast.Name):
            if func.id in _METRIC_CTORS:
                return func.id
            bound = self._lookup(func.id, env)
            return str(bound) if isinstance(bound, _Kind) else None
        if isinstance(func, ast.Attribute) and func.attr in _METRIC_CTORS:
            return func.attr
        if isinstance(func, ast.Call) and isinstance(func.func, ast.Name) \
                and func.func.id == "getattr" and len(func.args) == 2:
            name = self.resolve(func.args[1], env)
            return name if name in _METRIC_CTORS else None
        return None

    def rows(self, target: ast.expr, it: ast.expr) -> list[dict] | None:
        """One binding of ``target``'s names per row of the module table
        ``it`` names, or None where it names none."""
        if not (isinstance(it, ast.Name) and it.id in self.tables):
            return None
        if isinstance(target, ast.Name):
            names = [target.id]
        elif isinstance(target, ast.Tuple):
            names = [e.id if isinstance(e, ast.Name) else None
                     for e in target.elts]
        else:
            return None
        out = []
        for row in self.tables[it.id]:
            if len(row.elts) != len(names):
                continue
            binding = {n: _row_value(e) for n, e in zip(names, row.elts)
                       if n is not None}
            binding["<line>"] = row.lineno
            out.append(binding)
        return out


def _table_loops(src, resolver: _Resolver) -> list[tuple]:
    """(span of the looped body, rows) of every comprehension or ``for``
    loop over a module table."""
    loops = []
    for kind in (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp):
        for node in src.nodes(kind):
            body = ([node.key, node.value] if kind is ast.DictComp
                    else [node.elt])
            for gen in node.generators:
                rows = resolver.rows(gen.target, gen.iter)
                if rows is not None:
                    loops.extend(((_span(b), rows) for b in body))
    for node in src.nodes(ast.For):
        rows = resolver.rows(node.target, node.iter)
        if rows is not None and node.body:
            first, last = _span(node.body[0]), _span(node.body[-1])
            loops.append((first[:2] + last[2:], rows))
    return loops


def _bound_names(loops: list[tuple]) -> set[str]:
    return {name for _, rows in loops for row in rows for name in row}


def registrations(src) -> list[tuple]:
    """(kind, name, description, line) of every metric construction in
    one cached module, names resolved as the module docstring says."""
    if not any(ctor in src.text for ctor in _METRIC_CTORS):
        return []  # no constructor can be named without its class's name
    resolver = _Resolver(src)
    loops = _table_loops(src, resolver)
    bound = _bound_names(loops)

    def maybe_ctor(func: ast.expr) -> bool:
        if isinstance(func, ast.Name):
            return func.id in _METRIC_CTORS or func.id in bound
        if isinstance(func, ast.Attribute):
            return func.attr in _METRIC_CTORS
        return isinstance(func, ast.Call) and isinstance(
            func.func, ast.Name) and func.func.id == "getattr"

    calls = [c for c in src.nodes(ast.Call)
             if c.args and maybe_ctor(c.func)]
    if not calls:
        return []
    funcs = [f for kind in (ast.FunctionDef, ast.AsyncFunctionDef)
             for f in src.nodes(kind)]
    classes = src.nodes(ast.ClassDef)
    envs: dict[int, dict] = {}
    found = []
    for call in sorted(calls, key=_span):
        where = _span(call)
        owners = [c for c in classes if _within(where, _span(c))]
        resolver.cls = max(owners, key=_span).name if owners else None
        scopes = []  # the enclosing functions' locals, outermost first
        for f in sorted((f for f in funcs if _within(where, _span(f))),
                        key=_span):
            if id(f) not in envs:
                resolver.scopes = list(scopes)
                envs[id(f)] = resolver.function_env(f)
            scopes.append(envs[id(f)])
        resolver.scopes = scopes
        combos = [{}]
        for body, rows in loops:
            if _within(where, body):
                combos = [{**c, **r} for c in combos for r in rows]
        for env in combos:
            kind = resolver.kind(call.func, env)
            if kind is None:
                continue
            name = resolver.resolve(call.args[0], env)
            if not isinstance(name, str) or isinstance(name, _Kind):
                continue  # dynamic name: out of static reach
            desc_node = call.args[1] if len(call.args) > 1 else next(
                (k.value for k in call.keywords if k.arg == "description"),
                None)
            desc = resolver.resolve(desc_node, env)
            found.append((kind, name,
                          desc if isinstance(desc, str) else None,
                          env.get("<line>", call.lineno)))
    return found


def _py_files(root: str):
    for src in walk_files(root, (".py",)):
        if "/staticcheck/" in src.rel:
            continue
        try:
            src.tree
        except SyntaxError:
            continue
        yield src


def _scan_registrations(root: str, violations: list[Violation]):
    sites: dict[str, list[tuple[str, int, str]]] = {}
    for src in _py_files(root):
        rel = src.rel
        if rel.endswith("util/metrics.py"):
            continue  # the class definitions
        for kind, name, desc, line in registrations(src):
            if not _NAME_RE.match(name):
                violations.append(Violation(
                    "metrics/invalid-name", rel, line,
                    f"{kind} family {name!r} is not a lowercase snake_case "
                    "Prometheus name"))
            if name.startswith("ray_tpu_"):
                violations.append(Violation(
                    "metrics/prebaked-prefix", rel, line,
                    f"{kind} family {name!r} hardcodes the ray_tpu_ prefix; "
                    "register the bare name — the dashboard renderer "
                    "prefixes every pushed family"))
            if not (desc or "").strip():
                violations.append(Violation(
                    "metrics/missing-help", rel, line,
                    f"{kind} family {name!r} has no description (its # HELP "
                    "line would be empty)"))
            sites.setdefault(name, []).append((rel, line, kind))
    for name, where in sorted(sites.items()):
        if len(where) > 1:
            locs = ", ".join(f"{r}:{ln}" for r, ln, _ in where)
            rel, line, _ = where[0]
            violations.append(Violation(
                "metrics/duplicate-family", rel, line,
                f"family {name!r} is constructed at {len(where)} sites "
                f"({locs}); register it once and share the instance"))
    return sites


def _scan_synthesized(root: str) -> set[str]:
    """Families synthesized as push-shaped dict literals ({"name": N,
    "kind": K, ...}: slo.py's status_metrics) rather than constructed:
    real on the wire, so rules may reference them."""
    names: set[str] = set()
    for src in _py_files(root):
        for node in src.nodes(ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if "name" not in keys or "kind" not in keys:
                continue
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "name"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    names.add(v.value)
    return names


def _scan_slo_rules(root: str, registered: set[str],
                    violations: list[Violation]):
    """Every family referenced by an SLO rule (any string literal that
    parses under the rule grammar) must exist: ctor-registered,
    synthesized, or the TSDB's runtime ``node_*`` / ``resource_*``
    namespace.  Returns the rule-consumed families."""
    from ray_tpu_torch._private import slo as slo_mod

    consumed: set[str] = set()
    for src in _py_files(root):
        for node in src.nodes(ast.Constant):
            text = node.value
            if not isinstance(text, str) or ":" not in text \
                    or ("<" not in text and ">" not in text):
                continue  # every rule is "name: expr <op> number"
            for part in re.split(r"[;\n]", node.value):
                m = slo_mod._RULE_RE.match(part.strip())
                if not m:
                    continue
                try:
                    rule = slo_mod.Rule(part)
                except slo_mod.RuleError:
                    continue
                for fam in rule.families():
                    consumed.add(fam)
                    if fam in registered or fam.startswith("node_") \
                            or fam.startswith("resource_"):
                        continue
                    violations.append(Violation(
                        "metrics/slo-unknown-family", src.rel, node.lineno,
                        f"SLO rule {rule.name!r} references family "
                        f"{fam!r}, which no Counter/Gauge/Histogram "
                        "registers and no push path synthesizes — the "
                        "rule can never fire"))
    return consumed


def consumer_files(root: str):
    """The files whose mentions count as uses of a port family: the
    port's package, its tests, ``chip_smoke.py`` and the root docs."""
    files = walk_files(root, (".py", ".md"))
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        for f in sorted(os.listdir(tests)):
            if f.startswith("test_torch_") and f.endswith(".py"):
                files.append(source(root, f"tests/{f}"))
    for f in sorted(os.listdir(root)):
        if f == "chip_smoke.py" or f.endswith(".md"):
            src = source(root, f)
            if src is not None:
                files.append(src)
    return [s for s in files if s is not None and "/staticcheck/" not in s.rel]


def _scan_unconsumed(root: str, sites: dict, violations: list[Violation]):
    """A ctor-registered family nobody mentions anywhere else in the
    port's tree (not a rule, dashboard, CLI, test, or doc) is write-only
    telemetry."""
    mentions: dict[str, set[str]] = {name: set() for name in sites}
    for src in consumer_files(root):
        for name in mentions:
            if name in src.text:
                mentions[name].add(src.rel)
    for name, where in sorted(sites.items()):
        rel, line, _ = where[0]
        others = mentions[name] - {rel}
        if not others:
            violations.append(Violation(
                "metrics/family-unconsumed", rel, line,
                f"family {name!r} is registered here but consumed "
                "nowhere — no SLO rule, dashboard, CLI, test, or doc "
                "mentions it"))


def _scan_exemplars(root: str, sites: dict, violations: list[Violation]):
    """Every family in util/metrics.py's EXEMPLAR_FAMILIES tuple must be
    constructed as a Histogram somewhere in the tree: exemplar trace ids
    are banked per bucket."""
    src = source(root, f"{PACKAGE}/util/metrics.py")
    if src is None:
        return
    try:
        resolver = _Resolver(src)
    except SyntaxError:
        return
    rel = src.rel
    for node in src.nodes(ast.Assign):
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "EXEMPLAR_FAMILIES" not in targets:
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            continue
        for elt in node.value.elts:
            fam = resolver.resolve(elt)
            if not isinstance(fam, str):
                continue
            where = sites.get(fam)
            if not where:
                violations.append(Violation(
                    "metrics/exemplar-not-histogram", rel, elt.lineno,
                    f"EXEMPLAR_FAMILIES lists {fam!r}, but no "
                    "Counter/Gauge/Histogram registers it — an "
                    "exemplar-capable family must be a registered "
                    "Histogram"))
                continue
            bad = [(r, ln, k) for r, ln, k in where if k != "Histogram"]
            if bad:
                locs = ", ".join(f"{r}:{ln} ({k})" for r, ln, k in bad)
                violations.append(Violation(
                    "metrics/exemplar-not-histogram", rel, elt.lineno,
                    f"EXEMPLAR_FAMILIES lists {fam!r}, but it is "
                    f"constructed as a non-histogram at {locs} — "
                    "exemplars hang off histogram buckets"))


def _scan_renderer(root: str, violations: list[Violation]):
    rendered_any = False
    for src in walk_files(root, (".py",), subdir=f"{PACKAGE}/dashboard"):
        rel, text = src.rel, src.text
        try:
            src.tree
        except SyntaxError:
            continue
        if "_render_prometheus" in text:
            rendered_any = True
            if "# HELP" not in text or "# TYPE" not in text:
                violations.append(Violation(
                    "metrics/renderer-missing-help-type", rel, 1,
                    "_render_prometheus does not emit # HELP/# TYPE "
                    "headers"))
            if 'startswith("ray_tpu_")' not in text:
                violations.append(Violation(
                    "metrics/renderer-prefix-missing", rel, 1,
                    "_render_prometheus does not apply the ray_tpu_ prefix "
                    "to pushed families"))
        for node in src.nodes(ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id == "fam" \
                    and node.args:
                prefix = _fstring_prefix(node.args[0])
                if prefix is not None and not prefix.startswith("ray_tpu_"):
                    violations.append(Violation(
                        "metrics/unprefixed-family", rel, node.lineno,
                        f"renderer emits family starting {prefix!r} without "
                        "the ray_tpu_ prefix"))
    return rendered_any


def families(root: str) -> set[str]:
    """Every family name the port's constructions register."""
    return set(_scan_registrations(root, []))


def check(root: str) -> list[Violation]:
    violations: list[Violation] = []
    sites = _scan_registrations(root, violations)
    _scan_renderer(root, violations)
    registered = set(sites) | _scan_synthesized(root)
    _scan_slo_rules(root, registered, violations)
    _scan_unconsumed(root, sites, violations)
    _scan_exemplars(root, sites, violations)
    return violations
