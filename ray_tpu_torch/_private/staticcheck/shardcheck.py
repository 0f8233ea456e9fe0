"""Pass 5: sharding-layout consistency over ``parallel/``, ``train/``,
``llm/``, ``models/`` and ``ops/``.

Counterpart of ``ray_tpu/_private/staticcheck/shardcheck.py`` over the
port's tree.  One model definition serves every parallelism layout via
logical-axis rules (``parallel/sharding.py``): model code names *logical*
axes ("embed", "heads", …) in ``param_logical_specs``, a rules table maps
them to *mesh* axes ("fsdp", "tp", …), and the port turns them into
DTensor placements and the collectives of ``LocalShards`` and
``parallel/collectives.py``.  The port has no ``PartitionSpec`` literal
and no ``shard_map``: it names mesh axes directly in rules-table values,
in ``*_axis=`` parameter defaults, and as the string axis arguments of
its mesh and group lookups (``_AXIS_LOOKUPS``: ``mesh.get_group("sp")``,
``mesh.get_local_rank("sp")``, ``mesh_axis_size(mesh, "sp")``,
``_axis_size(mesh, "tp")``).  A typo there is a KeyError, or a silent
size-1 axis, found only when a run on a mesh reaches it.  Rules, by AST:

- ``shard/unknown-mesh-axis`` — every mesh axis named at one of those
  sites must exist in ``parallel/mesh.py``'s ``AXIS_ORDER``.
- ``shard/dead-logical-axis`` — a rules-table entry whose logical axis
  is never used by any logical spec in the tree is a stale knob (or a
  typo shadowing the spelling models actually use).
- ``shard/unknown-logical-axis`` — a logical axis used by a model spec
  but absent from every rules table (``to_partition_spec`` raises on it).
- ``shard/uncovered-param`` — a parameter spec that maps to FULLY
  replicated while at least one of its axes is unknown to the rules.
- ``shard/dcn-non-batch`` — ``dcn`` is the outermost mesh axis, across
  hosts: only batch-class logical axes may map onto it, and no lookup
  or default may name it directly.
- ``shard/comm-axis-unmodeled`` — every mesh axis the rules emit
  collectives on must be modeled by ``parallel/comm.py``'s estimator
  (``_COLLECTIVE_AXES``).

Logical specs are ``logical_spec(...)`` (or its alias, ``L(...)``) calls
and ``to_partition_spec((...), ...)`` tuple literals.  All inputs are
discovered from the tree under ``root``; a check whose anchor file is
absent is skipped, so the pass self-tests on minimal fixtures.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from ray_tpu_torch._private.staticcheck.common import (
    Violation,
    source,
    walk_files,
)

_SPEC_DIRS = ("ray_tpu_torch/parallel", "ray_tpu_torch/train",
              "ray_tpu_torch/llm", "ray_tpu_torch/models", "ray_tpu_torch/ops")

_AXIS_ORDER_REL = "ray_tpu_torch/parallel/mesh.py"
_COMM_REL = "ray_tpu_torch/parallel/comm.py"

# Spec-entry spellings that mean "replicated on purpose".
_REPLICATED = (None, "replicated")

# Mesh and group lookups that take mesh-axis names: call name -> index of
# the first axis argument (every later positional string is one too).
_AXIS_LOOKUPS = {"get_group": 0, "get_local_rank": 0, "mesh_axis_size": 1,
                 "_axis_size": 1}


def _dotted(node: ast.expr) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _const_tuple(root: str, module: str, name: str) -> tuple | None:
    """A module-level ``NAME = ("a", "b", ...)`` tuple of strings, by AST."""
    src = source(root, module)
    if src is None:
        return None
    try:
        tree = src.tree
    except SyntaxError:
        return None
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name \
                    and isinstance(node.value, ast.Tuple):
                elts = node.value.elts
                if all(isinstance(e, ast.Constant)
                       and isinstance(e.value, str) for e in elts):
                    return tuple(e.value for e in elts)
    return None


@dataclass
class _RuleEntry:
    """One ``logical: mesh-axes`` entry of a rules table."""

    table: str
    rel: str
    line: int
    logical: str
    axes: tuple[str, ...]  # () = explicit replication (None value)
    explicit_none: bool


@dataclass
class _SpecUse:
    """One logical spec literal (``L(...)`` / ``to_partition_spec(...)``)."""

    rel: str
    line: int
    names: tuple  # str | None entries


class _FileScan(ast.NodeVisitor):
    """Collect rules tables, spec literals, mesh-axis lookups and
    ``*_axis=`` defaults from one source file."""

    def __init__(self, rel: str):
        self.rel = rel
        self.rules: list[_RuleEntry] = []
        self.specs: list[_SpecUse] = []
        # mesh-axis names from lookups / axis params
        self.mesh_axes: list[tuple[int, str, str]] = []  # line, axis, where
        self.logical_aliases = {"logical_spec"}

    # -- imports: track spelling of logical_spec -----------------------------
    def visit_ImportFrom(self, node: ast.ImportFrom):
        for a in node.names:
            if a.name == "logical_spec":
                self.logical_aliases.add(a.asname or a.name)
        self.generic_visit(node)

    # -- rules tables: {NAME}*RULES* = {"logical": "axis" | (..) | None} ----
    def _maybe_rules(self, target: ast.expr, value: ast.expr):
        if not (isinstance(target, ast.Name) and "RULES" in target.id.upper()
                and isinstance(value, ast.Dict)):
            return
        for k, v in zip(value.keys, value.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                continue
            axes: tuple[str, ...] = ()
            explicit_none = False
            if isinstance(v, ast.Constant):
                if v.value is None:
                    explicit_none = True
                elif isinstance(v.value, str):
                    axes = (v.value,)
            elif isinstance(v, ast.Tuple):
                axes = tuple(e.value for e in v.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str))
            self.rules.append(_RuleEntry(
                table=target.id, rel=self.rel, line=k.lineno,
                logical=k.value, axes=axes, explicit_none=explicit_none))

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._maybe_rules(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._maybe_rules(node.target, node.value)
        self.generic_visit(node)

    # -- *_axis="name" parameter defaults -----------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef):
        args = node.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                args.defaults):
            self._axis_default(arg, default)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            self._axis_default(arg, default)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _axis_default(self, arg: ast.arg, default):
        if default is not None and arg.arg.endswith("_axis") \
                and isinstance(default, ast.Constant) \
                and isinstance(default.value, str):
            self.mesh_axes.append(
                (default.lineno, default.value,
                 f"default of parameter {arg.arg!r}"))

    # -- calls: lookups, logical_spec(...), to_partition_spec((...)) --------
    def visit_Call(self, node: ast.Call):
        dotted = _dotted(node.func)
        tail = dotted.split(".")[-1] if dotted else ""
        if tail in _AXIS_LOOKUPS:
            for arg in node.args[_AXIS_LOOKUPS[tail]:]:
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    self.mesh_axes.append(
                        (arg.lineno, arg.value, f"argument of {tail}()"))
        elif tail in self.logical_aliases:
            if all(isinstance(a, ast.Constant) for a in node.args):
                self.specs.append(_SpecUse(
                    self.rel, node.lineno,
                    tuple(a.value for a in node.args)))
        elif tail == "to_partition_spec" and node.args:
            first = node.args[0]
            if isinstance(first, ast.Tuple) and all(
                    isinstance(e, ast.Constant) for e in first.elts):
                self.specs.append(_SpecUse(
                    self.rel, node.lineno,
                    tuple(e.value for e in first.elts)))
        self.generic_visit(node)


def check(root: str) -> list[Violation]:
    violations: list[Violation] = []
    axis_order = _const_tuple(root, _AXIS_ORDER_REL, "AXIS_ORDER")
    modeled = _const_tuple(root, _COMM_REL, "_COLLECTIVE_AXES")

    rules: list[_RuleEntry] = []
    specs: list[_SpecUse] = []
    mesh_axes: list[tuple[str, int, str, str]] = []  # rel, line, axis, where
    for sub in _SPEC_DIRS:
        for src in walk_files(root, (".py",), subdir=sub):
            rel = src.rel
            try:
                tree = src.tree
            except SyntaxError as e:
                violations.append(Violation(
                    "shard/parse-error", rel, e.lineno or 1, str(e)))
                continue
            scan = _FileScan(rel)
            scan.visit(tree)
            rules.extend(scan.rules)
            specs.extend(scan.specs)
            mesh_axes.extend((rel, ln, ax, where)
                             for ln, ax, where in scan.mesh_axes)

    # 1. every mesh axis named anywhere must exist in AXIS_ORDER ------------
    if axis_order:
        for entry in rules:
            for ax in entry.axes:
                if ax not in axis_order:
                    violations.append(Violation(
                        "shard/unknown-mesh-axis", entry.rel, entry.line,
                        f"rule {entry.logical!r} in {entry.table} maps to "
                        f"mesh axis {ax!r}, not in mesh.AXIS_ORDER "
                        f"{axis_order}"))
        for rel, line, ax, where in mesh_axes:
            if ax not in axis_order:
                violations.append(Violation(
                    "shard/unknown-mesh-axis", rel, line,
                    f"mesh axis {ax!r} ({where}) not in mesh.AXIS_ORDER "
                    f"{axis_order}"))

    # 2. dcn carries batch-class axes only (mesh.py outermost invariant) ----
    for entry in rules:
        if "dcn" in entry.axes and not entry.logical.startswith("batch"):
            violations.append(Violation(
                "shard/dcn-non-batch", entry.rel, entry.line,
                f"rule {entry.logical!r} maps onto 'dcn': only batch-class "
                "axes may cross hosts (every other collective must stay "
                "on the host's NVLink)"))
    for rel, line, ax, where in mesh_axes:
        if ax == "dcn":
            violations.append(Violation(
                "shard/dcn-non-batch", rel, line,
                f"'dcn' named directly in a {where}: cross-host layout "
                "belongs in the rules table (batch-class axes only), not "
                "hardcoded lookups"))

    # 3. rules vs logical specs, both directions ----------------------------
    rule_keys = {e.logical for e in rules}
    used = {n for s in specs for n in s.names
            if isinstance(n, str) and n not in _REPLICATED}
    if rules and specs:
        for entry in rules:
            if entry.logical not in used:
                violations.append(Violation(
                    "shard/dead-logical-axis", entry.rel, entry.line,
                    f"rule {entry.logical!r} in {entry.table} is never "
                    "used by any logical spec in the tree (stale knob, or "
                    "a typo shadowing the spelling models use)"))
        for spec in specs:
            unknown = [n for n in spec.names
                       if isinstance(n, str) and n not in _REPLICATED
                       and n not in rule_keys]
            for n in unknown:
                violations.append(Violation(
                    "shard/unknown-logical-axis", spec.rel, spec.line,
                    f"logical axis {n!r} is not covered by any sharding "
                    "rules table; to_partition_spec raises on it (use "
                    "None/'replicated' for intentional replication)"))
            # fully-replicated by accident: every entry replicates, and at
            # least one does so because its name is unknown to the rules.
            explicit_none = {e.logical for e in rules if e.explicit_none
                             or not e.axes}
            all_replicated = all(
                n in _REPLICATED or n in explicit_none or n not in rule_keys
                for n in spec.names)
            if spec.names and unknown and all_replicated:
                violations.append(Violation(
                    "shard/uncovered-param", spec.rel, spec.line,
                    f"spec {spec.names} maps to FULLY replicated while "
                    f"axis {unknown[0]!r} is unknown to the rules — "
                    "silent replication, not a decision; add a rule or "
                    "spell the axis None/'replicated'"))

    # 4. every mesh axis the rules emit collectives on is modeled by the
    #    comm estimator (so `rtpu comm` can't drift as strategies grow).
    if modeled is not None and rules:
        seen: set[str] = set()
        for entry in rules:
            for ax in entry.axes:
                if ax in seen or ax in modeled:
                    continue
                if axis_order and ax not in axis_order:
                    continue  # already reported as unknown-mesh-axis
                seen.add(ax)
                violations.append(Violation(
                    "shard/comm-axis-unmodeled", entry.rel, entry.line,
                    f"rules emit collectives on mesh axis {ax!r} (rule "
                    f"{entry.logical!r}) but comm.estimate_train_comm "
                    f"models only {modeled}; extend the estimator or "
                    "document the exception"))
    return violations
