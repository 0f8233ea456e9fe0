"""Pass 6: wire-protocol reachability between ``wire_constants.py``,
the C++ daemons, and the Python clients.

Counterpart of ``ray_tpu/_private/staticcheck/protocheck.py`` over the
port's tree (``ray_tpu_torch/_private/wire_constants.py``, the port's
``native/`` daemons and its Python clients).

``drift`` (pass 1) pins the *values* of the shared constants; this pass
pins their *wiring*.  A constant can agree byte-for-byte on both sides
and still be dead or half-plumbed: an opcode with a daemon dispatch
case nobody sends, a status the daemon can produce that no client
handles, a chaos flag that claims to test a lane it never touches.
Every new opcode lands against these rules:

- ``proto/opcode-undispatched`` — every ``OP_*``/``XFER_*`` opcode in
  the anchor must have a dispatch site in a daemon (``case OP_X`` for
  request opcodes, a ``==``/``!=`` comparison for transfer-header
  kinds).  An undispatched opcode is a request the daemon drops on the
  floor.
- ``proto/opcode-uncalled`` — every opcode also needs at least one
  caller (a Python reference, or for XFER kinds a C++ send site).
  Dispatch without a caller is dead protocol surface — or a client
  that hardcodes the raw byte instead of the named constant.
- ``proto/status-unproduced`` / ``proto/status-unhandled`` — every
  ``ST_*`` status needs a C++ producer and a handler (a Python
  reference or a C++ comparison).  A status nobody produces is dead; a
  status nobody handles falls into clients' generic-error paths.
- ``proto/frame-unproduced`` / ``proto/frame-unhandled`` — every
  ``FRAME_*`` kind needs a Python producer and a consumer (a Python
  comparison, or a C++ comparison against the raw hex value — the C++
  core worker forwards frames and matches kinds numerically).
- ``proto/chaos-lane-off`` — a ``RTPU_TESTING_*`` chaos flag whose
  read site *disables a lane* (sets a ``*_failed``/``*_disabled``
  latch and returns None) instead of injecting failure INTO the lane.
  Such a flag silently un-tests the very path it names.
- ``proto/chaos-lane-unwired`` — each chaos flag must have at least
  one genuine injection read in a source file belonging to the lane
  its name claims (``RPC`` → protocol/direct/core_worker, ``STORE`` →
  the store daemon/clients, ``DATA`` → the data service).
- ``proto/chaos-no-event`` — each chaos flag's lane must put the
  injection on the cluster event plane: some genuine-read lane file
  must call ``events.emit("chaos...")``.  An injection that emits no
  event leaves kill-rung and chaos-test incidents unattributable on
  the ``rtpu events`` timeline (C++-side injections satisfy this via a
  Python-side observer of the injected effect, as the store lane does).

All inputs come from the tree under ``root``; checks whose inputs are
absent (no anchor, no ``.cc`` daemons, no Python clients) are skipped
so the pass self-tests on minimal fixture trees.
"""

from __future__ import annotations

import ast
import re

from ray_tpu_torch._private.staticcheck.common import (
    LineIndex,
    Violation,
    read_source,
    walk_files,
)
from ray_tpu_torch._private.staticcheck.drift import (
    _CC_CONSTEXPR,
    load_python_anchor,
    registered_flags,
)

_ANCHOR_REL = "ray_tpu_torch/_private/wire_constants.py"
_SELF_DIR = "ray_tpu_torch/_private/staticcheck/"
_FLAGS_REL = "ray_tpu_torch/_private/flags.py"

_NAME_PREFIXES = ("OP_", "XFER_", "ST_", "FRAME_")
_CHAOS = re.compile(r"RTPU_TESTING_[A-Z0-9_]+")
_CC_CHAOS = re.compile(r"\"(RTPU_TESTING_[A-Z0-9_]+)\"")

# Which source files count as "the lane" a chaos flag names.  Keys are
# the first token after RTPU_TESTING_; values are basename substrings.
_LANES = {
    "rpc": ("protocol", "direct", "core_worker", "wire", "gcs", "channel"),
    "store": ("store", "shm"),
    "data": ("data",),
}


def _is_proto_name(name: str) -> bool:
    return name.startswith(_NAME_PREFIXES)


def _anchor_names(root: str) -> dict[str, tuple[int, int]] | None:
    """name -> (value, decl line) for every integer protocol constant."""
    ns = load_python_anchor(root)
    if ns is None:
        return None
    src = read_source(root, _ANCHOR_REL) or ""
    idx = LineIndex(src)
    out: dict[str, tuple[int, int]] = {}
    for m in re.finditer(r"^((?:OP|XFER|ST|FRAME)_[A-Z0-9_]+)\s*=",
                         src, re.M):
        name = m.group(1)
        value = ns.get(name)
        if isinstance(value, int):
            out[name] = (value, idx.line(m.start()))
    return out or None


# ---------------------------------------------------------------------------
# C++ side: classify every occurrence of an anchor name.

class _CcRefs:
    def __init__(self):
        self.case: set[str] = set()      # `case NAME`
        self.compare: set[str] = set()   # adjacent ==/!=
        self.use: set[str] = set()       # any other non-declaration ref
        self.hex_compare: set[int] = set()  # values matched as ==/!= 0xNN
        self.chaos_reads: list[tuple[str, int, str]] = []  # rel, line, flag


def _scan_cc(root: str, names: dict[str, tuple[int, int]]) -> _CcRefs | None:
    refs = _CcRefs()
    found_any = False
    name_re = re.compile(
        r"\b(" + "|".join(re.escape(n) for n in names) + r")\b") \
        if names else None
    hex_res = {v: re.compile(rf"[=!]=\s*0[xX]0*{v:x}\b")
               for n, (v, _) in names.items() if n.startswith("FRAME_")}
    for src in walk_files(root, (".cc", ".h")):
        rel, raw = src.rel, src.text
        found_any = True
        idx = None
        for m in _CC_CHAOS.finditer(raw):
            idx = idx or LineIndex(raw)
            refs.chaos_reads.append((rel, idx.line(m.start()), m.group(1)))
        text = src.cc_code
        decl_spans = [(s.start(), s.end())
                      for s in _CC_CONSTEXPR.finditer(text)]
        if name_re is not None:
            for m in name_re.finditer(text):
                s = m.start()
                if any(a <= s < b for a, b in decl_spans):
                    continue
                name = m.group(1)
                before = text[max(0, s - 16):s]
                after = text[m.end():m.end() + 8]
                if re.search(r"\bcase\s+$", before):
                    refs.case.add(name)
                elif re.search(r"[=!]=\s*$", before) \
                        or re.match(r"\s*[=!]=", after):
                    refs.compare.add(name)
                else:
                    refs.use.add(name)
        for v, rx in hex_res.items():
            if rx.search(text):
                refs.hex_compare.add(v)
    return refs if found_any else None


# ---------------------------------------------------------------------------
# Python side: AST over every client module.

class _PyRefs:
    def __init__(self):
        self.compare: set[str] = set()   # referenced inside a comparison
        self.plain: set[str] = set()     # referenced anywhere else

    def add(self, src) -> None:
        """Every protocol name a module references, by whether the
        reference sits inside a comparison."""
        refs = [(n, n.id) for n in src.nodes(ast.Name)
                if _is_proto_name(n.id)]
        refs += [(n, n.attr) for n in src.nodes(ast.Attribute)
                 if _is_proto_name(n.attr)]
        if not refs:
            return
        inside = {id(sub) for cmp in src.nodes(ast.Compare)
                  for sub in ast.walk(cmp)}
        for node, name in refs:
            (self.compare if id(node) in inside else self.plain).add(name)


def _is_chaos_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and _CHAOS.fullmatch(node.value) is not None


def _const_strings(node: ast.AST):
    for sub in ast.walk(node):
        if _is_chaos_const(sub):
            yield sub


def _emits_chaos_event(calls: list) -> bool:
    """Does this module call ``emit("chaos...")`` /
    ``events.emit("chaos...")`` anywhere (``calls``: its Call nodes)?
    That call is what puts an injection on the cluster event plane
    (events_push → head bank)."""
    for node in calls:
        if not node.args:
            continue
        f = node.func
        label = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else "")
        if label != "emit":
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str) \
                and first.value.startswith("chaos"):
            return True
    return False


def _lane_off_shape(if_node: ast.If) -> bool:
    """Does this ``if <chaos flag>:`` body disable a lane (latch a
    ``*_failed``/``*_disabled`` flag, report, and return None) rather
    than inject a failure into it?"""
    returns_none = any(
        isinstance(n, ast.Return)
        and (n.value is None
             or (isinstance(n.value, ast.Constant) and n.value.value is None))
        for n in ast.walk(if_node))
    latches = False
    for n in ast.walk(if_node):
        if isinstance(n, ast.Assign) \
                and isinstance(n.value, ast.Constant) and n.value.value is True:
            for t in n.targets:
                label = t.id if isinstance(t, ast.Name) else (
                    t.attr if isinstance(t, ast.Attribute) else "")
                if "failed" in label or "disabled" in label:
                    latches = True
        if isinstance(n, ast.Call):
            f = n.func
            label = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else "")
            if "disabled" in label or "fallback" in label:
                latches = True
    return returns_none and latches


def check(root: str) -> list[Violation]:
    violations: list[Violation] = []
    names = _anchor_names(root)
    cc = _scan_cc(root, names or {})

    # Python scan (clients + chaos read sites).
    py_refs = _PyRefs()
    py_chaos: list[tuple[str, int, str]] = []        # rel, line, flag
    lane_off: list[tuple[str, int, str]] = []        # rel, line, flag
    chaos_emit_files: set[str] = set()               # rel with emit("chaos…")
    scanned_py = False
    for src in walk_files(root, (".py",)):
        rel = src.rel
        if rel == _ANCHOR_REL or rel.startswith(_SELF_DIR) \
                or rel == _FLAGS_REL:
            continue
        try:
            src.tree
        except SyntaxError as e:
            violations.append(Violation(
                "proto/parse-error", rel, e.lineno or 1, str(e)))
            continue
        scanned_py = True
        py_refs.add(src)
        chaos = [c for c in src.nodes(ast.Constant) if _is_chaos_const(c)]
        if not chaos:
            continue
        for node in src.nodes(ast.If):
            flags_in_test = {c.value for c in _const_strings(node.test)}
            if flags_in_test and _lane_off_shape(node):
                for flag in sorted(flags_in_test):
                    lane_off.append((rel, node.lineno, flag))
        for c in chaos:
            py_chaos.append((rel, c.lineno, c.value))
        if _emits_chaos_event(src.nodes(ast.Call)):
            chaos_emit_files.add(rel)
    py_any = py_refs.compare | py_refs.plain

    # -- opcode / status / frame wiring ------------------------------------
    anchor = _ANCHOR_REL
    for name, (value, line) in sorted((names or {}).items(),
                                      key=lambda kv: kv[1][1]):
        if name.startswith("OP_"):
            if cc is not None and name not in cc.case:
                violations.append(Violation(
                    "proto/opcode-undispatched", anchor, line,
                    f"{name} has no `case {name}:` in any daemon — "
                    "requests with this opcode are dropped on the floor"))
            if scanned_py and name not in py_any:
                violations.append(Violation(
                    "proto/opcode-uncalled", anchor, line,
                    f"{name} is never referenced by any Python client — "
                    "dead protocol surface (nothing can send it)"))
        elif name.startswith("XFER_"):
            if cc is not None and name not in cc.compare:
                violations.append(Violation(
                    "proto/opcode-undispatched", anchor, line,
                    f"{name} transfer kind is never matched "
                    "(==/!=) by any daemon header dispatch"))
            has_caller = (cc is not None and name in cc.use) \
                or name in py_any
            if (cc is not None or scanned_py) and not has_caller:
                violations.append(Violation(
                    "proto/opcode-uncalled", anchor, line,
                    f"{name} is dispatched but never sent by any peer "
                    "(no C++ send site, no Python reference)"))
        elif name.startswith("ST_"):
            if cc is not None and name not in cc.use:
                violations.append(Violation(
                    "proto/status-unproduced", anchor, line,
                    f"{name} is never produced by any daemon — a status "
                    "code no response can carry"))
            handled = name in py_any or (cc is not None and name in cc.compare)
            if scanned_py and not handled:
                violations.append(Violation(
                    "proto/status-unhandled", anchor, line,
                    f"{name} has no handler (no Python reference, no C++ "
                    "comparison) — it falls into generic-error paths"))
        elif name.startswith("FRAME_"):
            if scanned_py and name not in py_refs.plain:
                violations.append(Violation(
                    "proto/frame-unproduced", anchor, line,
                    f"{name} frame kind is never produced by any Python "
                    "peer"))
            handled = name in py_refs.compare \
                or (cc is not None and value in cc.hex_compare)
            if scanned_py and not handled:
                violations.append(Violation(
                    "proto/frame-unhandled", anchor, line,
                    f"{name} (0x{value:02x}) is never consumed: no Python "
                    "comparison and no C++ match on the raw kind byte"))

    # -- chaos reachability -------------------------------------------------
    for rel, line, flag in sorted(lane_off):
        violations.append(Violation(
            "proto/chaos-lane-off", rel, line,
            f"{flag} switches this lane OFF (latches a failed/disabled "
            "state and returns None) instead of injecting failure into "
            "it — the path it names runs with zero chaos coverage"))

    reads = py_chaos + (cc.chaos_reads if cc is not None else [])
    flags = {f for _, _, f in reads}
    flags |= {f for f in registered_flags(root) if _CHAOS.fullmatch(f)}
    off_sites = {(rel, flag) for rel, _, flag in lane_off}
    for flag in sorted(flags):
        if "_SEED" in flag:
            continue  # determinism knob for another flag, not a lane
        token = flag[len("RTPU_TESTING_"):].split("_")[0].lower()
        lane_names = _LANES.get(token, (token,))
        genuine = [
            (rel, line) for rel, line, f in reads
            if f == flag and (rel, flag) not in off_sites
            and any(part in rel.rsplit("/", 1)[-1].lower()
                    for part in lane_names)]
        if reads and not genuine:
            where = next(((rel, line) for rel, line, f in reads
                          if f == flag), (_FLAGS_REL, 1))
            violations.append(Violation(
                "proto/chaos-lane-unwired", where[0], where[1],
                f"{flag} claims to test the '{token}' lane but has no "
                f"injection read in any {'/'.join(lane_names)} source — "
                "it cannot reach the path it names"))
        elif genuine and not any(rel in chaos_emit_files
                                 for rel, _ in genuine):
            rel, line = min(genuine)
            violations.append(Violation(
                "proto/chaos-no-event", rel, line,
                f"{flag} injects failure but no genuine-read file in its "
                f"'{token}' lane calls emit(\"chaos…\") — injections never "
                "reach the cluster event plane, so chaos incidents are "
                "invisible on the rtpu events timeline"))
    return violations
