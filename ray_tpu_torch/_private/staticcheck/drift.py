"""Pass 1: cross-language drift between the C++ daemons and their
Python peers, plus the env-flag registry lint (both directions).

Counterpart of ``ray_tpu/_private/staticcheck/drift.py`` over the port's
tree: the anchors are ``ray_tpu_torch/_private/wire_constants.py`` and
``_private/flags.py``, the daemons ``ray_tpu_torch/native/``'s
``shm_store.cc``, ``wire.h``, ``core_worker.cc``, ``gcs_server.cc`` and
``mutable_channel.cc``.

The Python anchor for every protocol is ``_private/wire_constants.py``
(one module, evaluated in isolation — it is stdlib-only by contract).
The C++ side is extracted with regexes over ``constexpr`` declarations,
including multi-declarator statements and value expressions built from
earlier constants (``1 + kIdLen + 8 + 8``, ``1u << 28``, ``0x...ULL``).
A renumbered opcode, a resized frame header, or a version bump on one
side only is a violation pointing at the C++ declaration line.
"""

from __future__ import annotations

import os
import re
import struct

from ray_tpu_torch._private.staticcheck.common import (
    LineIndex,
    Violation,
    read_source,
    walk_files,
)

# One constexpr statement, possibly declaring several NAME = VALUE pairs.
_CC_CONSTEXPR = re.compile(
    r"\bconstexpr\s+(?:uint8_t|uint16_t|uint32_t|uint64_t|int8_t|int16_t"
    r"|int32_t|int64_t|size_t|int|unsigned|long|char)\s+([^;]+);",
    re.S)
_CC_DECL = re.compile(r"([A-Za-z_]\w*)\s*=\s*([^,;]+)")
_INT_SUFFIX = re.compile(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]*\b")
_SAFE_EXPR = re.compile(r"^[\w\s+\-*/()<>|&^]*$")


def extract_cc_constants(text: str) -> dict[str, tuple[int, int]]:
    """name -> (value, line) for every constexpr integer in a .cc/.h."""
    idx = LineIndex(text)
    out: dict[str, tuple[int, int]] = {}
    for stmt in _CC_CONSTEXPR.finditer(text):
        for decl in _CC_DECL.finditer(stmt.group(1)):
            name, expr = decl.group(1), decl.group(2).strip()
            expr = _INT_SUFFIX.sub(lambda m: m.group(1), expr)
            if not _SAFE_EXPR.match(expr):
                continue  # non-arithmetic initializer (cast, sizeof, …)
            env = {n: v for n, (v, _) in out.items()}
            try:
                value = eval(expr, {"__builtins__": {}}, env)  # noqa: S307
            except Exception:
                continue
            if isinstance(value, int):
                line = idx.line(stmt.start(1) + decl.start(1))
                out[name] = (value, line)
    return out


def load_python_anchor(root: str) -> dict | None:
    """Execute wire_constants.py from ``root`` in a fresh namespace.

    The module is stdlib-only by contract, so this stays jax-free and
    works on fixture trees that ship their own (possibly drifted) copy.
    """
    rel = "ray_tpu_torch/_private/wire_constants.py"
    src = read_source(root, rel)
    if src is None:
        return None
    ns: dict = {"__name__": "wire_constants", "__file__": rel}
    exec(compile(src, rel, "exec"), ns)  # noqa: S102
    return ns


def _pairs(prefix_map: dict[str, str], anchor: dict) -> list[tuple[str, str]]:
    """[(cc_name, py_name)] for names present in the anchor."""
    return [(cc, py) for cc, py in prefix_map.items() if py in anchor]


def _compare(rel: str, cc: dict[str, tuple[int, int]], anchor: dict,
             mapping: dict[str, str], rule: str,
             violations: list[Violation]) -> None:
    for cc_name, py_name in _pairs(mapping, anchor):
        if cc_name not in cc:
            violations.append(Violation(
                rule, rel, 1,
                f"expected constant {cc_name} (Python anchor "
                f"wire_constants.{py_name} = {anchor[py_name]!r}) not found"))
            continue
        value, line = cc[cc_name]
        expected = anchor[py_name]
        if value != expected:
            violations.append(Violation(
                rule, rel, line,
                f"{cc_name} = {value} but Python anchor "
                f"wire_constants.{py_name} = {expected}"))


def _check_store_daemon(root: str, anchor: dict,
                        violations: list[Violation]) -> None:
    rel = "ray_tpu_torch/native/shm_store.cc"
    src = read_source(root, rel)
    if src is None:
        return
    cc = extract_cc_constants(src)
    ops = {f"OP_{n}": f"OP_{n}" for n in (
        "CREATE", "SEAL", "GET", "RELEASE", "DELETE", "CONTAINS", "STATS",
        "ABORT", "PUT", "GET_INLINE", "PULL", "PUSH", "AUDIT")}
    sts = {f"ST_{n}": f"ST_{n}" for n in (
        "OK", "NOT_FOUND", "EXISTS", "OOM", "TIMEOUT", "NOT_SEALED", "ERR",
        "EVICTED", "VIEW")}
    xfer = {f"XFER_{n}": f"XFER_{n}" for n in ("PULL", "PUSH", "PULL_RANGE")}
    _compare(rel, cc, anchor, {**ops, **sts, **xfer}, "drift/opcode",
             violations)
    layout = {"kIdLen": "OBJECT_ID_LEN"}
    _compare(rel, cc, anchor, layout, "drift/layout", violations)
    # Frame sizes vs the struct formats the Python client packs with.
    for cc_name, py_struct in (("kReqLen", "STORE_REQ"),
                               ("kRespLen", "STORE_RESP")):
        if py_struct not in anchor or cc_name not in cc:
            continue
        value, line = cc[cc_name]
        expected = anchor[py_struct].size
        if value != expected:
            violations.append(Violation(
                "drift/layout", rel, line,
                f"{cc_name} = {value} but wire_constants.{py_struct} "
                f"packs {expected} bytes"))


def _check_wire_codec(root: str, anchor: dict,
                      violations: list[Violation]) -> None:
    rel = "ray_tpu_torch/native/wire.h"
    src = read_source(root, rel)
    if src is None:
        return
    cc = extract_cc_constants(src)
    _compare(rel, cc, anchor,
             {"kVersion": "WIRE_VERSION", "kMaxDepth": "MAX_DEPTH",
              "kMaxItems": "MAX_ITEMS"},
             "drift/wire-codec", violations)
    # The hello preamble is a string, not a constexpr int: match the
    # literal bytes (minus the trailing version byte, checked above).
    hello = anchor.get("HELLO")
    if isinstance(hello, bytes):
        prefix = hello[:-1].decode()
        if prefix not in src:
            violations.append(Violation(
                "drift/wire-codec", rel, 1,
                f"hello preamble {prefix!r} (wire_constants.HELLO) "
                "not present"))


def _check_frame_caps(root: str, anchor: dict,
                      violations: list[Violation]) -> None:
    for rel in ("ray_tpu_torch/native/core_worker.cc",
                "ray_tpu_torch/native/gcs_server.cc"):
        src = read_source(root, rel)
        if src is None:
            continue
        cc = extract_cc_constants(src)
        _compare(rel, cc, anchor, {"kMaxFrame": "MAX_FRAME"},
                 "drift/frame-cap", violations)
        if rel.endswith("core_worker.cc"):
            _compare(rel, cc, anchor, {"kStoreIdLen": "OBJECT_ID_LEN"},
                     "drift/layout", violations)
            for cc_name, py_struct in (("kStoreReqLen", "STORE_REQ"),
                                       ("kStoreRespLen", "STORE_RESP")):
                if py_struct not in anchor or cc_name not in cc:
                    continue
                value, line = cc[cc_name]
                expected = anchor[py_struct].size
                if value != expected:
                    violations.append(Violation(
                        "drift/layout", rel, line,
                        f"{cc_name} = {value} but wire_constants."
                        f"{py_struct} packs {expected} bytes"))


def _check_channel_magic(root: str, anchor: dict,
                         violations: list[Violation]) -> None:
    rel = "ray_tpu_torch/native/mutable_channel.cc"
    src = read_source(root, rel)
    if src is None or "CHANNEL_MAGIC" not in anchor:
        return
    cc = extract_cc_constants(src)
    _compare(rel, cc, anchor, {"kMagic": "CHANNEL_MAGIC"},
             "drift/channel-magic", violations)


# ---------------------------------------------------------------------------
# Env-flag registry lint (moved here from tests/test_flags.py so the CLI
# and the test share one implementation).

# Python: os.environ.get / .setdefault / [] / os.getenv
PY_READ = re.compile(
    r"(?:environ(?:\.get\(|\.setdefault\(|\[)|os\.getenv\()"
    r"\s*\"((?:RTPU|RAY_TPU)_[A-Z0-9_]+)\"")
# C++: getenv("RTPU_...") in the native store/raylet/GCS sources
CC_READ = re.compile(r"getenv\(\s*\"((?:RTPU|RAY_TPU)_[A-Z0-9_]+)\"")
# Registration sites in flags.py: the _b/_i/_f/_s spec helpers (or a
# bare FlagSpec) with a literal name.
_FLAG_SPEC = re.compile(
    r"(?:\b_[bifs]|\bFlagSpec)\(\s*\"((?:RTPU|RAY_TPU)_[A-Z0-9_]+)\"")


def registered_flags(root: str) -> set[str]:
    src = read_source(root, "ray_tpu_torch/_private/flags.py")
    if src is None:
        return set()
    return set(_FLAG_SPEC.findall(src))


def _check_flags(root: str, violations: list[Violation]) -> None:
    registry = registered_flags(root)
    if not registry:
        return  # fixture tree without a flags registry
    flags_rel = "ray_tpu_torch/_private/flags.py"
    # Direction 1: every env read names a registered flag.
    reads: dict[str, tuple[str, int]] = {}
    py_files = walk_files(root, (".py",))
    cc_files = walk_files(root, (".cc", ".h"))
    for files, pattern in ((py_files, PY_READ), (cc_files, CC_READ)):
        for src in files:
            if src.rel == flags_rel:
                continue
            idx = None
            for m in pattern.finditer(src.text):
                idx = idx or LineIndex(src.text)
                reads.setdefault(m.group(1), (src.rel, idx.line(m.start())))
    for name, (rel, line) in sorted(reads.items()):
        if name not in registry:
            violations.append(Violation(
                "drift/flag-unregistered", rel, line,
                f"env var {name} is read but not in the flag registry "
                "(_private/flags.py FLAGS)"))
    # Direction 2: every registered flag is read somewhere (a dead entry
    # is a stale knob or a typo'd registration shadowing the real name).
    corpus = "\n".join(
        src.text for src in py_files + cc_files
        if os.path.basename(src.rel) != "flags.py")
    flags_src = read_source(root, flags_rel) or ""
    flags_idx = LineIndex(flags_src)
    for name in sorted(registry):
        if f'"{name}"' in corpus or f"'{name}'" in corpus:
            continue
        m = re.search(rf'"{name}"', flags_src)
        line = flags_idx.line(m.start()) if m else 1
        violations.append(Violation(
            "drift/flag-dead", flags_rel, line,
            f"flag {name} is registered but never read by any source file"))


def check(root: str) -> list[Violation]:
    violations: list[Violation] = []
    anchor = load_python_anchor(root)
    if anchor is not None:
        # Guard against the anchor itself drifting from the packers: the
        # request layout must still be op|id|u64|u64 over the shared id.
        try:
            expected_req = struct.calcsize(
                f"<B{anchor['OBJECT_ID_LEN']}sQQ")
            if anchor["STORE_REQ"].size != expected_req:
                violations.append(Violation(
                    "drift/layout", "ray_tpu_torch/_private/wire_constants.py", 1,
                    f"STORE_REQ packs {anchor['STORE_REQ'].size} bytes but "
                    f"OBJECT_ID_LEN={anchor['OBJECT_ID_LEN']} implies "
                    f"{expected_req}"))
        except KeyError:
            pass
        _check_store_daemon(root, anchor, violations)
        _check_wire_codec(root, anchor, violations)
        _check_frame_caps(root, anchor, violations)
        _check_channel_magic(root, anchor, violations)
    _check_flags(root, violations)
    return violations
