"""``rtpu check``: static analysis for the ray_tpu_torch tree, with
neither torch nor JAX imported.

Counterpart of ``ray_tpu/_private/staticcheck/``: the same six passes,
rule ids, arguments and ``--json`` shape, over the port's package.  Each
file is read and parsed once per run, whichever passes read it
(``common.one_parse_per_file``).

Six passes (see each module's docstring):

- ``drift``    — cross-language protocol constants + env-flag registry
- ``locks``    — C++ lock-order graph / blocking-under-mutex + Python
                 blocking-under-lock
- ``purity``   — hot-path host syncs, and nondeterminism in captured
                 (``torch.compile`` / CUDA graph) code
- ``metrics``  — Prometheus family naming / registration / HELP-TYPE
- ``shard``    — sharding-layout consistency: mesh axes vs AXIS_ORDER,
                 logical axes vs rules tables, dcn/batch invariant,
                 comm-estimator coverage
- ``proto``    — wire-protocol reachability: opcode dispatch/callers,
                 status producers/handlers, frame kinds, chaos-flag
                 lane coverage

Findings are ``Violation``s with file:line; intentional ones are
suppressed by ``allowlist.py`` entries, each of which must carry a
written reason.  Run via ``python -m ray_tpu_torch.scripts.cli check`` or
``python -m ray_tpu_torch._private.staticcheck``.  Select passes with
``rtpu check shard,proto`` or repeated ``--pass``; ``--json`` emits
machine-readable findings for CI and the layout search.
"""

from __future__ import annotations

import time

from ray_tpu_torch._private.staticcheck import (
    drift,
    locks,
    metrics_lint,
    protocheck,
    purity,
    shardcheck,
)
from ray_tpu_torch._private.staticcheck.allowlist import ALLOWLIST
from ray_tpu_torch._private.staticcheck.common import (
    Allow,
    Report,
    Violation,
    apply_allowlist,
    one_parse_per_file,
    repo_root,
    validate_allowlist,
)

__all__ = ["PASSES", "Allow", "Report", "Violation", "run", "main"]

PASSES = {
    "drift": drift.check,
    "locks": locks.check,
    "purity": purity.check,
    "metrics": metrics_lint.check,
    "shard": shardcheck.check,
    "proto": protocheck.check,
}


def run(root: str | None = None, passes: list[str] | None = None,
        allows: list[Allow] | None = None) -> Report:
    root = root or repo_root()
    allows = ALLOWLIST if allows is None else allows
    selected = passes or list(PASSES)
    # Entries for passes that aren't running are not "unused", just out
    # of scope — keep the stale-entry note meaningful on subset runs.
    # (Wildcard pass prefixes like "*" stay in regardless.)
    allows = [a for a in allows
              if a.rule.split("/", 1)[0] in selected
              or any(ch in a.rule.split("/", 1)[0] for ch in "*?[")]
    violations: list[Violation] = []
    with one_parse_per_file():
        for name in selected:
            violations.extend(PASSES[name](root))
    report = apply_allowlist(violations, allows)
    for err in validate_allowlist(allows):
        report.violations.append(
            Violation("allowlist/missing-reason",
                      "ray_tpu_torch/_private/staticcheck/allowlist.py", 1,
                      err))
    return report


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="rtpu check", description=__doc__.split("\n")[0])
    parser.add_argument("passes_csv", nargs="?", default=None,
                        metavar="PASSES",
                        help="comma-separated pass names to run "
                             "(e.g. 'shard,proto'; default: all)")
    parser.add_argument("--root", default=None,
                        help="tree to check (default: this repo)")
    parser.add_argument("--pass", dest="passes", action="append",
                        choices=sorted(PASSES),
                        help="run only this pass (repeatable)")
    parser.add_argument("--no-allowlist", action="store_true",
                        help="show findings the allowlist suppresses")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    args = parser.parse_args(argv)

    selected = list(args.passes or [])
    if args.passes_csv:
        for name in args.passes_csv.split(","):
            name = name.strip()
            if not name:
                continue
            if name not in PASSES:
                parser.error(
                    f"unknown pass {name!r} (choose from "
                    f"{', '.join(sorted(PASSES))})")
            if name not in selected:
                selected.append(name)
    selected = selected or None

    t0 = time.monotonic()
    report = run(root=args.root, passes=selected,
                 allows=[] if args.no_allowlist else None)
    dt = time.monotonic() - t0

    if args.json:
        import json

        def finding(v: Violation, allow: Allow | None) -> dict:
            d = {"pass": v.rule.split("/")[0], "rule": v.rule,
                 "file": v.path, "line": v.line, "message": v.message,
                 "allowlisted": allow is not None}
            if allow is not None:
                d["reason"] = allow.reason
            return d

        print(json.dumps({
            "passes": selected or sorted(PASSES),
            "findings": [finding(v, None) for v in report.violations]
            + [finding(v, a) for v, a in report.suppressed],
            "unused_allows": [a.__dict__ for a in report.unused_allows],
            "elapsed_s": round(dt, 3),
            "ok": report.ok,
        }, indent=2))
        return 0 if report.ok else 1

    for v in report.violations:
        print(v.format())
    for a in report.unused_allows:
        print(f"note: unused allowlist entry [{a.rule}] {a.path} "
              f"({a.reason})")
    n_pass = len(selected) if selected else len(PASSES)
    print(f"rtpu check: {len(report.violations)} violation(s), "
          f"{len(report.suppressed)} allowlisted, {n_pass} pass(es) "
          f"in {dt:.2f}s")
    return 0 if report.ok else 1
