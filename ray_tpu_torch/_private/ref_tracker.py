"""Per-process ObjectRef provenance + reference-table flush lane.

Counterpart of the reference's `ray memory` bookkeeping
(reference_count.cc call-site recording behind
RAY_record_ref_creation_sites): every process holding ObjectRefs keeps a
provenance row per distinct oid — the user-code call site that first
created the ref here, the executing task/actor and trace at that moment,
and a coarse kind (task return, put, deserialized).  Snapshots of the
live reference table (joined against the worker context's `_ref_counts`
/ `_owned_puts` / `_lineage` books, which remain the single source of
truth for counts) flush to the node scheduler over the telemetry lane
(`refs_push`, like `spans_push`/`goodput_push`) and are merged
cluster-wide by the state API / dashboard / CLI.

Cost model: provenance capture is ONE `sys._getframe` walk per distinct
oid (not per ref copy), gated by RTPU_RECORD_REF_CREATION_SITES; the
reference table itself adds nothing to the ref-count hot path — rows are
assembled only at flush time from books the worker already maintains.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_lock = threading.RLock()  # GC-driven __del__ hooks can re-enter
# oid -> provenance row (created once per distinct oid in this process)
_prov: Dict[bytes, dict] = {}
_PROV_CAP = 100_000  # hard bound; past it new oids get count-only rows
# Recently-dropped provenance (last ref died here): flushed as count-0
# "dropped" rows so store bytes that outlive their refs — the classic
# leak — still attribute to the call site that created them.
_dropped: "deque[tuple]" = deque(maxlen=512)  # (oid, prov row)

_record_sites: Optional[bool] = None  # lazy flag read (flags.py)

_flusher_started = False
_flush_gen = 0
_flush_stop = threading.Event()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/ holds example drivers (obs_smoke etc.): user code from the
# provenance perspective, even though it ships inside the package
_SCRIPTS_DIR = os.path.join(_PKG_DIR, "scripts") + os.sep


def _sites_enabled() -> bool:
    global _record_sites
    if _record_sites is None:
        try:
            from ray_tpu_torch._private import flags

            _record_sites = bool(flags.get("RTPU_RECORD_REF_CREATION_SITES"))
        except Exception:
            _record_sites = True
    return _record_sites


def _call_site() -> str:
    """First stack frame outside the ray_tpu package (the user line that
    created the ref); "<internal>" when the whole stack is runtime code
    (e.g. argument deserialization inside a worker)."""
    try:
        f = sys._getframe(3)
    except ValueError:
        return "<internal>"
    while f is not None:
        fn = f.f_code.co_filename
        # runpy/threading are the `python -m worker_main` / daemon-thread
        # bootstraps under the package frames — not user code
        if ((not fn.startswith(_PKG_DIR) or fn.startswith(_SCRIPTS_DIR))
                and "importlib" not in fn
                and not fn.endswith(("runpy.py", "threading.py"))):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<internal>"


def _current_task():
    """(task_name, trace_id) executing on this thread, from the profiling
    note_task bracket; falls back to the driver's active trace_span."""
    name, trace = None, None
    try:
        from ray_tpu_torch._private import profiling

        cur = profiling.current_task()
        if cur is not None:
            name, trace = cur
    except Exception:
        pass
    if trace is None:
        try:
            from ray_tpu_torch.util import tracing

            ctx = tracing.current_context()
            if ctx is not None:
                trace = ctx[0]
        except Exception:
            pass
    return name, trace


def note_created(oid: bytes) -> None:
    """First local ref for ``oid`` appeared: record where.  Called from
    the worker context's _on_ref_created on the 0 -> 1 transition only."""
    if not _sites_enabled():
        return
    with _lock:
        if oid in _prov or len(_prov) >= _PROV_CAP:
            return
        task, trace = _current_task()
        _prov[oid] = {
            "site": _call_site(),
            "task": task,
            "trace_id": trace,
            "created_ts": time.time(),
            "kind": "ref",
            "escaped": False,
        }


def note_deleted(oid: bytes) -> None:
    """Last local ref for ``oid`` died: move its provenance row to the
    dropped ring (bounded) so the merged view can still attribute any
    store bytes the refs left behind."""
    with _lock:
        row = _prov.pop(oid, None)
        if row is not None:
            row["dropped_ts"] = time.time()
            _dropped.append((oid, row))


def annotate(oid: bytes, **fields) -> None:
    """Refine an existing row (kind="put"/"task_return", escaped=True...).
    A row that never got provenance (flag off / cap) is left absent —
    snapshot() still emits a count-only row for it."""
    with _lock:
        row = _prov.get(oid)
        if row is not None:
            row.update(fields)


def clear() -> None:
    with _lock:
        _prov.clear()
        _dropped.clear()


def snapshot(ctx) -> List[dict]:
    """Assemble this process's reference table from the worker context's
    books joined with provenance.  Each row: oid, local ref count, pin /
    lineage membership, and (when recorded) site/task/trace/kind/age."""
    counts = getattr(ctx, "_ref_counts", None)
    if counts is None:
        return []
    lock = getattr(ctx, "_ref_lock", None) or threading.Lock()
    with lock:
        count_rows = dict(counts)
        owned = set(getattr(ctx, "_owned_puts", ()) or ())
    lineage = set()
    llock = getattr(ctx, "_lineage_lock", None)
    if llock is not None:
        with llock:
            lineage = set(getattr(ctx, "_lineage", ()) or ())
    now = time.time()
    rows: List[dict] = []
    with _lock:
        for oid, count in count_rows.items():
            p = _prov.get(oid)
            rows.append({
                "object_id": oid.hex(),
                "count": count,
                "pinned": oid in owned,
                "lineage": oid in lineage,
                "site": p["site"] if p else None,
                "task": p["task"] if p else None,
                "trace_id": p["trace_id"] if p else None,
                "kind": p["kind"] if p else "ref",
                "escaped": p["escaped"] if p else False,
                "age_s": round(now - p["created_ts"], 3) if p else None,
            })
        # lineage-held oids whose local refs all died still pin recovery
        # state; report them so the merged view explains the bytes (their
        # provenance moved to the dropped ring when the last ref died)
        dmap = dict(_dropped)
        for oid in lineage - set(count_rows):
            p = _prov.get(oid) or dmap.get(oid)
            rows.append({
                "object_id": oid.hex(),
                "count": 0,
                "pinned": oid in owned,
                "lineage": True,
                "site": p["site"] if p else None,
                "task": p["task"] if p else None,
                "trace_id": p["trace_id"] if p else None,
                "kind": "lineage",
                "escaped": p["escaped"] if p else False,
                "age_s": round(now - p["created_ts"], 3) if p else None,
            })
        # recently-dropped provenance: count-0 attribution-only rows (the
        # merge never treats them as holders) for bytes outliving refs
        live = set(count_rows) | lineage
        for oid, p in _dropped:
            if oid in live:
                continue
            rows.append({
                "object_id": oid.hex(),
                "count": 0, "pinned": False, "lineage": False,
                "site": p.get("site"), "task": p.get("task"),
                "trace_id": p.get("trace_id"), "kind": "dropped",
                "escaped": p.get("escaped", False),
                "age_s": round(now - p["created_ts"], 3),
            })
    return rows


# ---------------------------------------------------------------------------
# flush plane: reference table -> node scheduler ("refs_push")

def flush_refs() -> int:
    """Push this process's current reference table to the node scheduler;
    returns the row count.  Snapshot-replace semantics (NOT append): the
    scheduler banks the latest table per process, so a retry or a missed
    interval never double-counts."""
    from ray_tpu_torch._private import worker as worker_mod

    ctx = worker_mod.global_worker_or_none()
    if ctx is None or getattr(ctx, "_ref_counts", None) is None:
        return 0
    rows = snapshot(ctx)
    try:
        ctx.rpc("refs_push", {
            "pid": os.getpid(),
            "proc": getattr(ctx, "mode", "worker"),
            "worker_id": (ctx.worker_id.hex()
                          if getattr(ctx, "worker_id", b"") else ""),
            "ts": time.time(),
            "refs": rows,
        })
        return len(rows)
    except Exception:
        return 0  # next interval retries with a fresher snapshot


def _flush_interval() -> float:
    try:
        from ray_tpu_torch._private import flags

        return max(0.25, float(flags.get("RTPU_REFS_FLUSH_S")))
    except Exception:
        return 5.0


def ensure_flusher() -> None:
    global _flusher_started, _flush_gen
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
        _flush_gen += 1
        gen = _flush_gen
        _flush_stop.clear()
    threading.Thread(target=_flush_loop, args=(gen,), name="refs-flush",
                     daemon=True).start()


def _flush_loop(gen: int) -> None:
    global _flusher_started
    while True:
        stopped = _flush_stop.wait(_flush_interval())
        with _lock:
            if gen != _flush_gen:
                return  # superseded by a newer flusher
            if stopped:
                _flusher_started = False
                return
        try:
            flush_refs()
        except Exception:
            pass


def shutdown_flusher(flush: bool = False) -> None:
    """Stop the background flusher; optionally pushing one final table."""
    if flush:
        try:
            flush_refs()
        except Exception:
            pass
    _flush_stop.set()
