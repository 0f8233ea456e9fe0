"""State API: unified cluster introspection.

Counterpart of Ray's python/ray/util/state/api.py:110
(list_actors/list_tasks/list_nodes/list_objects/list_placement_groups,
summarize_tasks/actors) aggregating GCS tables + per-node scheduler
task-event logs, the way the reference's state aggregator combines GCS and
raylet sources (dashboard/state_aggregator.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.worker import global_worker


def _rpc(method: str, params: Optional[dict] = None):
    return global_worker().rpc(method, params or {})


def _node_rpc(sched_socket: str, method: str, params: Optional[dict] = None):
    """One-shot rpc against a specific node's scheduler."""
    conn = protocol.connect_addr(sched_socket)
    try:
        conn.send({"t": "rpc", "method": method, "params": params or {}})
        resp = conn.recv()
    finally:
        conn.close()
    if resp is None or not resp.get("ok"):
        raise RuntimeError(f"state rpc {method} failed: "
                           f"{resp.get('error') if resp else 'closed'}")
    return resp["result"]


def list_nodes() -> List[Dict[str, Any]]:
    return [{"node_id": n["node_id"].hex(), "alive": n["alive"],
             "is_head": n["is_head"], "resources": n["resources"],
             "available": n["available"]}
            for n in _rpc("list_nodes")]


def list_actors(detail: bool = False) -> List[Dict[str, Any]]:
    out = []
    for a in _rpc("list_actors"):
        row = {"actor_id": a["actor_id"].hex(), "state": a["state"],
               "class_name": a["class_name"], "name": a["name"],
               "node_id": a["node_id"].hex() if a["node_id"] else None}
        if detail:
            row.update(num_restarts=a["num_restarts"],
                       max_restarts=a["max_restarts"],
                       death_cause=a["death_cause"])
        out.append(row)
    return out


def _all_task_events() -> List[dict]:
    events: List[dict] = []
    for n in _rpc("list_nodes"):
        if not n["alive"]:
            continue
        try:
            evs = _node_rpc(n["sched_socket"], "list_task_events")
        except (OSError, RuntimeError):
            continue
        for e in evs:
            e["node_id"] = n["node_id"]
        events.extend(evs)
    return events


def list_tasks(filters: Optional[list] = None) -> List[Dict[str, Any]]:
    """One row per task event; filters are (key, '=', value) triples on
    the rendered rows (reference: list_tasks filter syntax subset).
    FORWARDED entries (a node handing a spec to a peer) are dropped — the
    executing node's row is the real lifecycle."""
    rows = []
    for e in _all_task_events():
        if e["state"] == "FORWARDED":
            continue
        rows.append({
            "task_id": e["task_id"].hex(),
            "name": e["name"],
            "type": e["kind"].upper(),
            "state": e["state"],
            "node_id": e["node_id"].hex(),
            "worker_id": e["worker_id"].hex() if e["worker_id"] else None,
            "actor_id": e["actor_id"].hex() if e["actor_id"] else None,
            "submitted_ts": e["submitted_ts"],
            "start_ts": e["start_ts"],
            "end_ts": e["end_ts"],
        })
    for key, op, value in (filters or ()):
        if op != "=":
            raise ValueError(f"unsupported filter op {op!r}")
        rows = [r for r in rows if r.get(key) == value]
    return rows


def list_refs() -> List[Dict[str, Any]]:
    """Merged per-process reference tables cluster-wide (refs_push lane):
    one record per worker/driver with its live ObjectRef rows (count,
    pin/lineage membership, and — when RTPU_RECORD_REF_CREATION_SITES is
    on — the creating call site, task and trace).  Flushes the driver's
    own table first so just-created refs are part of the answer."""
    from ray_tpu_torch._private import ref_tracker

    ref_tracker.flush_refs()
    tables: List[dict] = []
    for n in _alive_nodes():
        try:
            tables.extend(_node_rpc(n["sched_socket"], "list_refs"))
        except (OSError, RuntimeError):
            continue
    for t in tables:
        if isinstance(t.get("node"), bytes):
            t["node"] = t["node"].hex()
    return tables


def store_audits(max_rows: Optional[int] = None,
                 max_tombstones: int = 4096) -> List[Dict[str, Any]]:
    """Per-node object-store audits (shm daemon OP_AUDIT): occupancy/
    fragmentation summary + per-object rows + recent eviction
    tombstones, stamped with the owning node id."""
    params: Dict[str, Any] = {"max_tombstones": max_tombstones}
    if max_rows is not None:
        params["max_rows"] = max_rows
    out: List[dict] = []
    for n in _alive_nodes():
        try:
            doc = _node_rpc(n["sched_socket"], "store_audit", params)
        except (OSError, RuntimeError):
            continue
        doc["node_id"] = n["node_id"].hex()
        out.append(doc)
    return out


def list_objects(filters: Optional[list] = None) -> List[Dict[str, Any]]:
    """One row per known object: the store audit (size, seal state, pin
    count, age, idle time) joined with the GCS location directory
    (primary copy) and the merged reference tables (holders: which
    process created/holds the ref, at which call site, under which
    task/trace).  Filters are (key, '=', value) triples on the rendered
    rows — the same syntax :func:`list_tasks` supports."""
    locs = _rpc("list_object_locations")
    loc_by_hex = {oid.hex(): [n.hex() for n in nodes]
                  for oid, nodes in locs.items()}
    out = merge_object_rows(store_audits(), list_refs(), loc_by_hex)
    for key, op, value in (filters or ()):
        if op != "=":
            raise ValueError(f"unsupported filter op {op!r}")
        out = [r for r in out
               if r.get(key) == value or str(r.get(key)) == str(value)]
    return out


def merge_object_rows(audits: List[dict], tables: List[dict],
                      loc_by_hex: Dict[str, list]) -> List[Dict[str, Any]]:
    """Pure join of per-node store audits + merged reference tables + the
    GCS location directory into :func:`list_objects` rows.  The CLI
    fetches the three inputs over raw scheduler RPC (it has no driver
    context) and reuses this merge."""
    holders: Dict[str, List[dict]] = {}
    sites: Dict[str, dict] = {}  # attribution even after refs died
    for table in tables:
        for r in table.get("refs") or ():
            oid = r["object_id"]
            # a real user site beats "<internal>" (a worker creating its
            # own return object records no user frame)
            if (r.get("site") and r["site"] != "<internal>"
                    and oid not in sites):
                sites[oid] = r
            if r.get("kind") == "dropped":
                continue  # attribution-only row, nothing holds the oid
            holders.setdefault(oid, []).append({
                "node": table.get("node"), "proc": table.get("proc"),
                "pid": table.get("pid"), "count": r.get("count", 0),
                "pinned": r.get("pinned", False),
                "lineage": r.get("lineage", False),
                "site": r.get("site"), "task": r.get("task"),
                "trace_id": r.get("trace_id"), "kind": r.get("kind"),
            })
    rows: Dict[str, dict] = {}
    for doc in audits:
        nid = doc["node_id"]
        for o in doc.get("objects") or ():
            oid = o["id"]
            row = rows.get(oid)
            if row is None:
                hs = holders.get(oid, [])
                src = (next((h for h in hs
                             if h.get("site")
                             and h["site"] != "<internal>"), None)
                       or sites.get(oid))
                locations = loc_by_hex.get(oid, [])
                row = rows[oid] = {
                    "object_id": oid,
                    "size_bytes": o.get("size", 0),
                    "seal_state": "SEALED" if o.get("sealed") else
                                  "CREATED",
                    "pinned": bool(o.get("refcount", 0) > 0),
                    "pin_count": o.get("refcount", 0),
                    "spilled": bool(o.get("spilled")),
                    "age_s": round(o.get("age_ms", 0) / 1e3, 3),
                    "idle_s": round(o.get("idle_ms", 0) / 1e3, 3),
                    "primary_copy": (locations[0] if locations else nid),
                    "locations": locations or [nid],
                    "nodes_resident": [],
                    "ref_count": sum(h["count"] for h in hs),
                    "holders": hs,
                    "site": src["site"] if src else None,
                    "task": src["task"] if src else None,
                    "trace_id": src["trace_id"] if src else None,
                }
            row["nodes_resident"].append(nid)
    # refs whose object is not resident anywhere (pending, inlined, or
    # lost): still one row each, so `rtpu memory` explains every holder
    for oid, hs in holders.items():
        if oid in rows:
            continue
        src = (next((h for h in hs if h.get("site")
                     and h["site"] != "<internal>"), None)
               or sites.get(oid))
        locations = loc_by_hex.get(oid, [])
        rows[oid] = {
            "object_id": oid, "size_bytes": 0, "seal_state": "ABSENT",
            "pinned": False, "pin_count": 0, "spilled": False,
            "age_s": None, "idle_s": None,
            "primary_copy": locations[0] if locations else None,
            "locations": locations, "nodes_resident": [],
            "ref_count": sum(h["count"] for h in hs), "holders": hs,
            "site": src["site"] if src else None,
            "task": src["task"] if src else None,
            "trace_id": src["trace_id"] if src else None,
        }
    return list(rows.values())


def detect_leaks(age_s: Optional[float] = None,
                 grace_s: float = 10.0) -> Dict[str, Any]:
    """Cross-reference store-resident objects against the merged
    reference tables and flag:

    - ``unreferenced``: sealed, unpinned bytes no process holds a ref to
      (and no lineage entry can recover a consumer for) — orphaned until
      LRU pressure happens to evict them.  A ``grace_s`` window skips
      objects younger than the refs flush interval.
    - ``age_outlier``: resident objects older than ``age_s`` (default
      RTPU_LEAK_AGE_S) that have not been read since creation.
    - ``held_lost``: refs still held on objects that are gone from every
      store (eviction tombstone) — attributed to their creating call
      site so the holder can be found even after a daemon restart.

    Tombstoned ids themselves are NEVER leaks: a tombstone means the
    store already reclaimed (or never kept) the bytes."""
    audits = store_audits()
    tables = list_refs()
    lost = lost_held_ids(audits, tables,
                         lambda oid: _rpc("object_lost", {"oid": oid}))
    return leak_report(audits, tables, age_s, grace_s, lost_ids=lost)


def lost_held_ids(audits: List[dict], tables: List[dict], query,
                  cap: int = 512) -> set:
    """GCS-lost ids among held-but-nowhere-resident refs.  The daemon's
    eviction-tombstone ring dies with the daemon, so after a store
    restart the durable GCS loss record is what lets ``held_lost``
    classification still fire; ``query(oid_bytes) -> bool`` is the
    caller's ``object_lost`` RPC (the CLI supplies its own transport)."""
    resident = {o["id"] for doc in audits
                for o in doc.get("objects") or ()}
    tomb = {t for doc in audits for t in doc.get("tombstone_ids") or ()}
    # live refs only: lost_ids feed held_lost classification, and a
    # lineage-only row on a lost object is reclamation, not a leak
    held = {r["object_id"] for table in tables
            for r in table.get("refs") or ()
            if r.get("count", 0) > 0}
    lost: set = set()
    for oid in sorted(held - resident - tomb)[:cap]:
        try:
            if query(bytes.fromhex(oid)):
                lost.add(oid)
        except Exception:
            break  # best-effort: a dead head just means no extra class
    return lost


def leak_report(audits: List[dict], tables: List[dict],
                age_s: Optional[float] = None,
                grace_s: float = 10.0,
                lost_ids: Optional[set] = None) -> Dict[str, Any]:
    """Pure leak cross-reference over already-fetched audits/ref tables
    (classes as documented on :func:`detect_leaks`).  ``lost_ids``
    extends the store tombstones with GCS-lost ids (``lost_held_ids``)
    so held refs on objects wiped by a daemon restart still classify."""
    from ray_tpu_torch._private import flags

    if age_s is None:
        age_s = float(flags.get("RTPU_LEAK_AGE_S"))
    tombstones = set(lost_ids or ())
    for doc in audits:
        tombstones.update(doc.get("tombstone_ids") or ())
    held: Dict[str, List[dict]] = {}
    sites: Dict[str, dict] = {}  # attribution, incl. dropped-prov rows
    for table in tables:
        for r in table.get("refs") or ():
            if r.get("site") and r["object_id"] not in sites:
                sites[r["object_id"]] = r
            if r.get("count", 0) > 0 or r.get("lineage"):
                held.setdefault(r["object_id"], []).append(dict(
                    r, node=table.get("node"), proc=table.get("proc"),
                    pid=table.get("pid")))
    leaks: List[dict] = []
    resident: set = set()
    checked = 0
    for doc in audits:
        nid = doc["node_id"]
        for o in doc.get("objects") or ():
            oid = o["id"]
            resident.add(oid)
            checked += 1
            age = o.get("age_ms", 0) / 1e3
            idle = o.get("idle_ms", 0) / 1e3
            hs = held.get(oid)
            src = sites.get(oid) or {}
            site = next((h.get("site") for h in (hs or ())
                         if h.get("site")), None) or src.get("site")
            task = next((h.get("task") for h in (hs or ())
                         if h.get("task")), None) or src.get("task")
            if (hs is None and o.get("sealed")
                    and not o.get("refcount") and age > grace_s):
                leaks.append({
                    "kind": "unreferenced", "object_id": oid,
                    "node_id": nid, "size_bytes": o.get("size", 0),
                    "age_s": round(age, 3), "site": site, "task": task,
                    "detail": "no live ref in any process"})
            elif age > age_s and idle >= age - grace_s:
                leaks.append({
                    "kind": "age_outlier", "object_id": oid,
                    "node_id": nid, "size_bytes": o.get("size", 0),
                    "age_s": round(age, 3), "site": site, "task": task,
                    "detail": f"resident {age:.0f}s, never re-read"})
    for oid, hs in held.items():
        if oid in resident or oid not in tombstones:
            continue
        live = sum(h.get("count", 0) for h in hs)
        if live <= 0:
            # lineage bookkeeping only: no process can still read this
            # oid, so its loss is reclamation, not a leak
            continue
        src = next((h for h in hs if h.get("site")), hs[0])
        leaks.append({
            "kind": "held_lost", "object_id": oid,
            "node_id": src.get("node"), "size_bytes": 0,
            "age_s": src.get("age_s"), "site": src.get("site"),
            "task": src.get("task"),
            "detail": f"{live} live ref(s) on a store-evicted object"})
    leaks.sort(key=lambda r: r.get("size_bytes") or 0, reverse=True)
    return {"leaks": leaks, "checked_objects": checked,
            "nodes": len(audits),
            "thresholds": {"age_s": age_s, "grace_s": grace_s}}


def memory_summary() -> Dict[str, Any]:
    """The `ray memory` view: cluster objects grouped by creation call
    site (size totals, counts, ages, holder tasks), plus each node's
    occupancy/fragmentation summary and the leak report.  Shared by the
    dashboard's /api/memory and the `rtpu memory` CLI."""
    objects = list_objects()
    node_summaries = [dict((doc.get("summary") or {}),
                           node_id=doc["node_id"])
                      for doc in store_audits(max_rows=0)]
    return {"groups": group_objects_by_site(objects),
            "objects": len(objects),
            "nodes": node_summaries, "leak_report": detect_leaks()}


def group_objects_by_site(objects: List[dict]) -> List[Dict[str, Any]]:
    """Pure `ray memory`-style grouping of :func:`list_objects` rows by
    creation call site, largest total first."""
    groups: Dict[str, dict] = {}
    for r in objects:
        key = r.get("site") or "(no call site recorded)"
        g = groups.setdefault(key, {
            "site": key, "count": 0, "total_bytes": 0, "ref_count": 0,
            "pinned": 0, "max_age_s": 0.0, "tasks": set(), "kinds": set(),
            "example": r["object_id"]})
        g["count"] += 1
        g["total_bytes"] += r.get("size_bytes") or 0
        g["ref_count"] += r.get("ref_count") or 0
        g["pinned"] += 1 if r.get("pinned") else 0
        g["max_age_s"] = max(g["max_age_s"], r.get("age_s") or 0.0)
        if r.get("task"):
            g["tasks"].add(r["task"])
        for h in r.get("holders") or ():
            if h.get("kind"):
                g["kinds"].add(h["kind"])
    rows = []
    for g in groups.values():
        g["tasks"] = sorted(g["tasks"])
        g["kinds"] = sorted(g["kinds"])
        rows.append(g)
    rows.sort(key=lambda g: g["total_bytes"], reverse=True)
    return rows


def search_logs(task: Optional[str] = None, trace: Optional[str] = None,
                limit: int = 1000) -> List[Dict[str, Any]]:
    """Task-attributed worker-log lines cluster-wide (the log monitor's
    ring on each node), filtered by task name / task-id prefix and/or
    trace-id prefix, oldest first."""
    rows: List[dict] = []
    for n in _alive_nodes():
        try:
            part = _node_rpc(n["sched_socket"], "logs_search",
                             {"task": task or "", "trace": trace or "",
                              "limit": limit})
        except (OSError, RuntimeError):
            continue
        for r in part:
            if isinstance(r.get("node"), bytes):
                r["node"] = r["node"].hex()
        rows.extend(part)
    rows.sort(key=lambda r: r.get("ts") or 0.0)
    return rows[-limit:]


def list_placement_groups() -> List[Dict[str, Any]]:
    table = _rpc("pg_table")
    rows = []
    for pg_id, info in table.items():
        row = {"placement_group_id": pg_id.hex(), **info}
        # node IDs hex like every other row in this module (JSON-safe)
        if "assignment" in row:
            row["assignment"] = [
                n.hex() if isinstance(n, bytes) else n
                for n in row["assignment"]]
        rows.append(row)
    return rows


def summarize_events(events: List[dict]) -> Dict[str, Dict[str, int]]:
    """name -> state -> count over raw task events (shared with the CLI)."""
    summary: Dict[str, Dict[str, int]] = {}
    for e in events:
        if e["state"] == "FORWARDED":
            continue
        by_state = summary.setdefault(e["name"], {})
        by_state[e["state"]] = by_state.get(e["state"], 0) + 1
    return summary


def summarize_tasks() -> Dict[str, Any]:
    summary = summarize_events(_all_task_events())
    return {"cluster": {"summary": summary,
                        "total_tasks": sum(sum(v.values())
                                           for v in summary.values())}}


def summarize_actors() -> Dict[str, Any]:
    summary: Dict[str, Dict[str, int]] = {}
    for row in list_actors():
        by_state = summary.setdefault(row["class_name"], {})
        by_state[row["state"]] = by_state.get(row["state"], 0) + 1
    return {"cluster": {"summary": summary,
                        "total_actors": sum(sum(v.values())
                                            for v in summary.values())}}


def events_to_chrome_trace(events: List[dict]) -> List[dict]:
    """Raw task events -> chrome://tracing 'X' events (shared with CLI)."""
    import time as time_mod

    trace = []
    for e in events:
        if e["start_ts"] is None or e["state"] == "FORWARDED":
            continue
        end = e["end_ts"] or time_mod.time()
        trace.append({
            "name": e["name"],
            "cat": e["kind"],
            "ph": "X",
            "ts": e["start_ts"] * 1e6,
            "dur": (end - e["start_ts"]) * 1e6,
            "pid": e["node_id"].hex()[:8],
            "tid": e["worker_id"].hex()[:8] if e["worker_id"] else "?",
            "args": {"state": e["state"]},
        })
    return trace


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace events for all finished/running tasks (reference:
    `ray timeline` via GcsTaskManager, scripts.py:2689).  Load the output
    in chrome://tracing or Perfetto."""
    events = events_to_chrome_trace(_all_task_events())
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def _all_trace_spans(trace_id: str) -> List[dict]:
    """Fan one trace's spans in from every alive node's scheduler (each
    node only holds spans its own workers/driver flushed)."""
    spans: List[dict] = []
    for n in _rpc("list_nodes"):
        if not n["alive"]:
            continue
        try:
            spans.extend(_node_rpc(n["sched_socket"], "get_trace_spans",
                                   {"trace_id": trace_id}))
        except (OSError, RuntimeError):
            continue
    return spans


def get_trace(trace_id) -> Dict[str, Any]:
    """Assemble one distributed trace cluster-wide: the span tree across
    every process it touched plus a critical-path summary (queue-wait vs.
    arg-fetch vs. run seconds per span).  ``trace_id`` is the hex string
    from ``Span.trace_id`` (bytes accepted).  Pass the result to
    ``tracing.export_trace_chrome_trace`` for a Perfetto view with
    cross-process flow arrows."""
    from ray_tpu_torch.util import tracing

    if isinstance(trace_id, bytes):
        trace_id = trace_id.hex()
    # driver-side spans may still sit in the local buffer: flush first so
    # the root of a just-finished workload is part of the answer
    tracing.flush_spans()
    return tracing.assemble_trace(trace_id, _all_trace_spans(trace_id))


def list_traces() -> List[Dict[str, Any]]:
    """Known traces cluster-wide, most recent last_ts first."""
    from ray_tpu_torch.util import tracing

    tracing.flush_spans()
    rows: Dict[str, dict] = {}
    for n in _rpc("list_nodes"):
        if not n["alive"]:
            continue
        try:
            node_rows = _node_rpc(n["sched_socket"], "list_traces")
        except (OSError, RuntimeError):
            continue
        for r in node_rows:
            agg = rows.get(r["trace_id"])
            if agg is None:
                rows[r["trace_id"]] = dict(r)
            else:
                agg["num_spans"] += r["num_spans"]
                agg["first_ts"] = min(agg["first_ts"], r["first_ts"])
                agg["last_ts"] = max(agg["last_ts"], r["last_ts"])
                if not agg.get("root"):
                    agg["root"] = r.get("root")
    return sorted(rows.values(), key=lambda r: r["last_ts"], reverse=True)


def _alive_nodes() -> List[dict]:
    return [n for n in _rpc("list_nodes") if n["alive"]]


def list_profiles() -> List[Dict[str, Any]]:
    """Known CPU profiles cluster-wide (always-on "continuous" plus any
    on-demand captures), most recent first, with the task names each
    profile attributed samples to."""
    from ray_tpu_torch._private import profiling

    rows: List[dict] = []
    for n in _alive_nodes():
        try:
            rows.extend(_node_rpc(n["sched_socket"], "list_profiles"))
        except (OSError, RuntimeError):
            continue
    return profiling.merge_profile_rows(rows)


def get_profile(profile_id: str) -> Optional[Dict[str, Any]]:
    """Assemble one profile cluster-wide: folded stacks merged across
    every node, grouped by (task name, trace id).  Pass the result to
    ``profiling.profile_to_speedscope`` / ``profile_to_folded`` for
    flamegraph export, or fetch it rendered from the dashboard's
    ``/api/profile?id=...``."""
    from ray_tpu_torch._private import profiling

    parts = []
    for n in _alive_nodes():
        try:
            parts.append(_node_rpc(n["sched_socket"], "get_profile",
                                   {"profile_id": profile_id}))
        except (OSError, RuntimeError):
            continue
    return profiling.merge_profiles(parts)


def list_goodput() -> List[Dict[str, Any]]:
    """Goodput/step-anatomy summary rows cluster-wide (one per run per
    reporting process), newest first.  Flushes the driver's own tracker
    first so a just-finished loop is part of the answer."""
    from ray_tpu_torch.util import goodput

    goodput.flush_current()
    rows: List[dict] = []
    for n in _alive_nodes():
        try:
            rows.extend(_node_rpc(n["sched_socket"], "list_goodput"))
        except (OSError, RuntimeError):
            continue
    return goodput.merge_goodput_rows(rows)


def get_goodput(run: str) -> Optional[Dict[str, Any]]:
    """Assemble one run's goodput records cluster-wide: per-process
    records plus a merged summary whose badput buckets sum to elapsed
    wall time (see util/goodput.py for the bucket definitions)."""
    from ray_tpu_torch.util import goodput

    goodput.flush_current()
    records: List[dict] = []
    for n in _alive_nodes():
        try:
            records.extend(_node_rpc(n["sched_socket"], "get_goodput",
                                     {"run": run}))
        except (OSError, RuntimeError):
            continue
    return goodput.merge_records(records)


def list_events(kind: str = "", severity: str = "",
                limit: int = 500) -> List[Dict[str, Any]]:
    """Cluster incident timeline (the event plane): every node's banked
    events merged and time-ordered — store-daemon restarts, replica
    deaths, chaos injections, spill/scale decisions, SLO alert
    transitions.  ``kind`` filters by prefix (e.g. "chaos."), each row
    carries its trace_id when the incident happened under a trace."""
    from ray_tpu_torch.util import events as events_mod

    events_mod.flush_events()  # the driver's own buffered events first
    rows: List[dict] = []
    for n in _alive_nodes():
        try:
            rows.extend(_node_rpc(n["sched_socket"], "list_events", {
                "kind": kind, "severity": severity, "limit": limit}))
        except (OSError, RuntimeError):
            continue
    rows.sort(key=lambda e: e.get("ts", 0.0))
    return rows[-max(1, int(limit)):]


def _head_sock() -> str:
    for n in _alive_nodes():
        if n["is_head"]:
            return n["sched_socket"]
    raise RuntimeError("no alive head node")


def query_timeseries(family: str = "",
                     window_s: float = 300.0) -> Dict[str, Any]:
    """Windowed history from the head's ring TSDB: no ``family`` lists
    the known families; with one, the in-window raw points per series
    (same shape as the dashboard's /api/timeseries)."""
    return _node_rpc(_head_sock(), "query_timeseries",
                     {"family": family, "window_s": window_s})


def exemplars_for(family: str,
                  window_s: float = 300.0) -> Dict[str, Dict[int, str]]:
    """Exemplar trace ids banked on a histogram family's buckets: per
    series (keyed "tag=val,..." or "-"), bucket index -> the trace id of
    the last observation that landed there.  This answers "which request
    was the p99" — feed a returned id to :func:`get_trace` for the full
    router→replica→engine anatomy of that request."""
    doc = query_timeseries(family, window_s)
    out: Dict[str, Dict[int, str]] = {}
    for s in doc.get("series") or ():
        ex = s.get("exemplars")
        if not ex:
            continue
        key = ",".join(f"{k}={v}"
                       for k, v in sorted(s.get("tags", {}).items())) or "-"
        cur = out.setdefault(key, {})
        for b, tid in ex.items():
            cur[int(b)] = str(tid)
    return out


def slo_status() -> Dict[str, Any]:
    """The SLO engine's rule table: per-rule current value, fast/slow
    burn rates, firing state — plus the aggregate ``healthy`` bit the
    autoscaler consumes (same shape as /api/slo)."""
    return _node_rpc(_head_sock(), "slo_status")


def tsdb_overview(window_s: float = 60.0) -> List[Dict[str, Any]]:
    """One judged row per metric family over the window (what `rtpu top`
    renders): counters as rates, histograms as rate+p50/p90, gauges as
    latest/mean."""
    return _node_rpc(_head_sock(), "tsdb_overview",
                     {"window_s": window_s})


def record_profile(duration: float = 5.0, hz: float = 99.0,
                   profile_id: Optional[str] = None,
                   ) -> Optional[Dict[str, Any]]:
    """Record a high-rate CPU profile of the whole cluster for
    ``duration`` seconds and return it assembled (see
    :func:`get_profile`).  Every node's scheduler fans the start/stop to
    its workers over their profiler control channels, so busy workers are
    captured mid-task — which is the point."""
    import os as os_mod
    import time as time_mod

    if profile_id is None:
        profile_id = f"prof-{os_mod.urandom(4).hex()}"
    nodes = _alive_nodes()
    for n in nodes:
        try:
            _node_rpc(n["sched_socket"], "profile_start",
                      {"profile_id": profile_id, "hz": hz})
        except (OSError, RuntimeError):
            continue
    time_mod.sleep(duration)
    for n in nodes:
        try:
            _node_rpc(n["sched_socket"], "profile_stop",
                      {"profile_id": profile_id})
        except (OSError, RuntimeError):
            continue
    return get_profile(profile_id)


def dump_stacks(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Live thread stacks of every runtime process (scheduler/driver +
    workers), per node — what `rtpu stack` prints.  ``node_id`` (hex)
    restricts to one node."""
    out: List[dict] = []
    for n in _alive_nodes():
        nid = n["node_id"].hex()
        if node_id is not None and nid != node_id:
            continue
        try:
            entries = _node_rpc(n["sched_socket"], "profile_dump")
        except (OSError, RuntimeError):
            continue
        for e in entries:
            e["node_id"] = nid
        out.extend(entries)
    return out


def list_logs(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Worker log files on one node (reference: ray.util.state.list_logs
    served by the node's dashboard agent; here the node's scheduler plays
    the agent).  node_id is the hex id; None = the local/driver node."""
    if node_id is None:
        return _rpc("list_logs")
    for n in _rpc("list_nodes"):
        nid = n["node_id"].hex() if isinstance(n["node_id"], bytes) \
            else n["node_id"]
        if nid == node_id and n.get("alive", True):
            return _node_rpc(n["sched_socket"], "list_logs")
    raise ValueError(f"no alive node {node_id}")


def get_log(filename: str, node_id: Optional[str] = None,
            tail: int = 200) -> List[str]:
    """Tail one worker log file (reference: ray.util.state.get_log)."""
    params = {"file": filename, "tail": tail}
    if node_id is None:
        out = _rpc("read_log", params)
    else:
        out = None
        for n in _rpc("list_nodes"):
            nid = n["node_id"].hex() if isinstance(n["node_id"], bytes) \
                else n["node_id"]
            if nid == node_id and n.get("alive", True):
                out = _node_rpc(n["sched_socket"], "read_log", params)
                break
        if out is None:
            raise ValueError(f"no alive node {node_id}")
    if out.get("error"):
        raise FileNotFoundError(out["error"])
    return out["lines"]


def list_data_jobs() -> List[Dict[str, Any]]:
    """Status snapshots of every registered data-service job (reference
    shape: tf.data service dispatcher state).  Reads the coordinator's
    GCS KV snapshots, so it works from any driver — including ones that
    never touched the data service."""
    import json as _json

    out: List[Dict[str, Any]] = []
    for key in _rpc("kv_keys", {"namespace": "data_jobs"}) or []:
        blob = _rpc("kv_get", {"namespace": "data_jobs",
                               "key": bytes(key)})
        if blob is None:
            continue
        try:
            out.append(_json.loads(bytes(blob).decode()))
        except (ValueError, UnicodeDecodeError):
            continue
    return sorted(out, key=lambda j: j.get("name", ""))


def serve_routing_stats() -> List[Dict[str, Any]]:
    """Per-deployment request-routing snapshots (policy, replica queue
    depths, engine page/prefix-cache stats) published by the Serve
    controller's stats lane to the GCS KV (namespace serve_routing) —
    readable from any driver, like list_data_jobs."""
    import json as _json

    out: List[Dict[str, Any]] = []
    for key in _rpc("kv_keys", {"namespace": "serve_routing"}) or []:
        blob = _rpc("kv_get", {"namespace": "serve_routing",
                               "key": bytes(key)})
        if blob is None:
            continue
        try:
            out.append(_json.loads(bytes(blob).decode()))
        except (ValueError, UnicodeDecodeError):
            continue
    return sorted(out, key=lambda d: (d.get("app", ""),
                                      d.get("deployment", "")))
