"""ray_tpu_torch CLI: status / memory / stack / timeline / trace / summary / ....

Counterpart of the reference CLI command registry
(Ray's python/ray/scripts/scripts.py:2665-2691 — status, memory,
stack, timeline, microbenchmark, ...).  Attaches to a RUNNING cluster by
its head scheduler socket: pass --address, or the newest session under
the port's session root (``_private/node.py`` ``session_root()``) is used.

Usage:  python -m ray_tpu_torch.scripts.cli <command> [--address PATH] [...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from ray_tpu_torch._private import perf, protocol


def find_address(address: Optional[str]) -> str:
    if address:
        return address
    from ray_tpu_torch._private.node import live_session_sockets, session_root

    live = live_session_sockets()
    if not live:
        sys.exit(f"no live ray_tpu_torch session found under "
                 f"{session_root()}/; pass --address <sched.sock path>")
    return live[0]


def _rpc(sock: str, method: str, params: Optional[dict] = None):
    conn = protocol.connect_addr(sock)
    try:
        conn.send({"t": "rpc", "method": method, "params": params or {}})
        resp = conn.recv()
    finally:
        conn.close()
    if resp is None or not resp.get("ok"):
        raise RuntimeError(f"rpc {method} failed: "
                           f"{resp.get('error') if resp else 'closed'}")
    return resp["result"]


def cmd_status(args):
    sock = find_address(args.address)
    nodes = _rpc(sock, "list_nodes")
    actors = _rpc(sock, "list_actors")
    print(f"======== Cluster status ({time.strftime('%H:%M:%S')}) ========")
    print(f"Nodes: {sum(n['alive'] for n in nodes)} alive / {len(nodes)}")
    for n in nodes:
        mark = "head" if n["is_head"] else "worker"
        state = "ALIVE" if n["alive"] else "DEAD"
        res = " ".join(f"{k}:{n['available'].get(k, 0):g}/{v:g}"
                       for k, v in sorted(n["resources"].items()))
        print(f"  {n['node_id'].hex()[:12]}  {mark:6s} {state:5s}  {res}")
    by_state: dict = {}
    for a in actors:
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    print(f"Actors: {len(actors)} "
          + " ".join(f"{k}={v}" for k, v in sorted(by_state.items())))
    st = _rpc(sock, "cluster_state")
    print(f"Pending tasks (head): {st['pending_tasks']}; "
          f"workers: {st['num_workers']} ({st['num_idle']} idle)")
    # Effective config (reference: RayConfig dump): non-default flags
    # first, then a count of defaults, from the central registry.
    from ray_tpu_torch._private import flags as flags_mod

    rows = flags_mod.describe()
    set_rows = [r for r in rows if r["set"]]
    print(f"Config: {len(set_rows)} flags set, "
          f"{len(rows) - len(set_rows)} at defaults "
          f"(_private/flags.py registry)")
    for r in set_rows:
        print(f"  {r['name']}={r['value']!r}")


def _gather_memory(sock):
    """Fetch per-node store audits + banked reference tables + the head's
    location directory (the inputs to state.merge_object_rows)."""
    audits, tables = [], []
    for n in _rpc(sock, "list_nodes"):
        if not n["alive"]:
            continue
        nid = n["node_id"].hex()
        try:
            doc = _rpc(n["sched_socket"], "store_audit")
            doc["node_id"] = nid
            audits.append(doc)
        except Exception as e:  # noqa: BLE001
            print(f"  {nid[:12]}  store unreachable: {e}")
        try:
            tables.extend(_rpc(n["sched_socket"], "list_refs"))
        except Exception:
            pass
    for t in tables:
        if isinstance(t.get("node"), bytes):
            t["node"] = t["node"].hex()
    try:
        locs = _rpc(sock, "list_object_locations")
    except Exception:
        locs = {}
    loc_by_hex = {oid.hex(): [x.hex() for x in ns]
                  for oid, ns in locs.items()}
    return audits, tables, loc_by_hex


def cmd_memory(args):
    """Cluster memory introspection (reference: `ray memory`): per-node
    store occupancy/fragmentation, then every known object grouped by
    its creating call site with size/age/refcount/holder columns;
    --leaks appends the cross-referenced leak report."""
    from ray_tpu_torch.util import state as state_mod

    sock = find_address(args.address)
    audits, tables, loc_by_hex = _gather_memory(sock)
    print("======== Object store memory ========")
    for doc in audits:
        s = doc.get("summary") or {}
        cap = s.get("capacity") or 0
        print(f"  {doc['node_id'][:12]}  "
              f"used={s.get('used', 0) / 1e6:.1f}/{cap / 1e6:.1f}MB "
              f"occ={s.get('occupancy', 0) * 100:5.1f}% "
              f"frag={s.get('fragmentation', 0) * 100:5.1f}% "
              f"objects={s.get('num_objects', 0)} "
              f"evictions={s.get('evictions', 0)} "
              f"spills={s.get('spills', 0)} "
              f"spilled={s.get('spilled_bytes', 0) / 1e6:.1f}MB")
    objects = state_mod.merge_object_rows(audits, tables, loc_by_hex)
    for spec in (args.filter or ()):
        if "=" not in spec:
            sys.exit(f"--filter expects key=value, got {spec!r}")
        key, value = spec.split("=", 1)
        objects = [r for r in objects
                   if r.get(key) == value or str(r.get(key)) == value]
    by_site: dict = {}
    for r in objects:
        by_site.setdefault(r.get("site") or "(no call site recorded)",
                           []).append(r)
    print(f"======== {len(objects)} object(s) by creation call site "
          f"========")
    for g in state_mod.group_objects_by_site(objects):
        tasks = ", ".join(g["tasks"]) or "-"
        print(f"\n--- {g['site']}")
        print(f"    {g['count']} object(s), "
              f"{g['total_bytes'] / 1e6:.2f} MB, {g['ref_count']} ref(s), "
              f"{g['pinned']} pinned, max age {g['max_age_s']:.0f}s; "
              f"tasks: {tasks}")
        print(f"    {'OBJECT':40s} {'SIZE':>10s} {'AGE':>7s} {'STATE':8s} "
              f"{'REFS':>4s}  HOLDERS")
        rows = sorted(by_site[g["site"]],
                      key=lambda r: -(r.get("size_bytes") or 0))
        for r in rows[:args.limit]:
            holders = " -> ".join(
                f"{h.get('proc') or '?'}:{h.get('pid') or '?'}"
                + (f" ({h['task']})" if h.get("task") else "")
                for h in (r.get("holders") or ())) or "-"
            age = (f"{r['age_s']:.0f}s"
                   if r.get("age_s") is not None else "-")
            # full 40-hex ids: creator processes share an id prefix, so a
            # truncated id is ambiguous
            print(f"    {r['object_id']:40s} "
                  f"{r.get('size_bytes') or 0:>10d} {age:>7s} "
                  f"{r.get('seal_state') or '?':8s} "
                  f"{r.get('ref_count', 0):>4d}  {holders}")
        if len(rows) > args.limit:
            print(f"    ... {len(rows) - args.limit} more")
    if args.leaks:
        # GCS-lost ids keep held_lost classification alive across store
        # daemon restarts (the daemon's tombstone ring dies with it)
        lost = state_mod.lost_held_ids(
            audits, tables,
            lambda oid: _rpc(sock, "object_lost", {"oid": oid}))
        rep = state_mod.leak_report(audits, tables, args.leak_age,
                                    lost_ids=lost)
        th = rep["thresholds"]
        print(f"\n======== Leak report ({rep['checked_objects']} objects "
              f"checked, age threshold {th['age_s']:g}s) ========")
        for leak in rep["leaks"]:
            print(f"  [{leak['kind']:12s}] {leak['object_id']} "
                  f"{leak.get('size_bytes') or 0:>10d}B "
                  f"node={(leak.get('node_id') or '?')[:12]}  "
                  f"{leak['detail']}; site: {leak.get('site') or '?'}")
        if not rep["leaks"]:
            print("  (no leaks detected)")


def cmd_logs(args):
    """Task-attributed worker logs: each node's log monitor captures
    worker stdout/stderr tagged with the task executing at capture time
    (a bounded ring on the scheduler); filter by task name / task-id
    prefix (--task) or trace-id prefix (--trace)."""
    sock = find_address(args.address)
    rows = []
    for n in _rpc(sock, "list_nodes"):
        if not n["alive"]:
            continue
        try:
            part = _rpc(n["sched_socket"], "logs_search",
                        {"task": args.task or "", "trace": args.trace or "",
                         "limit": args.limit})
        except Exception:
            continue
        for r in part:
            if isinstance(r.get("node"), bytes):
                r["node"] = r["node"].hex()
        rows.extend(part)
    rows.sort(key=lambda r: r.get("ts") or 0.0)
    rows = rows[-args.limit:]
    if not rows:
        what = " matching the filter" if (args.task or args.trace) else ""
        print(f"(no captured worker log lines{what})")
        return
    for r in rows:
        when = time.strftime("%H:%M:%S", time.localtime(r.get("ts") or 0))
        stream = "!" if r.get("stream") == "stderr" else " "
        print(f"{when} {(r.get('node') or '?')[:8]} {r['worker']:>14s} "
              f"{r.get('task') or '-':<20s}{stream} {r['line']}")


def cmd_stack(args):
    """Print live thread stacks of every runtime process on every node
    (reference: `ray stack` shells out to py-spy; here the profiler
    control plane returns the stacks to the caller — each worker services
    dump requests on a dedicated connection, so even a worker busy inside
    a task answers with where it is stuck)."""
    sock = find_address(args.address)
    for n in _rpc(sock, "list_nodes"):
        if not n["alive"]:
            continue
        nid = n["node_id"].hex()[:12]
        try:
            entries = _rpc(n["sched_socket"], "profile_dump")
        except Exception as e:  # noqa: BLE001
            print(f"node {nid}: unreachable: {e}")
            continue
        print(f"======== node {nid} ({len(entries)} processes) ========")
        for ent in entries:
            who = f"pid {ent.get('pid')}"
            wid = ent.get("worker_id")
            who += f" worker {wid[:12]}" if wid else " (scheduler/driver)"
            print(f"---- {who} ----")
            print(ent.get("text", ""))


def _gather_events(sock: str) -> list:
    """All task events across live nodes (node_id attached)."""
    events = []
    for n in _rpc(sock, "list_nodes"):
        if not n["alive"]:
            continue
        try:
            evs = _rpc(n["sched_socket"], "list_task_events")
        except Exception:
            continue
        for e in evs:
            e["node_id"] = n["node_id"]
        events.extend(evs)
    return events


def cmd_timeline(args):
    from ray_tpu_torch.util.state import events_to_chrome_trace

    sock = find_address(args.address)
    events = events_to_chrome_trace(_gather_events(sock))
    out = args.output or f"timeline-{time.strftime('%H%M%S')}.json"
    with open(out, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {out} "
          f"(open in chrome://tracing or Perfetto)")


def cmd_trace(args):
    """List distributed traces, or print one trace's cluster-wide span
    tree + critical-path summary (reference: OpenTelemetry-style tracing;
    our spans live on each node's scheduler, assembled here)."""
    from ray_tpu_torch.util import tracing

    sock = find_address(args.address)

    def _fanout(method, params=None):
        out = []
        for n in _rpc(sock, "list_nodes"):
            if not n["alive"]:
                continue
            try:
                out.extend(_rpc(n["sched_socket"], method, params))
            except Exception:
                continue
        return out

    if not args.trace_id:
        rows: dict = {}
        for r in _fanout("list_traces"):
            agg = rows.get(r["trace_id"])
            if agg is None:
                rows[r["trace_id"]] = dict(r)
            else:
                agg["num_spans"] += r["num_spans"]
                agg["first_ts"] = min(agg["first_ts"], r["first_ts"])
                agg["last_ts"] = max(agg["last_ts"], r["last_ts"])
                if not agg.get("root"):
                    agg["root"] = r.get("root")
        print("======== Traces ========")
        for r in sorted(rows.values(), key=lambda r: r["last_ts"],
                        reverse=True):
            age = time.time() - r["last_ts"]
            print(f"  {r['trace_id']}  spans={r['num_spans']:<5d} "
                  f"root={r.get('root') or '?':30s} {age:7.1f}s ago")
        if not rows:
            print("  (none — submit work under "
                  "ray_tpu_torch.util.tracing.enable_tracing())")
        return

    spans = _fanout("get_trace_spans", {"trace_id": args.trace_id})
    trace = tracing.assemble_trace(args.trace_id, spans)
    if not trace["spans"]:
        sys.exit(f"no spans found for trace {args.trace_id}")
    if args.output:
        tracing.export_trace_chrome_trace(trace, args.output)
        print(f"wrote {len(trace['spans'])} spans to {args.output} "
              f"(open in Perfetto; cross-process flow arrows included)")
        return
    print(f"======== Trace {args.trace_id} ========")

    def walk(node, depth):
        dur = ((node["end_ts"] or 0) - (node["start_ts"] or 0)) * 1e3
        where = f"{node.get('node', '?')[:8]}/pid{node.get('pid', '?')}"
        flag = "" if node.get("ok", True) else "  [FAILED]"
        print(f"  {'  ' * depth}{node['name']:<{max(1, 40 - 2 * depth)}s} "
              f"{dur:9.2f}ms  {where}{flag}")
        for c in node.get("children", ()):
            walk(c, depth + 1)

    for root in trace["tree"]:
        walk(root, 0)
    s = trace["summary"]
    print(f"spans={s['num_spans']} processes={s['num_processes']} "
          f"wall={s['wall_s'] * 1e3:.2f}ms")
    print(f"critical path: queue-wait={s['queue_wait_s'] * 1e3:.2f}ms "
          f"arg-fetch={s['arg_fetch_s'] * 1e3:.2f}ms "
          f"run={s['run_s'] * 1e3:.2f}ms")
    for hop in s["critical_path"]:
        print(f"  -> {hop['name']:<38s} "
              f"queue={hop['queue_wait_s'] * 1e3:8.2f}ms "
              f"run={hop['run_s'] * 1e3:8.2f}ms")


def cmd_profile(args):
    """Cluster-wide CPU profiling: list known profiles, record a new
    high-rate capture (--record SECONDS), print a profile's top
    functions, or export it as a speedscope/folded flamegraph (-o)."""
    from ray_tpu_torch._private import profiling

    sock = find_address(args.address)
    nodes = [n for n in _rpc(sock, "list_nodes") if n["alive"]]
    profile_id = args.profile_id
    if args.record:
        profile_id = profile_id or f"prof-{os.urandom(4).hex()}"
        procs = 0
        for n in nodes:
            try:
                r = _rpc(n["sched_socket"], "profile_start",
                         {"profile_id": profile_id, "hz": args.hz})
                procs += 1 + r.get("workers", 0)
            except Exception:
                continue
        print(f"recording {profile_id} at {args.hz:g} Hz across "
              f"{len(nodes)} node(s) / {procs} process(es) "
              f"for {args.record:g}s ...")
        time.sleep(args.record)
        for n in nodes:
            try:
                _rpc(n["sched_socket"], "profile_stop",
                     {"profile_id": profile_id})
            except Exception:
                continue

    def _fanout(method, params=None):
        out = []
        for n in nodes:
            try:
                r = _rpc(n["sched_socket"], method, params)
            except Exception:
                continue
            out.extend(r if isinstance(r, list) else [r])
        return out

    if not profile_id:
        rows = profiling.merge_profile_rows(_fanout("list_profiles"))
        print("======== Profiles ========")
        for r in rows:
            dur = (r.get("t1") or 0) - (r.get("t0") or 0)
            tasks = ", ".join(r.get("tasks") or ()) or "-"
            print(f"  {r['profile_id']:24s} samples={r['samples']:<7d} "
                  f"span={dur:7.1f}s tasks: {tasks[:60]}")
        if not rows:
            print("  (none yet — the continuous profiler flushes every "
                  "few seconds; or record one with --record 5)")
        return

    prof = profiling.merge_profiles(
        _fanout("get_profile", {"profile_id": profile_id}))
    if prof is None:
        sys.exit(f"no profile {profile_id!r} on any node")
    if args.output:
        if args.output.endswith((".folded", ".txt")):
            with open(args.output, "w") as f:
                f.write(profiling.profile_to_folded(prof))
            print(f"wrote folded stacks to {args.output} "
                  f"(flamegraph.pl or speedscope load it)")
        else:
            with open(args.output, "w") as f:
                json.dump(profiling.profile_to_speedscope(prof), f)
            print(f"wrote speedscope JSON to {args.output} "
                  f"(open at https://www.speedscope.app)")
        return
    print(f"======== Profile {profile_id} ========")
    tasks = sorted({g['task'] for g in prof['stacks']
                    if g.get('task') and not g['task'].startswith('thread:')})
    print(f"samples={prof['samples']} "
          f"span={(prof['t1'] or 0) - (prof['t0'] or 0):.1f}s "
          f"nodes={len(prof.get('nodes') or ())} "
          f"tasks: {', '.join(tasks) or '-'}")
    print(f"top {args.top} functions by leaf samples:")
    for row in profiling.top_functions(prof, args.top):
        print(f"  {row['fraction'] * 100:5.1f}%  {row['count']:>7d}  "
              f"{row['frame']}")


def cmd_goodput(args):
    """Training goodput/step anatomy: list instrumented runs, or print one
    run's per-step anatomy split and badput table (records banked per node
    by GoodputTracker pushes, merged here — see ray_tpu_torch/util/goodput.py)."""
    from ray_tpu_torch.util import goodput as goodput_mod

    sock = find_address(args.address)
    nodes = [n for n in _rpc(sock, "list_nodes") if n["alive"]]

    def _fanout(method, params=None):
        out = []
        for n in nodes:
            try:
                out.extend(_rpc(n["sched_socket"], method, params))
            except Exception:
                continue
        return out

    if not args.run:
        rows = goodput_mod.merge_goodput_rows(_fanout("list_goodput"))
        print("======== Goodput runs ========")
        for r in rows:
            age = time.time() - (r.get("ts") or 0)
            gf = r.get("goodput_fraction") or 0.0
            mfu = r.get("mfu")
            tok = r.get("tokens_per_sec_steady")
            extras = ""
            if mfu is not None:
                extras += f"mfu={mfu:.3f} "
            if tok:
                extras += f"tok/s={tok:,.0f} "
            print(f"  {r['run']:24s} steps={r.get('steps') or 0:<6d} "
                  f"goodput={gf * 100:5.1f}% {extras}{age:7.1f}s ago")
        if not rows:
            print("  (none — instrument a loop with "
                  "ray_tpu_torch.util.goodput.GoodputTracker)")
        return

    rec = goodput_mod.merge_records(
        _fanout("get_goodput", {"run": args.run}))
    if rec is None:
        sys.exit(f"no goodput records for run {args.run!r}")
    s = rec["summary"]
    print(f"======== Goodput: {rec['run']} ========")
    print(f"sources={rec['num_sources']} steps={s['steps']} "
          f"restarts={s['restarts']} elapsed={s['elapsed_s']:.2f}s "
          f"compile={s['compile_s']:.2f}s")
    tok = s.get("tokens_per_sec_steady")
    if tok:
        print(f"steady-state throughput: {tok:,.0f} tok/s "
              f"(post-warmup steps only)")
    if s.get("mfu") is not None:
        print(f"mfu: {s['mfu']:.3f} (counted flops per MFU_PROFILE.md)")
    print("---- wall-time attribution (sums to elapsed) ----")
    for name in goodput_mod.BUCKETS:
        sec = s["buckets"].get(name, 0.0)
        frac = s["fractions"].get(name, 0.0)
        bar = "#" * int(round(frac * 40))
        print(f"  {name:10s} {sec:9.2f}s {frac * 100:5.1f}%  {bar}")
    anatomy = s.get("anatomy") or {}
    if anatomy:
        print("---- per-step anatomy (recent steps) ----")
        print(f"  {'phase':10s} {'mean':>9s} {'p50':>9s} {'p90':>9s}")
        for phase in (*goodput_mod.PHASES, "total"):
            a = anatomy.get(phase)
            if not a or (phase != "total" and not a.get("mean_ms")):
                continue
            print(f"  {phase:10s} {a['mean_ms']:8.1f}ms {a['p50_ms']:8.1f}ms "
                  f"{a['p90_ms']:8.1f}ms")


_SEV_MARK = {"info": " ", "warning": "!", "error": "E", "critical": "C"}


def cmd_events(args):
    """Cluster incident timeline: every node's banked event-plane records
    (store restarts, replica deaths, chaos injections, spill/scale
    decisions, SLO alert transitions) merged and time-ordered, each with
    its trace link when the incident happened under a trace."""
    sock = find_address(args.address)
    nodes = [n for n in _rpc(sock, "list_nodes") if n["alive"]]
    rows = []
    for n in nodes:
        try:
            rows.extend(_rpc(n["sched_socket"], "list_events", {
                "kind": args.kind or "", "severity": args.severity or "",
                "limit": args.limit}))
        except Exception:
            continue
    rows.sort(key=lambda e: e.get("ts", 0.0))
    rows = rows[-args.limit:]
    print(f"======== Cluster events ({len(rows)}) ========")
    for ev in rows:
        ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
        mark = _SEV_MARK.get(ev.get("severity", "info"), "?")
        trace = ev.get("trace_id") or ""
        link = f"  trace={trace[:16]}" if trace else ""
        node = (ev.get("node_id") or "")[:8]
        msg = ev.get("message") or ""
        data = ev.get("data") or {}
        corr = data.get("correlated_event")
        extra = (f"  <- {corr['kind']}@{corr.get('node_id', '')[:8]}"
                 if corr else "")
        count = data.get("count")
        if count and count > 1:
            msg += f" (x{count})"
        print(f"  {ts} {mark} {ev.get('kind', '?'):22s} "
              f"[{node}] {msg}{extra}{link}")
    if not rows:
        print("  (none)")


def cmd_slo(args):
    """SLO rule table: objective, current value, fast/slow burn rates,
    firing state (served by the head's sampler; see _private/slo.py for
    the rule grammar and RTPU_SLO_RULES)."""
    sock = find_address(args.address)
    heads = [n for n in _rpc(sock, "list_nodes")
             if n["alive"] and n["is_head"]]
    if not heads:
        sys.exit("no alive head node")
    try:
        status = _rpc(heads[0]["sched_socket"], "slo_status")
    except RuntimeError as e:
        sys.exit(str(e))
    healthy = "HEALTHY" if status.get("healthy") else "BURNING"
    print(f"======== SLOs: {healthy} "
          f"(sampled every {status.get('sample_s', '?')}s) ========")
    print(f"  {'rule':22s} {'objective':44s} {'value':>10s} "
          f"{'fast':>7s} {'slow':>7s}  state")
    for r in status.get("rules", []):
        val = "-" if r["value"] is None else f"{r['value']:.4g}"
        state = "FIRING" if r["firing"] else "ok"
        if r["firing"] and r.get("since"):
            state += f" {time.time() - r['since']:.0f}s"
        if r.get("fired_total"):
            state += f" (fired {r['fired_total']}x)"
        print(f"  {r['rule']:22s} {r['objective']:44s} {val:>10s} "
              f"{r['burn_fast']:7.2f} {r['burn_slow']:7.2f}  {state}")
    if getattr(args, "explain", False):
        explained = [r for r in status.get("rules", [])
                     if r.get("attribution")]
        print("======== burn attribution ========")
        if not explained:
            print("  (no attributed fires yet — attribution is stamped "
                  "when a serving-latency rule fires)")
        for r in explained:
            a = r["attribution"]
            print(f"  {r['rule']}: verdict={a.get('verdict', '?')} "
                  f"({a.get('traces', 0)} traced request(s) in window)")
            phases = a.get("phases") or {}
            for phase in ("queue", "kv_pull", "prefill", "decode"):
                if phase not in phases:
                    continue
                frac = float(phases[phase])
                bar = "#" * int(round(frac * 40))
                print(f"    {phase:9s} {frac * 100:5.1f}%  {bar}")
            for tid in a.get("exemplar_trace_ids") or ():
                print(f"    exemplar trace={tid}")


def cmd_top(args):
    """Live windowed view over the head TSDB: one judged row per metric
    family — counters as rates, histograms as rate + p50/p90, gauges as
    latest/mean — over the last --window seconds."""
    sock = find_address(args.address)
    heads = [n for n in _rpc(sock, "list_nodes")
             if n["alive"] and n["is_head"]]
    if not heads:
        sys.exit("no alive head node")
    try:
        rows = _rpc(heads[0]["sched_socket"], "tsdb_overview",
                    {"window_s": args.window})
        stats = _rpc(heads[0]["sched_socket"], "tsdb_stats")
    except RuntimeError as e:
        sys.exit(str(e))
    print(f"======== rtpu top (window {args.window:g}s; "
          f"{stats['series']} series, {stats['points']} points, "
          f"~{stats['approx_bytes'] // 1024}KiB) ========")
    print(f"  {'family':38s} {'kind':9s} {'value':>12s}  detail")
    for row in rows:
        fam, kind = row["family"], row["kind"]
        if args.family and not fam.startswith(args.family):
            continue
        if kind == "counter":
            rate = row.get("rate")
            val = "-" if rate is None else f"{rate:.3f}/s"
            by = row.get("by") or {}
            detail = " ".join(f"{k}={v:g}/s" for k, v in
                              list(by.items())[:3] if k != "-")
        elif kind == "histogram":
            rate = row.get("rate")
            val = "-" if rate is None else f"{rate:.3f}/s"
            p50, p90 = row.get("p50"), row.get("p90")
            detail = (f"p50={p50:.4g} p90={p90:.4g}"
                      if p50 is not None and p90 is not None else "")
        else:
            v = row.get("value")
            val = "-" if v is None else f"{v:.4g}"
            mean = row.get("mean")
            detail = f"mean={mean:.4g}" if mean is not None else ""
        print(f"  {fam:38s} {kind:9s} {val:>12s}  {detail}")
    if not rows:
        print("  (TSDB empty — is the head sampler on? "
              "RTPU_TSDB_SAMPLE_S must be > 0)")


def cmd_comm(args):
    """Analytic per-axis collective-volume estimate for a dense LM step
    (ray_tpu_torch/parallel/comm.py) — the link-rate comm bound, no
    cluster needed."""
    from ray_tpu_torch.parallel import comm

    if args.model:
        preset = comm.MODEL_PRESETS.get(args.model)
        if preset is None:
            sys.exit(f"unknown model {args.model!r}; one of "
                     f"{sorted(comm.MODEL_PRESETS)}")
        cfg = dict(preset)
    else:
        cfg = {}
    overrides = {"n_params": args.params, "n_layers": args.layers,
                 "d_model": args.d_model, "d_kv": args.d_kv,
                 "batch": args.batch, "seq": args.seq}
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    missing = [k for k in ("n_params", "n_layers", "d_model", "batch",
                           "seq") if not cfg.get(k)]
    if missing:
        sys.exit(f"missing {missing}; pass --model PRESET or the explicit "
                 f"flags")
    axes = comm.parse_mesh(args.mesh)
    events = comm.estimate_train_comm(
        axes, n_params=cfg["n_params"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], batch=cfg["batch"], seq=cfg["seq"],
        dtype_bytes=args.dtype_bytes, d_kv=cfg.get("d_kv"))
    total_dev = comm.mesh_total(axes)
    print(f"======== Comm volume: {args.model or 'custom'} on "
          f"mesh {axes} ({total_dev} devices) ========")
    print(f"params={cfg['n_params']:,} batch={cfg['batch']} "
          f"seq={cfg['seq']} dtype_bytes={args.dtype_bytes}")
    if not events:
        print("  (no collective traffic: every parallel axis has size 1)")
        return
    print(f"  {'axis':5s} {'op':15s} {'what':12s} {'events':>7s} "
          f"{'MB/event':>9s} {'MB/step/dev':>12s}")
    for ev in events:
        print(f"  {ev.axis:5s} {ev.op:15s} {ev.what:12s} "
              f"{ev.events_per_step:7d} "
              f"{ev.bytes_per_event / 1e6:9.2f} "
              f"{ev.bytes_per_step / 1e6:12.2f}")
    if args.ici_gbps is None:
        args.ici_gbps = comm.DEFAULT_ICI_GBPS
    if args.dcn_gbps is None:
        args.dcn_gbps = comm.DEFAULT_DCN_GBPS
    s = comm.summarize(events, ici_gbps=args.ici_gbps,
                       dcn_gbps=args.dcn_gbps)
    print("---- per-axis totals (per device per step) ----")
    for axis, nbytes in sorted(s.per_axis_bytes.items()):
        rate = args.dcn_gbps if axis == "dcn" else args.ici_gbps
        print(f"  {axis:5s} {nbytes / 1e6:10.2f} MB  "
              f"-> {s.per_axis_seconds[axis] * 1e3:8.2f} ms "
              f"@ {rate:g} GB/s")
    print(f"total {s.total_bytes / 1e6:10.2f} MB; serialized lower bound "
          f"{s.bound_seconds * 1e3:.2f} ms/step")


def cmd_summary(args):
    from ray_tpu_torch.util.state import summarize_events

    sock = find_address(args.address)
    summary = summarize_events(_gather_events(sock))
    print("======== Task summary ========")
    for name, states in sorted(summary.items()):
        line = " ".join(f"{k}={v}" for k, v in sorted(states.items()))
        print(f"  {name:40s} {line}")


def cmd_microbenchmark(args):
    perf.run_and_record(args)


def cmd_start(args):
    """Run a standalone (head or worker) node until signalled.

    Reference: `ray start --head` (scripts.py) — but our nodes are
    in-process services, so `start` IS the node process (no daemonizing:
    run it under systemd/tmux/&).
    """
    import signal

    import ray_tpu_torch

    if args.head:
        res = {}
        if args.resources:
            import json as _json

            res.update({k: float(v)
                        for k, v in _json.loads(args.resources).items()})
        if args.num_cpus is not None:
            res["CPU"] = float(args.num_cpus)
        if args.num_gpus is not None:
            res["GPU"] = float(args.num_gpus)
        from ray_tpu_torch._private.node import Node as _Node

        labels = None
        if args.labels:
            import json as _json

            labels = _json.loads(args.labels)
        head_node = _Node(
            head=True, resources=res or None,
            min_workers=args.min_workers, labels=labels,
            node_id=(bytes.fromhex(args.node_id) if args.node_id else None))
        node = ray_tpu_torch.init(_existing_node=head_node)
        print(f"head node started\n  gcs address: {node.gcs_address}\n"
              f"  attach with: ray_tpu_torch.init(address={node.gcs_address!r}) "
              f"or RAY_TPU_ADDRESS", flush=True)
        if args.client_server_port is not None:
            from ray_tpu_torch.util.client import ClientServer

            cs = ClientServer(host=args.client_server_host,
                              port=args.client_server_port)
            print(f"  client server: {cs.address}", flush=True)
    else:
        from ray_tpu_torch._private.node import Node

        address = args.address or "auto"
        if address == "auto":
            from ray_tpu_torch.api import _find_gcs_address

            address = _find_gcs_address()
        res = {}
        if args.resources:
            import json as _json

            res.update({k: float(v)
                        for k, v in _json.loads(args.resources).items()})
        if args.num_cpus is not None:
            res["CPU"] = float(args.num_cpus)
        if args.num_gpus is not None:
            res["GPU"] = float(args.num_gpus)
        labels = None
        if args.labels:
            import json as _json

            labels = _json.loads(args.labels)
        node = Node(head=False, gcs_address=address,
                    resources=res or None, min_workers=args.min_workers,
                    node_id=(bytes.fromhex(args.node_id)
                             if args.node_id else None),
                    labels=labels,
                    # --resources declares the node's EXACT shape (used by
                    # the autoscaler so planned == actual)
                    merge_default_resources=not args.resources)
        print(f"worker node {node.node_id.hex()[:8]} joined {address}",
              flush=True)
    node.scheduler.allow_external_shutdown = True  # `rtpu stop` may kill us
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    if args.head:
        ray_tpu_torch.shutdown()
    else:
        node.shutdown()


def cmd_stop(args):
    """Terminate every live local session (reference: `ray stop`)."""
    from ray_tpu_torch._private.node import live_session_sockets

    stopped = 0
    for sock in live_session_sockets():
        try:
            if _rpc(sock, "shutdown_node"):  # False = in-process driver node
                stopped += 1
        except Exception:
            continue
    print(f"signalled {stopped} node(s)")


def cmd_job(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(args.address)
    if args.job_command == "submit":
        if args.entrypoint and args.entrypoint[0] == "--":
            args.entrypoint = args.entrypoint[1:]  # REMAINDER keeps the --
        runtime_env = {}
        if args.working_dir:
            runtime_env["working_dir"] = args.working_dir
        sub_id = client.submit_job(
            entrypoint=" ".join(args.entrypoint),
            runtime_env=runtime_env or None)
        print(sub_id)
        if args.wait:
            status = client.wait_until_finished(sub_id)
            print(client.get_job_logs(sub_id), end="")
            print(f"status: {status}")
    elif args.job_command == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_command == "logs":
        print(client.get_job_logs(args.submission_id), end="")
    elif args.job_command == "stop":
        print("stopped" if client.stop_job(args.submission_id)
              else "not running")
    elif args.job_command == "list":
        for info in client.list_jobs():
            print(f"{info.submission_id:28s} {info.status:10s} "
                  f"{info.entrypoint}")


def cmd_data(args):
    """Data-service jobs: list / describe / scale.  Reads the coordinator's
    GCS KV status snapshots; scale writes a data_ctl command record the
    coordinator's pump applies within ~a second (the CLI has no driver
    context, so it cannot call the coordinator actor directly)."""
    sock = find_address(args.address)

    def _snapshots():
        out = []
        for key in _rpc(sock, "kv_keys", {"namespace": "data_jobs"}) or []:
            blob = _rpc(sock, "kv_get", {"namespace": "data_jobs",
                                         "key": bytes(key)})
            if blob is None:
                continue
            try:
                out.append(json.loads(bytes(blob).decode()))
            except (ValueError, UnicodeDecodeError):
                continue
        return sorted(out, key=lambda j: j.get("name", ""))

    if args.data_command == "list":
        jobs = _snapshots()
        if not jobs:
            print("(no data jobs — register one with "
                  "ray_tpu_torch.data.service.register)")
            return
        print(f"{'NAME':20s} {'STATE':8s} {'SPLITS':>6s} {'WORKERS':>7s} "
              f"{'EPOCH':>5s} {'ROWS/S':>9s} {'CACHE':>6s} {'FAILOVERS':>9s}")
        for j in jobs:
            cache = j.get("cache", {})
            hit_rate = cache.get("hit_rate")
            print(f"{j['name']:20s} {j['state']:8s} "
                  f"{j['num_splits']:6d} {len(j.get('workers', [])):7d} "
                  f"{j.get('epoch', 0):5d} {j.get('rows_per_s', 0):9.1f} "
                  f"{('%.0f%%' % (hit_rate * 100)) if hit_rate is not None else '-':>6s} "
                  f"{j.get('failovers', 0):9d}")
    elif args.data_command == "describe":
        jobs = [j for j in _snapshots() if j["name"] == args.job]
        if not jobs:
            sys.exit(f"unknown data job {args.job!r}")
        print(json.dumps(jobs[0], indent=2, default=str))
    elif args.data_command == "scale":
        cmd = {"job": args.job, "ts": time.time()}
        if args.min is not None:
            cmd["min"] = args.min
        if args.max is not None:
            cmd["max"] = args.max
        if len(cmd) == 2:
            sys.exit("data scale: pass --min and/or --max")
        _rpc(sock, "kv_put", {"namespace": "data_ctl",
                              "key": args.job.encode(),
                              "value": json.dumps(cmd).encode()})
        print(f"scale request submitted for {args.job!r}: "
              f"{ {k: v for k, v in cmd.items() if k in ('min', 'max')} } "
              f"(coordinator applies it within ~1s)")


def cmd_serve(args):
    """Serve routing stats: per-deployment router policy, replica queue
    depths and engine prefix-cache/paging state, read from the controller's
    GCS KV snapshots (namespace serve_routing) — works without a driver
    context, like `rtpu data`."""
    sock = find_address(args.address)

    def _snapshots():
        out = []
        for key in _rpc(sock, "kv_keys",
                        {"namespace": "serve_routing"}) or []:
            blob = _rpc(sock, "kv_get", {"namespace": "serve_routing",
                                         "key": bytes(key)})
            if blob is None:
                continue
            try:
                out.append(json.loads(bytes(blob).decode()))
            except (ValueError, UnicodeDecodeError):
                continue
        return sorted(out, key=lambda d: (d.get("app", ""),
                                          d.get("deployment", "")))

    docs = _snapshots()
    if getattr(args, "json", False):
        print(json.dumps(docs, indent=2, default=str))
        return
    if not docs:
        print("(no serve deployments — the controller publishes routing "
              "snapshots once an app is deployed)")
        return
    print(f"{'APP':12s} {'DEPLOYMENT':24s} {'POLICY':13s} {'REPLICAS':>8s} "
          f"{'QUEUE':>5s} {'HIT%':>5s} {'PREEMPT':>7s} {'EVICT':>6s} "
          f"{'SAVED':>8s} {'COW':>5s}")
    for d in docs:
        reps = d.get("replicas", {}) or {}
        queue = sum(r.get("queue_len", 0) or 0 for r in reps.values())
        engines = [r.get("engine") for r in reps.values() if r.get("engine")]
        rates = [e["prefix_hit_rate"] for e in engines
                 if e.get("prefix_hit_rate") is not None]
        preempt = sum(e.get("preempted") or 0 for e in engines)
        evict = sum(e.get("page_evictions") or 0 for e in engines)
        saved = sum(e.get("prefill_tokens_saved") or 0 for e in engines)
        cow = sum(e.get("cow_copies") or 0 for e in engines)
        print(f"{d.get('app', ''):12s} {d.get('deployment', ''):24s} "
              f"{d.get('policy', 'pow2'):13s} "
              f"{d.get('running_replicas', 0)}/"
              f"{d.get('target_replicas', 0):<6} "
              f"{queue:5d} "
              f"{('%.0f' % (max(rates) * 100)) if rates else '-':>5s} "
              f"{preempt:7d} {evict:6d} {saved:8d} {cow:5d}")


def cmd_check(args):
    """Static analysis (`rtpu check`): cross-language drift, lock-order,
    hot-path purity, metrics-naming, sharding-layout and wire-protocol
    passes over the port's tree.  No torch or JAX import and no cluster,
    so it runs anywhere in a few seconds."""
    from ray_tpu_torch._private import staticcheck

    forward = []
    if args.passes_csv:
        forward.append(args.passes_csv)
    if args.root:
        forward += ["--root", args.root]
    for name in args.passes or []:
        forward += ["--pass", name]
    if args.json:
        forward.append("--json")
    if args.no_allowlist:
        forward.append("--no-allowlist")
    raise SystemExit(staticcheck.main(forward))


def main(argv=None):
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name, fn in [("status", cmd_status),
                     ("stack", cmd_stack), ("summary", cmd_summary)]:
        sp = sub.add_parser(name)
        sp.add_argument("--address", default=None)
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("memory")
    sp.add_argument("--address", default=None)
    sp.add_argument("--filter", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="keep objects whose rendered field equals VALUE "
                         "(same key=value filters as list_tasks); "
                         "repeatable")
    sp.add_argument("--limit", type=int, default=10,
                    help="object rows shown per call-site group")
    sp.add_argument("--leaks", action="store_true",
                    help="append the leak report (unreferenced bytes, "
                         "age outliers, refs on evicted objects)")
    sp.add_argument("--leak-age", type=float, default=None,
                    help="age-outlier threshold seconds "
                         "(default RTPU_LEAK_AGE_S)")
    sp.set_defaults(fn=cmd_memory)
    sp = sub.add_parser("logs")
    sp.add_argument("--address", default=None)
    sp.add_argument("--task", default=None,
                    help="task name or task-id hex prefix to filter by")
    sp.add_argument("--trace", default=None,
                    help="trace-id hex prefix to filter by")
    sp.add_argument("--limit", type=int, default=1000)
    sp.set_defaults(fn=cmd_logs)
    sp = sub.add_parser("timeline")
    sp.add_argument("--address", default=None)
    sp.add_argument("--output", "-o", default=None)
    sp.set_defaults(fn=cmd_timeline)
    sp = sub.add_parser("trace")
    sp.add_argument("trace_id", nargs="?", default=None,
                    help="hex trace id (omit to list known traces)")
    sp.add_argument("--address", default=None)
    sp.add_argument("--output", "-o", default=None,
                    help="write the trace as a chrome-trace JSON instead "
                         "of printing the tree")
    sp.set_defaults(fn=cmd_trace)
    sp = sub.add_parser("profile")
    sp.add_argument("profile_id", nargs="?", default=None,
                    help="profile id to inspect/export (omit to list; "
                         "'continuous' is the always-on profile)")
    sp.add_argument("--address", default=None)
    sp.add_argument("--record", type=float, default=None, metavar="SECONDS",
                    help="record a new cluster-wide capture for SECONDS")
    sp.add_argument("--hz", type=float, default=99.0,
                    help="sampling rate for --record (default 99)")
    sp.add_argument("--top", type=int, default=15,
                    help="functions to show in the leaf-sample ranking")
    sp.add_argument("--output", "-o", default=None,
                    help="write the profile instead of printing: .json = "
                         "speedscope, .folded/.txt = folded stacks")
    sp.set_defaults(fn=cmd_profile)
    sp = sub.add_parser("goodput")
    sp.add_argument("run", nargs="?", default=None,
                    help="run name to inspect (omit to list known runs)")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_goodput)
    sp = sub.add_parser("events")
    sp.add_argument("--kind", default=None,
                    help='filter by kind prefix (e.g. "chaos.", "slo.")')
    sp.add_argument("--severity", default=None,
                    help="filter: info|warning|error|critical")
    sp.add_argument("--limit", type=int, default=200)
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_events)
    sp = sub.add_parser("slo")
    sp.add_argument("--explain", action="store_true",
                    help="show burn attribution for fired serving rules: "
                         "phase shares (queue/kv-pull/prefill/decode), "
                         "verdict, exemplar trace ids")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_slo)
    sp = sub.add_parser("top")
    sp.add_argument("--window", type=float, default=60.0,
                    help="aggregation window in seconds (default 60)")
    sp.add_argument("--family", default=None,
                    help="filter metric families by prefix")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_top)
    sp = sub.add_parser("comm")
    sp.add_argument("--model", default=None,
                    help="model preset (gpt2_124m, llama3_8b, "
                         "llama3_8b_dry); explicit flags override")
    sp.add_argument("--mesh", default="fsdp=8,tp=2",
                    help='axis sizes, e.g. "dcn=2,fsdp=8,tp=2"')
    sp.add_argument("--params", type=int, default=None)
    sp.add_argument("--layers", type=int, default=None)
    sp.add_argument("--d-model", type=int, default=None)
    sp.add_argument("--d-kv", type=int, default=None,
                    help="K/V width for sp ring-attention traffic "
                         "(default d_model; GQA models are smaller)")
    sp.add_argument("--batch", type=int, default=None,
                    help="GLOBAL batch size")
    sp.add_argument("--seq", type=int, default=None)
    sp.add_argument("--dtype-bytes", type=int, default=2)
    sp.add_argument("--ici-gbps", type=float, default=None,
                    help="per-axis link rate for the time bound (default "
                         "parallel/comm.py's DEFAULT_ICI_GBPS)")
    sp.add_argument("--dcn-gbps", type=float, default=None,
                    help="cross-host rate for the time bound (default "
                         "parallel/comm.py's DEFAULT_DCN_GBPS)")
    sp.set_defaults(fn=cmd_comm)
    sp = sub.add_parser("microbenchmark")
    perf.add_arguments(sp)
    sp.set_defaults(fn=cmd_microbenchmark)
    sp = sub.add_parser("start")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default=None)
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--min-workers", type=int, default=2)
    sp.add_argument("--node-id", default=None,
                    help="hex node id (autoscaler-assigned identity)")
    sp.add_argument("--labels", default=None,
                    help='static node labels as JSON, e.g. '
                         '\'{"zone": "us-central2-b"}\' '
                         '(NodeLabelSchedulingStrategy)')
    sp.add_argument("--resources", default=None,
                    help='JSON resource dict, e.g. \'{"AS_RES": 2.0}\'')
    sp.add_argument("--client-server-port", type=int, default=None,
                    help="serve remote rtpu:// drivers on this TCP port "
                         "(0 = ephemeral)")
    sp.add_argument("--client-server-host", default="127.0.0.1",
                    help="bind interface for the client server (default "
                         "loopback; 0.0.0.0 exposes it — connections are "
                         "token-authenticated, see the printed address)")
    sp.set_defaults(fn=cmd_start)
    sp = sub.add_parser("stop")
    sp.set_defaults(fn=cmd_stop)
    sp = sub.add_parser("job")
    sp.add_argument("--address", default=None)
    jsub = sp.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--working-dir", default=None)
    js.add_argument("--wait", action="store_true")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("submission_id")
    jsub.add_parser("list")
    sp.set_defaults(fn=cmd_job)
    sp = sub.add_parser("data")
    sp.add_argument("--address", default=None)
    dsub = sp.add_subparsers(dest="data_command", required=True)
    dsub.add_parser("list")
    dp = dsub.add_parser("describe")
    dp.add_argument("job")
    dp = dsub.add_parser("scale")
    dp.add_argument("job")
    dp.add_argument("--min", type=int, default=None,
                    help="worker-pool floor")
    dp.add_argument("--max", type=int, default=None,
                    help="worker-pool ceiling")
    sp.set_defaults(fn=cmd_data)
    sp = sub.add_parser("serve")
    sp.add_argument("--address", default=None)
    sp.add_argument("--json", action="store_true",
                    help="full routing snapshots as JSON")
    sp.set_defaults(fn=cmd_serve)
    sp = sub.add_parser("check")
    sp.add_argument("passes_csv", nargs="?", default=None,
                    metavar="PASSES",
                    help="comma-separated passes (e.g. 'shard,proto')")
    sp.add_argument("--root", default=None,
                    help="tree to analyze (default: this repo)")
    sp.add_argument("--pass", dest="passes", action="append",
                    choices=("drift", "locks", "purity", "metrics",
                             "shard", "proto"),
                    help="run only this pass (repeatable)")
    sp.add_argument("--no-allowlist", action="store_true",
                    help="show findings the allowlist suppresses")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output")
    sp.set_defaults(fn=cmd_check)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
