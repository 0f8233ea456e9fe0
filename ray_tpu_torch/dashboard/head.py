"""Dashboard head: REST + Prometheus over the state API.

Counterpart of Ray's python/ray/dashboard/head.py:48 (aiohttp REST
aggregating GCS + per-node sources) — without the React SPA: endpoints
return JSON (the reference's own /api payloads are JSON too), plus a tiny
HTML index for humans and a /metrics Prometheus scrape target that merges
every node's runtime gauges with app metrics pushed from workers
(ray_tpu_torch.util.metrics).
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch._private import protocol

# The SPA (reference: python/ray/dashboard/client/ — a React/TS app; ours
# is a framework-free client in dashboard/client/) is served at "/"; the
# server-rendered /status page stays for curl/noscript use.
_CLIENT_DIR = os.path.join(os.path.dirname(__file__), "client")

_INDEX_HTML = """<!doctype html><title>ray_tpu_torch dashboard API</title>
<h1>ray_tpu_torch dashboard API</h1>
<ul>
<li><a href="/">/ (dashboard SPA)</a></li>
<li><a href="/status">/status (server-rendered cluster page)</a></li>
<li><a href="/api/nodes">/api/nodes</a></li>
<li><a href="/api/node_stats">/api/node_stats</a></li>
<li><a href="/api/actors">/api/actors</a></li>
<li><a href="/api/placement_groups">/api/placement_groups</a></li>
<li><a href="/api/jobs">/api/jobs</a></li>
<li><a href="/api/tasks/summary">/api/tasks/summary</a></li>
<li><a href="/api/cluster_status">/api/cluster_status</a></li>
<li><a href="/api/serve">/api/serve</a></li>
<li><a href="/api/serve/routing">/api/serve/routing (request-router stats: policy, queue depths, prefix-cache)</a></li>
<li><a href="/api/data/jobs">/api/data/jobs (data-service jobs; ?job=&lt;name&gt; for one)</a></li>
<li><a href="/api/traces">/api/traces (distributed traces; ?trace_id=&lt;hex&gt; for one tree)</a></li>
<li><a href="/api/profile">/api/profile (CPU profiles; ?id=&lt;profile_id&gt;&amp;format=speedscope|folded|raw)</a></li>
<li><a href="/api/goodput">/api/goodput (training goodput/step anatomy; ?run=&lt;name&gt; for one run)</a></li>
<li><a href="/api/memory">/api/memory (cluster objects by creation call site, store occupancy, leak report)</a></li>
<li><a href="/api/events">/api/events (cluster incident timeline; ?kind=&lt;prefix&gt;&amp;severity=&lt;s&gt;&amp;limit=&lt;n&gt;)</a></li>
<li><a href="/api/timeseries">/api/timeseries (metrics history ring; ?family=&lt;name&gt;&amp;window=&lt;sec&gt;)</a></li>
<li><a href="/api/slo">/api/slo (SLO rule table + burn rates)</a></li>
<li><a href="/metrics">/metrics (Prometheus)</a></li>
</ul>"""

_STATUS_CSS = """<style>
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
table{border-collapse:collapse;margin:0 0 1.5em}
th,td{border:1px solid #ccc;padding:4px 10px;text-align:left;font-size:14px}
th{background:#f0f0f0}
h2{margin-bottom:.3em}
.dead{color:#b00}.alive{color:#080}
</style>"""


class _Raw(str):
    """A cell whose HTML is intentional (everything else gets escaped)."""


def _table(headers: list, rows: list) -> str:
    import html as _html

    def cell(c):
        return c if isinstance(c, _Raw) else _html.escape(str(c))

    head = "".join(f"<th>{_html.escape(str(h))}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{cell(c)}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _node_rpc(sock: str, method: str, params: Optional[dict] = None):
    conn = protocol.connect_addr(sock)
    try:
        conn.send({"t": "rpc", "method": method, "params": params or {}})
        resp = conn.recv()
    finally:
        conn.close()
    if resp is None or not resp.get("ok"):
        raise RuntimeError(f"dashboard rpc {method} failed")
    return resp["result"]


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _help_escape(s: str) -> str:
    # HELP text escapes only backslash and line feed (exposition format)
    return s.replace("\\", "\\\\").replace("\n", "\\n")


_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    """Sanitize to the exposition-format name charset
    ([a-zA-Z_:][a-zA-Z0-9_:]*): dots/dashes become underscores."""
    name = _NAME_BAD.sub("_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _label_name(name: str) -> str:
    name = _LABEL_BAD.sub("_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _label_str(pairs) -> str:
    if not pairs:
        return ""
    return ("{" + ",".join(f'{k}="{_prom_escape(str(v))}"'
                           for k, v in pairs) + "}")


def _render_prometheus(per_node: list[dict]) -> str:
    """Valid Prometheus exposition text: one # HELP/# TYPE header per
    metric family, sanitized names, and same-name series from different
    processes/nodes MERGED (counters/histograms sum, matching what a
    single registry would report) — duplicate series are a parse error."""
    fams: dict[str, dict] = {}

    def fam(name: str, kind: str, help_: str) -> dict:
        f = fams.get(name)
        if f is None:
            f = fams[name] = {"kind": kind, "help": help_,
                              "series": {}, "hist": {}, "boundaries": None}
        return f

    def add_series(f: dict, labels: tuple, value):
        f["series"][labels] = f["series"].get(labels, 0) + value

    _NODE_GAUGES = {
        "tasks_pending": "Tasks queued on the node scheduler",
        "workers": "Alive worker processes on the node",
        "store_used_bytes": "Object store bytes in use on the node",
        "store_num_objects": "Objects resident in the node's store",
        "store_capacity_bytes": "Object store capacity on the node",
        "store_occupancy": "Object store used/capacity fraction",
        "store_fragmentation":
            "Free-space fragmentation (1 - largest_free/free)",
        "store_free_blocks": "Free-list blocks in the node's store",
        "store_largest_free_bytes":
            "Largest contiguous free block in the node's store",
        "store_evictions_total": "Objects lossily evicted (no spill copy)",
        "store_spills_total": "Objects spilled to disk under pressure",
        "store_spilled_bytes": "Bytes currently spilled to disk",
    }
    for snap in per_node:
        rt = snap["runtime"]
        node = rt["node_id"].hex()[:12]
        for key, help_ in _NODE_GAUGES.items():
            if key not in rt:  # audit gauges are best-effort per scrape
                continue
            f = fam(f"ray_tpu_node_{key}", "gauge", help_)
            # node_id makes these unique per node: set, don't sum
            f["series"][(("node_id", node),)] = rt[key]
        for res, total in rt["resources"].items():
            ft = fam("ray_tpu_resource_total", "gauge",
                     "Total resource capacity per node")
            fa = fam("ray_tpu_resource_available", "gauge",
                     "Currently available resource per node")
            lbl = (("node_id", node), ("resource", str(res)))
            ft["series"][lbl] = total
            fa["series"][lbl] = rt["available"].get(res, 0)
        # App metrics pushed by this node's processes.
        for source in snap["app"]:
            for m in source:
                name = _prom_name(m["name"])
                if not name.startswith("ray_tpu_"):
                    name = "ray_tpu_" + name
                kind = m.get("kind")
                if kind not in ("counter", "gauge", "histogram"):
                    kind = "untyped"
                f = fam(name, kind, m.get("description") or "")
                keys = tuple(_label_name(k)
                             for k in (m.get("tag_keys") or ()))
                if kind == "histogram":
                    b = tuple(m.get("boundaries") or ())
                    if f["boundaries"] is None:
                        f["boundaries"] = b
                    elif f["boundaries"] != b:
                        continue  # conflicting redeclaration: first wins
                    for tagvals, h in m.get("hist", {}).items():
                        lbl = tuple(zip(keys, tuple(tagvals)))
                        cur = f["hist"].get(lbl)
                        if cur is None:
                            f["hist"][lbl] = list(h)
                        elif len(cur) == len(h):
                            for i, c in enumerate(h):
                                cur[i] += c
                else:
                    for tagvals, v in m.get("values", {}).items():
                        add_series(f, tuple(zip(keys, tuple(tagvals))), v)

    lines: list[str] = []
    for name, f in fams.items():
        lines.append(f"# HELP {name} {_help_escape(f['help'])}")
        lines.append(f"# TYPE {name} {f['kind']}")
        if f["kind"] == "histogram":
            bounds = f["boundaries"] or ()
            for lbl, h in f["hist"].items():
                cum = 0
                for b, c in zip(bounds, h):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(lbl + (('le', b),))} {cum}")
                cum += h[len(bounds)]
                lines.append(
                    f"{name}_bucket{_label_str(lbl + (('le', '+Inf'),))}"
                    f" {cum}")
                lines.append(f"{name}_count{_label_str(lbl)} {cum}")
                lines.append(f"{name}_sum{_label_str(lbl)} {h[-1]}")
        else:
            for lbl, v in f["series"].items():
                lines.append(f"{name}{_label_str(lbl)} {v}")
    return "\n".join(lines) + "\n"


class MetricsSampler:
    """The retained-signal plane: head-side sampling thread that turns
    point-in-time scrapes into queryable history and judged health.

    Every ``RTPU_TSDB_SAMPLE_S`` it (1) polls each alive node's
    ``metrics_snapshot`` into the ring TSDB (_private/tsdb.py), (2)
    drains each node's banked cluster events (incremental, per-node seq
    cursors) into one merged incident ring, (3) runs the SLO engine's
    burn-rate tick — alert transitions are pushed back onto the event
    plane (head scheduler bank: they hit the file exporter and the rings
    like any other incident) with the nearest recent incident's trace id
    stamped on a fire, and (4) exports current burn state as the
    ``slo_burn_rate``/``slo_healthy`` gauges via a plain metrics_push.

    Registers itself as tsdb.set_global_plane so the head scheduler's
    control socket serves query_timeseries/slo_status/tsdb_overview/
    tsdb_stats to the CLI and state API without HTTP in the loop.
    """

    def __init__(self, gcs, head_sched_socket: str):
        from ray_tpu_torch._private import flags
        from ray_tpu_torch._private import slo as slo_mod
        from ray_tpu_torch._private import tsdb as tsdb_mod

        self._gcs = gcs
        self._head_sock = head_sched_socket
        self.sample_s = max(0.05, float(flags.get("RTPU_TSDB_SAMPLE_S")))
        self.tsdb = tsdb_mod.TSDB(
            points_per_series=max(2, int(flags.get("RTPU_TSDB_CAP"))),
            max_series=max(1, int(flags.get("RTPU_TSDB_MAX_SERIES"))))
        self.engine = slo_mod.SLOEngine(sample_s=self.sample_s)
        self._events: deque = deque(
            maxlen=max(1, int(flags.get("RTPU_EVENTS_CAP"))))
        self._cursors: dict[str, int] = {}  # node hex -> last seq seen
        self._lock = threading.Lock()
        self._stop = threading.Event()
        tsdb_mod.set_global_plane(self)
        self._thread = threading.Thread(
            target=self._loop, name="metrics-sampler", daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.sample_s):
            try:
                self.tick()
            except Exception:
                pass  # a sick node or mid-shutdown GCS must not kill it

    def tick(self, now: Optional[float] = None):
        now = time.time() if now is None else now
        nodes = []
        try:
            nodes = [(n.node_id.hex(), n.sched_socket)
                     for n in self._gcs.list_nodes() if n.alive]
        except Exception:
            pass
        for node_hex, sock in nodes:
            try:
                self.tsdb.ingest(_node_rpc(sock, "metrics_snapshot"), now)
            except Exception:
                pass
            try:
                evs = _node_rpc(sock, "list_events", {
                    "since_seq": self._cursors.get(node_hex, 0)})
            except Exception:
                evs = []
            if evs:
                with self._lock:
                    for ev in evs:
                        self._cursors[node_hex] = max(
                            self._cursors.get(node_hex, 0),
                            int(ev.get("seq") or 0))
                        self._events.append(ev)
        transitions = self.engine.tick(self.tsdb, now)
        for tr in transitions:
            if tr["kind"] == "slo.fire":
                self._correlate(tr)
                self._attribute(tr, nodes)
        if transitions:
            try:
                _node_rpc(self._head_sock, "events_push",
                          {"events": transitions})
            except Exception:
                pass
        # A fire can race ahead of the engines' span flush cadence: while
        # a serving rule burns without a phase decomposition, retry the
        # attribution each tick until the banked spans yield one.
        for row in self.engine.status()["rules"]:
            a = row.get("attribution")
            if row["firing"] and (a is None
                                  or a.get("verdict") == "unattributed"):
                self._attribute({"ts": now, "data": {"rule": row["rule"]}},
                                nodes)
        from ray_tpu_torch._private import slo as slo_mod

        try:
            _node_rpc(self._head_sock, "metrics_push", {
                "source": b"slo-engine",
                "metrics": slo_mod.status_metrics(self.engine.status())})
        except Exception:
            pass

    def _correlate(self, alert: dict):
        """Stamp a firing alert with the newest recent incident's trace id
        so `rtpu events` links the event->alert pair into the trace tree."""
        horizon = alert["ts"] - max(
            30.0, self.engine.fast_window(
                next((r for r in self.engine.rules
                      if r.name == alert["data"]["rule"]), None)
                or self.engine.rules[0]) * 2)
        with self._lock:
            recent = list(self._events)
        for ev in reversed(recent):
            if (ev.get("ts", 0) >= horizon
                    and ev.get("trace_id")
                    and ev.get("severity") in ("warning", "error",
                                               "critical")
                    and not str(ev.get("kind", "")).startswith("slo.")):
                alert["trace_id"] = ev["trace_id"]
                alert["data"]["correlated_event"] = {
                    "kind": ev.get("kind"), "ts": ev.get("ts"),
                    "node_id": ev.get("node_id"), "seq": ev.get("seq")}
                return

    def _attribute(self, alert: dict, nodes):
        """Burn attribution for serving-latency fires: pull every node's
        banked engine spans over the breaching window, decompose the
        latency into phase shares (queue vs cold-prefill vs kv-pull vs
        decode contention), and stamp verdict + exemplar trace ids on the
        alert — `rtpu slo --explain` replays the verdict from the engine
        state afterwards."""
        from ray_tpu_torch._private import slo as slo_mod
        from ray_tpu_torch.util import metrics as metrics_mod

        rule = next((r for r in self.engine.rules
                     if r.name == alert["data"].get("rule")), None)
        if rule is None:
            return
        if not set(rule.families()) & set(metrics_mod.EXEMPLAR_FAMILIES):
            return  # not a serving-latency objective: nothing to decompose
        since = alert["ts"] - max(rule.window_s, 30.0)
        spans: list = []
        for _node_hex, sock in nodes:
            try:
                spans.extend(_node_rpc(sock, "spans_window", {
                    "since_ts": since, "name_prefix": "llm."}))
            except Exception:
                continue
        attr = slo_mod.attribute_burn(spans)
        if attr is None:
            # no banked engine spans (sampling off, or a serving path
            # without the LLM engine): still answer "which request was
            # the p99" from the TSDB's banked histogram exemplar
            tid = self.tsdb.exemplar(rule.num.family, 0.99, rule.window_s)
            if tid is None:
                return
            attr = {"phases": {}, "verdict": "unattributed",
                    "exemplar_trace_ids": [tid], "traces": 0}
        alert["data"]["phases"] = attr["phases"]
        alert["data"]["verdict"] = attr["verdict"]
        alert["data"]["exemplar_trace_ids"] = attr["exemplar_trace_ids"]
        if not alert.get("trace_id") and attr["exemplar_trace_ids"]:
            alert["trace_id"] = attr["exemplar_trace_ids"][0]
        self.engine.note_attribution(rule.name, attr)

    # -- plane interface (scheduler control-socket delegation) -----------
    def query_timeseries(self, params: dict) -> dict:
        family = params.get("family") or ""
        window_s = float(params.get("window_s") or 300.0)
        if not family:
            return {"families": self.tsdb.families()}
        return {"family": family, "window_s": window_s,
                "series": self.tsdb.query(family, window_s)}

    def slo_status(self) -> dict:
        status = self.engine.status()
        status["sample_s"] = self.sample_s
        return status

    def tsdb_overview(self, params: dict) -> list:
        return self.tsdb.overview(float(params.get("window_s") or 60.0))

    def tsdb_stats(self) -> dict:
        return self.tsdb.stats()

    def merged_events(self, kind: str = "", severity: str = "",
                      limit: int = 500) -> list[dict]:
        with self._lock:
            ring = list(self._events)
        out = [dict(ev) for ev in ring
               if (not kind or str(ev.get("kind", "")).startswith(kind))
               and (not severity or ev.get("severity") == severity)]
        out.sort(key=lambda e: e.get("ts", 0.0))
        return out[-max(1, int(limit)):]

    def shutdown(self):
        from ray_tpu_torch._private import tsdb as tsdb_mod

        self._stop.set()
        self._thread.join(timeout=5)
        if tsdb_mod.global_plane() is self:
            tsdb_mod.set_global_plane(None)


class DashboardHead:
    """Serves on 127.0.0.1:<port> from a daemon thread with its own loop."""

    def __init__(self, gcs, head_sched_socket: str, port: int = 0):
        import aiohttp  # noqa: F401 — fail HERE, in the caller's thread

        self._gcs = gcs
        self._head_sock = head_sched_socket
        self._port = port
        self.url: Optional[str] = None
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread = threading.Thread(
            target=self._run, name="dashboard-head", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        if self.url is None:
            raise RuntimeError("dashboard server failed to start")
        # Retained-signal plane (TSDB + event ring + SLO engine); off
        # when RTPU_TSDB_SAMPLE_S <= 0.
        from ray_tpu_torch._private import flags

        self.sampler = None
        if float(flags.get("RTPU_TSDB_SAMPLE_S")) > 0:
            self.sampler = MetricsSampler(gcs, head_sched_socket)

    # -- data sources ------------------------------------------------------
    def _sched_socks(self) -> list[str]:
        return [n.sched_socket for n in self._gcs.list_nodes() if n.alive]

    def _nodes(self):
        return [{
            "node_id": n.node_id.hex(), "alive": n.alive,
            "is_head": n.is_head, "resources": n.resources,
            "available": getattr(n, "available", {}),
        } for n in self._gcs.list_nodes()]

    def _actors(self):
        return [{
            "actor_id": a.actor_id.hex(), "name": a.name,
            "class_name": a.class_name, "state": a.state,
            "node_id": a.node_id.hex() if a.node_id else None,
            "num_restarts": a.num_restarts,
        } for a in self._gcs.list_actors()]

    def _pgs(self):
        out = []
        for pg_id, info in _node_rpc(self._head_sock, "pg_table").items():
            row = {"placement_group_id": pg_id.hex(), **info}
            if "assignment" in row:
                row["assignment"] = [
                    n.hex() if isinstance(n, bytes) else n
                    for n in row["assignment"]]
            out.append(row)
        return out

    def _jobs(self):
        try:
            return _node_rpc(self._head_sock, "job_list")
        except Exception:
            return []

    def _task_summary(self):
        from ray_tpu_torch.util.state import summarize_events

        events = []
        for sock in self._sched_socks():
            try:
                events.extend(_node_rpc(sock, "list_task_events"))
            except Exception:
                continue
        return summarize_events(events)

    def _cluster_status(self):
        return _node_rpc(self._head_sock, "cluster_state")

    def _node_stats(self):
        """Aggregate every alive node's physical stats (per-node agent
        reporter — dashboard/agent.py)."""
        out = []
        for n in self._gcs.list_nodes():
            if not n.alive:
                continue
            try:
                out.append(_node_rpc(n.sched_socket, "node_physical_stats"))
            except Exception:
                continue
        return {"nodes": out}

    def _serve_status(self):
        """Best-effort Serve app/deployment status.  Works when the head
        process has a driver context (in-process clusters and `rtpu
        start` heads both do); degrades to a structured error otherwise."""
        try:
            from ray_tpu_torch.serve import api as serve_api

            return serve_api.status()
        except Exception as e:
            return {"error": f"serve not running: {type(e).__name__}"}

    def _serve_routing(self):
        """Request-router snapshots straight from the controller's GCS KV
        records (namespace serve_routing) — no driver context needed."""
        import json as json_mod

        out = []
        for key in self._gcs.kv_keys("serve_routing"):
            blob = self._gcs.kv_get("serve_routing", bytes(key))
            if blob is None:
                continue
            try:
                out.append(json_mod.loads(bytes(blob).decode()))
            except (ValueError, UnicodeDecodeError):
                continue
        return sorted(out, key=lambda d: (d.get("app", ""),
                                          d.get("deployment", "")))

    def _data_jobs(self, job: Optional[str] = None):
        """Data-service job snapshots straight from the coordinator's GCS
        KV records (namespace data_jobs) — no driver context needed."""
        import json as json_mod

        out = []
        keys = ([job.encode()] if job
                else self._gcs.kv_keys("data_jobs"))
        for key in keys:
            blob = self._gcs.kv_get("data_jobs", bytes(key))
            if blob is None:
                continue
            try:
                out.append(json_mod.loads(bytes(blob).decode()))
            except (ValueError, UnicodeDecodeError):
                continue
        if job:
            return out[0] if out else {"error": f"unknown data job {job!r}"}
        return sorted(out, key=lambda j: j.get("name", ""))

    def _job_logs(self, submission_id: str):
        try:
            return {"logs": _node_rpc(self._head_sock, "job_logs",
                                      {"submission_id": submission_id})}
        except Exception as e:
            return {"error": repr(e)}

    def _status_html(self) -> str:
        """One server-rendered, self-refreshing cluster status page
        (reference: the dashboard SPA's cluster view, rendered without the
        40k-LoC React client)."""
        nodes = self._nodes()
        totals: dict = {}
        avail: dict = {}
        for n in nodes:
            if not n["alive"]:
                continue
            for k, v in n["resources"].items():
                totals[k] = totals.get(k, 0) + v
            for k, v in n["available"].items():
                avail[k] = avail.get(k, 0) + v
        res_rows = [(k, f"{avail.get(k, 0):g}", f"{v:g}")
                    for k, v in sorted(totals.items())]
        node_rows = [(
            n["node_id"][:12],
            "head" if n["is_head"] else "worker",
            _Raw(f'<span class="{"alive" if n["alive"] else "dead"}">'
                 f'{"ALIVE" if n["alive"] else "DEAD"}</span>'),
            " ".join(f"{k}:{n['available'].get(k, 0):g}/{v:g}"
                     for k, v in sorted(n["resources"].items())),
        ) for n in nodes]
        actors = self._actors()
        actor_rows = [(a["actor_id"][:12], a["name"] or "",
                       a["class_name"], a["state"],
                       (a["node_id"] or "")[:12], a["num_restarts"])
                      for a in actors]
        by_state: dict = {}
        for a in actors:
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        task_rows = [(name, " ".join(f"{k}={v}"
                                     for k, v in sorted(states.items())))
                     for name, states in
                     sorted(self._task_summary().items())]
        jobs = self._jobs()
        job_rows = [(j.get("submission_id", ""), j.get("status", ""),
                     j.get("entrypoint", "")[:80]) for j in jobs]
        parts = [
            "<!doctype html><title>ray_tpu_torch status</title>",
            '<meta http-equiv="refresh" content="5">', _STATUS_CSS,
            "<h1>ray_tpu_torch cluster</h1>",
            f"<p>{sum(n['alive'] for n in nodes)}/{len(nodes)} nodes "
            f"alive &middot; {len(actors)} actors ("
            + " ".join(f"{k}={v}"
                       for k, v in sorted(by_state.items()))
            + ") &middot; auto-refreshes every 5s</p>",  # states are
            # framework enums; every user-controlled string renders via
            # _table, which escapes
            "<h2>Resources</h2>",
            _table(["resource", "available", "total"], res_rows),
            "<h2>Nodes</h2>",
            _table(["node", "role", "state", "resources"], node_rows),
            "<h2>Actors</h2>",
            _table(["actor", "name", "class", "state", "node",
                    "restarts"], actor_rows[:200]),
            "<h2>Tasks</h2>",
            _table(["task", "states"], task_rows[:200]),
        ]
        if job_rows:
            parts += ["<h2>Jobs</h2>",
                      _table(["job", "status", "entrypoint"], job_rows)]
        return "".join(parts)

    def _metrics_text(self):
        snaps = []
        for sock in self._sched_socks():
            try:
                snaps.append(_node_rpc(sock, "metrics_snapshot"))
            except Exception:
                continue
        return _render_prometheus(snaps)

    def _traces(self, trace_id: Optional[str] = None):
        """No trace_id: merged per-trace summary rows from every node.
        With trace_id: the assembled cluster-wide tree + critical path
        (same shape as ray_tpu_torch.util.state.get_trace)."""
        from ray_tpu_torch.util import tracing

        if trace_id:
            spans = []
            for sock in self._sched_socks():
                try:
                    spans.extend(_node_rpc(sock, "get_trace_spans",
                                           {"trace_id": trace_id}))
                except Exception:
                    continue
            return tracing.assemble_trace(trace_id, spans)
        rows: dict = {}
        for sock in self._sched_socks():
            try:
                node_rows = _node_rpc(sock, "list_traces")
            except Exception:
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
        return sorted(rows.values(), key=lambda r: r["last_ts"],
                      reverse=True)

    def _profile_rows(self):
        """Merged per-profile summary rows from every node (the always-on
        "continuous" profile plus on-demand captures)."""
        from ray_tpu_torch._private import profiling

        rows = []
        for sock in self._sched_socks():
            try:
                rows.extend(_node_rpc(sock, "list_profiles"))
            except Exception:
                continue
        return profiling.merge_profile_rows(rows)

    def _profile_get(self, profile_id: str):
        """One profile assembled cluster-wide (same shape as
        ray_tpu_torch.util.state.get_profile)."""
        from ray_tpu_torch._private import profiling

        parts = []
        for sock in self._sched_socks():
            try:
                parts.append(_node_rpc(sock, "get_profile",
                                       {"profile_id": profile_id}))
            except Exception:
                continue
        return profiling.merge_profiles(parts)

    def _goodput_rows(self):
        """Merged per-run goodput summary rows from every node."""
        from ray_tpu_torch.util import goodput as goodput_mod

        rows = []
        for sock in self._sched_socks():
            try:
                rows.extend(_node_rpc(sock, "list_goodput"))
            except Exception:
                continue
        return goodput_mod.merge_goodput_rows(rows)

    def _memory(self):
        """The `ray memory` view over HTTP: cluster objects grouped by
        creation call site + per-node store occupancy + the leak report.
        Runs through the state API, which needs a driver context — the
        head process has one (same caveat as /api/serve)."""
        try:
            from ray_tpu_torch.util.state import memory_summary

            return memory_summary()
        except Exception as e:
            return {"error": f"memory view unavailable: {e!r}"}

    def _goodput_get(self, run: str):
        """One run's records assembled cluster-wide (same shape as
        ray_tpu_torch.util.state.get_goodput)."""
        from ray_tpu_torch.util import goodput as goodput_mod

        records = []
        for sock in self._sched_socks():
            try:
                records.extend(_node_rpc(sock, "get_goodput",
                                         {"run": run}))
            except Exception:
                continue
        return goodput_mod.merge_records(records)

    def _events_rows(self, kind: str, severity: str, limit: int):
        """Merged incident timeline.  With the sampler running this is
        its (already drained + cap-bounded) ring; without it, fan in the
        per-node banks directly."""
        if getattr(self, "sampler", None) is not None:
            return self.sampler.merged_events(kind, severity, limit)
        rows = []
        for sock in self._sched_socks():
            try:
                rows.extend(_node_rpc(sock, "list_events", {
                    "kind": kind, "severity": severity, "limit": limit}))
            except Exception:
                continue
        rows.sort(key=lambda e: e.get("ts", 0.0))
        return rows[-max(1, limit):]

    def _slo_api(self):
        if getattr(self, "sampler", None) is None:
            return {"error": "SLO engine disabled (RTPU_TSDB_SAMPLE_S=0)"}
        return self.sampler.slo_status()

    def _timeseries_api(self, family: str, window_s: float):
        if getattr(self, "sampler", None) is None:
            return {"error": "TSDB disabled (RTPU_TSDB_SAMPLE_S=0)"}
        return self.sampler.query_timeseries(
            {"family": family, "window_s": window_s})

    # -- server ------------------------------------------------------------
    def _run(self):
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        def json_handler(fn):
            async def handler(request):
                data = await loop.run_in_executor(None, fn)
                return web.Response(
                    text=json.dumps(data, default=str),
                    content_type="application/json")
            return handler

        async def index(request):
            return web.Response(text=_INDEX_HTML, content_type="text/html")

        async def metrics(request):
            text = await loop.run_in_executor(None, self._metrics_text)
            return web.Response(text=text, content_type="text/plain")

        async def status_page(request):
            text = await loop.run_in_executor(None, self._status_html)
            return web.Response(text=text, content_type="text/html")

        async def logs(request):
            # /api/logs?node_id=<hex>            -> list that node's logs
            # /api/logs?node_id=<hex>&file=F&tail=N -> tail one log
            # (reference: dashboard modules/log, served per node by its
            # agent — here each node's scheduler plays the agent)
            node_hex = request.query.get("node_id", "")
            fname = request.query.get("file")
            try:
                tail = int(request.query.get("tail", "200"))
            except ValueError:
                tail = 200  # structured JSON beats a 500 on ?tail=abc

            def fetch():
                for n in self._gcs.list_nodes():
                    if n.alive and n.node_id.hex() == node_hex:
                        if fname:
                            return _node_rpc(n.sched_socket, "read_log",
                                             {"file": fname, "tail": tail})
                        return _node_rpc(n.sched_socket, "list_logs")
                if not node_hex:  # default: the head node's logs
                    if fname:
                        return _node_rpc(self._head_sock, "read_log",
                                         {"file": fname, "tail": tail})
                    return _node_rpc(self._head_sock, "list_logs")
                return {"error": f"no alive node {node_hex}"}

            data = await loop.run_in_executor(None, fetch)
            return web.Response(text=json.dumps(data, default=str),
                                content_type="application/json")

        async def spa(request):
            return web.FileResponse(os.path.join(_CLIENT_DIR, "index.html"))

        async def job_logs(request):
            sid = request.query.get("submission_id", "")
            data = await loop.run_in_executor(None, self._job_logs, sid)
            return web.Response(text=json.dumps(data, default=str),
                                content_type="application/json")

        async def profile(request):
            # /api/profile                         -> profile summary rows
            # /api/profile?id=<profile_id>         -> speedscope JSON
            # /api/profile?id=<pid>&format=folded  -> folded-stack text
            # /api/profile?id=<pid>&format=raw     -> merged profile JSON
            from ray_tpu_torch._private import profiling

            pid_ = (request.query.get("id")
                    or request.query.get("profile_id") or None)
            if pid_ is None:
                rows = await loop.run_in_executor(None, self._profile_rows)
                return web.Response(text=json.dumps(rows, default=str),
                                    content_type="application/json")
            prof = await loop.run_in_executor(None, self._profile_get, pid_)
            if prof is None:
                return web.Response(
                    text=json.dumps({"error": f"no profile {pid_}"}),
                    content_type="application/json", status=404)
            fmt = request.query.get("format") or "speedscope"
            if fmt == "folded":
                return web.Response(
                    text=profiling.profile_to_folded(prof),
                    content_type="text/plain")
            if fmt == "raw":
                return web.Response(text=json.dumps(prof, default=str),
                                    content_type="application/json")
            return web.Response(
                text=json.dumps(profiling.profile_to_speedscope(prof)),
                content_type="application/json")

        async def traces(request):
            # /api/traces                  -> per-trace summary rows
            # /api/traces?trace_id=<hex>   -> one assembled span tree
            tid = request.query.get("trace_id") or None
            data = await loop.run_in_executor(None, self._traces, tid)
            return web.Response(text=json.dumps(data, default=str),
                                content_type="application/json")

        app = web.Application()
        app.router.add_get("/api/logs", logs)
        app.router.add_get("/", spa)
        app.router.add_get("/api", index)
        app.router.add_static("/ui/", _CLIENT_DIR)
        app.router.add_get("/api/jobs/logs", job_logs)
        app.router.add_get("/api/node_stats", json_handler(self._node_stats))
        app.router.add_get("/api/serve", json_handler(self._serve_status))
        app.router.add_get("/api/serve/routing",
                           json_handler(self._serve_routing))
        app.router.add_get("/status", status_page)
        app.router.add_get("/api/nodes", json_handler(self._nodes))
        app.router.add_get("/api/actors", json_handler(self._actors))
        app.router.add_get("/api/placement_groups", json_handler(self._pgs))
        app.router.add_get("/api/jobs", json_handler(self._jobs))
        app.router.add_get("/api/tasks/summary",
                           json_handler(self._task_summary))
        app.router.add_get("/api/cluster_status",
                           json_handler(self._cluster_status))
        async def data_jobs(request):
            # /api/data/jobs              -> every job's status snapshot
            # /api/data/jobs?job=<name>   -> one job
            name = request.query.get("job") or None
            data = await loop.run_in_executor(None, self._data_jobs, name)
            return web.Response(text=json.dumps(data, default=str),
                                content_type="application/json")

        async def goodput(request):
            # /api/goodput              -> per-run summary rows
            # /api/goodput?run=<name>   -> one run merged cluster-wide
            run = request.query.get("run") or None
            if run is None:
                rows = await loop.run_in_executor(None, self._goodput_rows)
                return web.Response(text=json.dumps(rows, default=str),
                                    content_type="application/json")
            rec = await loop.run_in_executor(None, self._goodput_get, run)
            if rec is None:
                return web.Response(
                    text=json.dumps({"error": f"no goodput run {run}"}),
                    content_type="application/json", status=404)
            return web.Response(text=json.dumps(rec, default=str),
                                content_type="application/json")

        async def events(request):
            # /api/events?kind=<prefix>&severity=<s>&limit=<n>
            kind = request.query.get("kind") or ""
            severity = request.query.get("severity") or ""
            try:
                limit = int(request.query.get("limit", "500"))
            except ValueError:
                limit = 500
            rows = await loop.run_in_executor(
                None, self._events_rows, kind, severity, limit)
            return web.Response(text=json.dumps(rows, default=str),
                                content_type="application/json")

        async def timeseries(request):
            # /api/timeseries                    -> known families
            # /api/timeseries?family=F&window=N  -> in-window points
            family = request.query.get("family") or ""
            try:
                window = float(request.query.get("window", "300"))
            except ValueError:
                window = 300.0
            data = await loop.run_in_executor(
                None, self._timeseries_api, family, window)
            return web.Response(text=json.dumps(data, default=str),
                                content_type="application/json")

        app.router.add_get("/api/events", events)
        app.router.add_get("/api/timeseries", timeseries)
        app.router.add_get("/api/slo", json_handler(self._slo_api))
        app.router.add_get("/api/data/jobs", data_jobs)
        app.router.add_get("/api/traces", traces)
        app.router.add_get("/api/profile", profile)
        app.router.add_get("/api/goodput", goodput)
        app.router.add_get("/api/memory", json_handler(self._memory))
        app.router.add_get("/metrics", metrics)

        async def start():
            runner = web.AppRunner(app, access_log=None)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", self._port)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
            self.url = f"http://127.0.0.1:{port}"
            self._runner = runner
            self._started.set()

        try:
            loop.run_until_complete(start())
        except BaseException:
            self._started.set()  # unblock __init__, which raises on url=None
            loop.close()
            return
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(self._runner.cleanup())
            loop.close()

    def shutdown(self):
        if getattr(self, "sampler", None) is not None:
            self.sampler.shutdown()
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
