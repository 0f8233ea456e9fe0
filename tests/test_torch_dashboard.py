"""The port's dashboard (``ray_tpu_torch/dashboard/``): the Prometheus
renderer and the head's metrics sampler held to the JAX package's on the
same inputs, then one port cluster of this module serving the HTTP APIs,
its scheduler answering ``node_physical_stats`` and the TSDB methods.

``_render_prometheus`` of both packages gets the same seeded per-node
snapshots and must give the same text.  Each package's ``MetricsSampler``
ticks over the same fake node (its scheduler RPCs answered from memory):
the same TSDB reads, SLO status, pushed transitions and burn gauges.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from ray_tpu._private import tsdb as jtsdb
from ray_tpu.dashboard import head as jhead
from ray_tpu_torch._private import tsdb as ttsdb
from ray_tpu_torch.dashboard import head as thead

BOUNDS = (0.005, 0.05, 0.5)


def _snapshots(seed: int, nodes: int = 2, redeclare: bool = True):
    rng = np.random.default_rng(seed)
    out = []
    for n in range(nodes):
        rt = {"node_id": bytes([n + 1]) * 16,
              "tasks_pending": int(rng.integers(0, 9)),
              "workers": int(rng.integers(1, 9)),
              "store_used_bytes": int(rng.integers(0, 1 << 30)),
              "store_occupancy": float(rng.uniform()),
              "store_evictions_total": int(rng.integers(0, 50)),
              "resources": {"CPU": 8.0, "GPU": 1.0},
              "available": {"CPU": float(rng.integers(0, 9)), "GPU": 0.5}}
        app = []
        for p in range(int(rng.integers(1, 4))):
            hist = [float(rng.integers(0, 20)) for _ in BOUNDS] + [
                float(rng.integers(0, 3)), float(rng.uniform(0, 9))]
            app.append([
                {"name": "req_total", "kind": "counter",
                 "description": "requests\nserved", "tag_keys": ("route",),
                 "values": {("/a",): float(rng.integers(0, 99)),
                            ('/b"q',): float(rng.integers(0, 99))}},
                {"name": "queue.depth-now", "kind": "gauge",
                 "description": "depth", "tag_keys": (),
                 "values": {(): float(rng.normal())}},
                {"name": "lat_s", "kind": "histogram",
                 "description": "latency", "tag_keys": ("route",),
                 "boundaries": BOUNDS, "hist": {("/a",): hist}},
                {"name": "ray_tpu_already", "kind": "summary",
                 "description": "", "tag_keys": (), "values": {(): 1.0}}])
            if p == 1 and redeclare:
                # a conflicting redeclaration: the renderer keeps the first
                app[-1].append({"name": "lat_s", "kind": "histogram",
                                "description": "other", "tag_keys": (),
                                "boundaries": (1.0,),
                                "hist": {(): [1.0, 0.0, 1.0]}})
        out.append({"runtime": rt, "app": app, "app_sources": [
            f"w{p}" for p in range(len(app))]})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_equals_jax(seed):
    snaps = _snapshots(seed)
    text = thead._render_prometheus(snaps)
    assert text == jhead._render_prometheus(snaps)
    assert "# TYPE ray_tpu_lat_s histogram" in text
    assert "ray_tpu_queue_depth_now" in text
    assert 'route="/b\\"q"' in text


class _Node:
    def __init__(self, i):
        self.node_id = bytes([i + 1]) * 16
        self.alive = True
        self.sched_socket = f"node-{i}"
        self.is_head = i == 0


class _Gcs:
    def __init__(self, n):
        self.nodes = [_Node(i) for i in range(n)]

    def list_nodes(self):
        return self.nodes


def _fake_rpc(real, stream, pushed):
    """Scheduler RPCs to the fake nodes answered from ``stream`` (per node,
    one snapshot a tick) and recorded in ``pushed``; any other socket is
    a live cluster's (a session cluster's sampler shares the module
    function) and goes to ``real``."""
    tick = {"i": 0}

    def rpc(sock, method, params=None):
        if not sock.startswith("node-"):
            return real(sock, method, params)
        node = int(sock.split("-")[1])
        if method == "metrics_snapshot":
            return stream[tick["i"]][node]
        if method == "list_events":
            since = (params or {}).get("since_seq", 0)
            evs = [{"seq": tick["i"] + 1, "ts": float(tick["i"]),
                    "kind": "chaos.probe", "severity": "warning",
                    "trace_id": f"t{tick['i']}", "node_id": sock,
                    "message": "", "data": {}}]
            return [e for e in evs if e["seq"] > since]
        if method == "spans_window":
            return [{"name": "llm.prefill", "trace_id": f"t{tick['i']}",
                     "start_ts": 0.0, "end_ts": 0.02, "run_s": 0.02},
                    {"name": "llm.decode", "trace_id": f"t{tick['i']}",
                     "start_ts": 0.0, "end_ts": 0.01}]
        pushed.append((method, params))
        return True

    return rpc, tick


@pytest.mark.parametrize("seed", [3, 4])
def test_sampler_ticks_equal_jax(seed, monkeypatch):
    monkeypatch.setenv("RTPU_TSDB_SAMPLE_S", "3600")  # no loop ticks
    monkeypatch.setenv("RTPU_SLO_RULES",
                       "lat: p90(lat_s, 10s) < 0.01;"
                       "w: mean(node_workers, 5s) < 6")
    rng = np.random.default_rng(seed)
    stream = []
    for i in range(30):
        # no redeclared histogram: the TSDB merges a family's series in
        # set order, so with two boundary sets its quantile would depend
        # on the process's string hashes (ROADMAP.md §3)
        snaps = _snapshots(int(rng.integers(1 << 30)), redeclare=False)
        for s in snaps:  # cumulative histograms that grow
            for app in s["app"]:
                app[2]["hist"][("/a",)] = [v * (i + 1) for v in
                                           app[2]["hist"][("/a",)]]
        stream.append(snaps)
    results = []
    for mod, tsdb in ((jhead, jtsdb), (thead, ttsdb)):
        pushed = []
        rpc, tick = _fake_rpc(mod._node_rpc, stream, pushed)
        monkeypatch.setattr(mod, "_node_rpc", rpc)
        # a live session cluster's sampler is the package's global plane:
        # put it back after this one registers itself and leaves
        monkeypatch.setattr(tsdb, "_plane", tsdb.global_plane())
        sampler = mod.MetricsSampler(_Gcs(2), "node-0")
        try:
            for i in range(len(stream)):
                tick["i"] = i
                sampler.tick(now=1000.0 + i)
            results.append((
                sampler.slo_status(), sampler.tsdb_stats(),
                sampler.tsdb_overview({"window_s": 10.0}),
                sampler.query_timeseries({"family": "lat_s",
                                          "window_s": 20.0}),
                sampler.merged_events(), pushed))
        finally:
            sampler.shutdown()
    want, got = results
    assert got == want
    assert any(m == "events_push" for m, _ in got[5])
    assert any(r["firing"] for r in got[0]["rules"])


# ---------------------------------------------------------------------------
# a live port cluster

@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch as rt

    saved = {k: os.environ.get(k) for k in ("RTPU_TSDB_SAMPLE_S",
                                            "RTPU_METRICS_FLUSH_S")}
    os.environ["RTPU_TSDB_SAMPLE_S"] = "0.5"
    os.environ["RTPU_METRICS_FLUSH_S"] = "0.25"
    node = rt.init(min_workers=1, resources={"CPU": 2.0})
    try:
        yield rt, node
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def _until(fn, timeout=20.0):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.25)


def test_head_serves_metrics_and_apis(port):
    rt, node = port
    from ray_tpu_torch.util import goodput, tracing

    url = node.dashboard_url
    assert url and node.dashboard.sampler is not None
    assert "ray_tpu_torch dashboard" in _get(url + "/")
    assert any(n["is_head"] for n in json.loads(_get(url + "/api/nodes")))

    @rt.remote
    def dash_probe(x):
        return x + 1

    tracing.enable_tracing()
    try:
        with tracing.trace_span("dash-root") as root:
            assert rt.get(dash_probe.remote(1), timeout=60) == 2
    finally:
        tracing.disable_tracing()
    gp = goodput.GoodputTracker(run="dash-run", tokens_per_step=8)
    for _ in range(3):
        with gp.step() as st:
            with st.phase("compute"):
                pass
    gp.close()
    ref = rt.put(b"\x01" * 4096)

    text = _until(lambda: (lambda t: t if all(w in t for w in (
        "# TYPE ray_tpu_scheduler_task_queue_wait_s histogram",
        "ray_tpu_node_workers", "ray_tpu_train_goodput_fraction"))
        else None)(_get(url + "/metrics")))
    assert text.endswith("\n")
    rows = _until(lambda: [r for r in json.loads(_get(url + "/api/traces"))
                           if r["trace_id"] == root.trace_id])
    assert rows
    # the driver's root span flushes on its own interval, after the task's
    one = _until(lambda: (lambda t: t if t["summary"]["num_spans"] >= 2
                          else None)(json.loads(_get(
                              url + f"/api/traces?trace_id={root.trace_id}"))))
    assert len(one["tree"]) == 1 and one["tree"][0]["name"] == "dash-root"
    runs = json.loads(_get(url + "/api/goodput"))
    assert any(r["run"] == "dash-run" for r in runs)
    rec = json.loads(_get(url + "/api/goodput?run=dash-run"))
    assert rec["summary"]["steps"] == 3
    assert rec["records"][0]["peak_tflops"] == 989.0
    mem = json.loads(_get(url + "/api/memory"))
    assert mem["objects"] >= 1 and mem["groups"] and mem["nodes"], mem
    slo = json.loads(_get(url + "/api/slo"))
    assert {r["rule"] for r in slo["rules"]} >= {"llm_ttft_p90"}
    assert json.loads(_get(url + "/api/serve/routing")) == []
    series = json.loads(_get(url + "/api/timeseries?family=node_workers"))
    assert series["series"]
    del ref


def test_scheduler_answers_stats_and_tsdb_methods(port):
    """Over the head scheduler's control socket, as the CLI asks."""
    rt, node = port
    from ray_tpu_torch.util import state

    sock = node.sched_address
    s = _until(lambda: (lambda s: s if s.get("history") else None)(
        thead._node_rpc(sock, "node_physical_stats")))
    assert s["mem_total"] > 0 and "cpu_percent" in s and "disk" in s
    assert isinstance(s["workers"], list)
    agg = json.loads(_get(node.dashboard_url + "/api/node_stats"))
    assert agg["nodes"] and agg["nodes"][0]["mem_total"] > 0
    fams = _until(lambda: thead._node_rpc(sock, "query_timeseries",
                                          {})["families"])
    assert any(f["family"] == "node_workers" for f in fams)
    series = thead._node_rpc(sock, "query_timeseries",
                             {"family": "node_workers", "window_s": 60.0})
    assert series["series"][0]["points"]
    assert thead._node_rpc(sock, "tsdb_overview", {"window_s": 30.0})
    st = thead._node_rpc(sock, "tsdb_stats")
    assert st["series"] > 0 and st["points"] <= st["cap_points"]
    assert thead._node_rpc(sock, "slo_status")["sample_s"] == 0.5
    assert state.slo_status()["sample_s"] == 0.5
