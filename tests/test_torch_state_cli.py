"""The port's state API and ``rtpu`` CLI (``ray_tpu_torch/util/state.py``,
``scripts/cli.py``).

The pure functions the CLI and the dashboard share (the object join, the
leak report, grouping by call site, task summaries, the chrome timeline,
trace assembly) are held to the JAX package's on the same seeded rows:
equal results.  The CLI's commands then run against one port cluster of
this module (its head sampler at 0.5 s), ``microbenchmark`` among them;
``check``, whose static checker the port has not ported, raises.
"""

import contextlib
import io
import json
import os
import time

import numpy as np
import pytest

from ray_tpu.util import state as jstate
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.util import state as tstate
from ray_tpu_torch.util import tracing as ttracing

NODES = ["a1" * 16, "b2" * 16]


def _rows(seed: int):
    """Store audits, per-process ref tables and a location directory over
    one set of object ids, drawn from a seed."""
    rng = np.random.default_rng(seed)
    oids = [f"{seed:02x}{i:030x}" for i in range(24)]
    sites = ["app.py:10", "app.py:22", "<internal>", None, "lib.py:7"]
    audits = []
    for nid in NODES:
        objs = []
        for oid in oids:
            if rng.uniform() < 0.45:
                age = float(rng.uniform(0, 60_000))
                objs.append({"id": oid, "size": int(rng.integers(0, 1 << 20)),
                             "sealed": bool(rng.uniform() < 0.9),
                             "refcount": int(rng.integers(0, 3)),
                             "spilled": bool(rng.uniform() < 0.1),
                             "age_ms": age,
                             "idle_ms": float(rng.uniform(0, age))})
        tomb = [o for o in oids if rng.uniform() < 0.15]
        audits.append({"node_id": nid, "objects": objs,
                       "tombstone_ids": tomb})
    tables = []
    for p in range(3):
        refs = []
        for oid in oids:
            if rng.uniform() < 0.4:
                refs.append({
                    "object_id": oid, "count": int(rng.integers(0, 3)),
                    "pinned": bool(rng.uniform() < 0.3),
                    "lineage": bool(rng.uniform() < 0.2),
                    "site": sites[int(rng.integers(len(sites)))],
                    "task": f"task{int(rng.integers(0, 3))}",
                    "trace_id": f"tr{int(rng.integers(0, 4))}",
                    "kind": ["local", "borrowed", "dropped"][
                        int(rng.integers(0, 3))],
                    "age_s": float(rng.uniform(0, 30))})
        tables.append({"node": NODES[p % 2], "proc": f"worker-{p}",
                       "pid": 1000 + p, "refs": refs})
    locs = {oid: [NODES[int(rng.integers(0, 2))]] for oid in oids
            if rng.uniform() < 0.5}
    return audits, tables, locs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_rows_and_groups_equal_jax(seed):
    audits, tables, locs = _rows(seed)
    want = jstate.merge_object_rows(audits, tables, locs)
    got = tstate.merge_object_rows(audits, tables, locs)
    assert got == want and got
    assert tstate.group_objects_by_site(got) == \
        jstate.group_objects_by_site(want)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_leak_report_equal_jax(seed):
    audits, tables, _ = _rows(seed)
    lost = {r["object_id"] for t in tables for r in t["refs"]
            if r["object_id"].endswith("3")}

    def query(oid):
        return oid.hex() in lost

    assert tstate.lost_held_ids(audits, tables, query) == \
        jstate.lost_held_ids(audits, tables, query)
    for kw in ({"age_s": 20.0, "grace_s": 5.0},
               {"age_s": 1.0, "grace_s": 0.5, "lost_ids": lost},
               {"grace_s": 10.0}):
        want = jstate.leak_report(audits, tables, **kw)
        got = tstate.leak_report(audits, tables, **kw)
        assert got == want
    assert {lk["kind"] for lk in got["leaks"]} <= {
        "unreferenced", "age_outlier", "held_lost"}


def _task_events(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(30):
        t0 = float(rng.uniform(1e9, 1e9 + 100))
        out.append({
            "task_id": bytes([seed, i]) * 8, "name": f"f{int(rng.integers(0, 4))}",
            "kind": ["task", "actor_task", "actor_creation"][
                int(rng.integers(0, 3))],
            "state": ["FINISHED", "FAILED", "RUNNING", "FORWARDED"][
                int(rng.integers(0, 4))],
            "node_id": bytes.fromhex(NODES[int(rng.integers(0, 2))]),
            "worker_id": (bytes([i]) * 16 if rng.uniform() < 0.8 else None),
            "submitted_ts": t0 - 0.1, "start_ts": t0,
            "end_ts": t0 + float(rng.exponential(0.5))})
    return out


@pytest.mark.parametrize("seed", [6, 7])
def test_event_summaries_and_timeline_equal_jax(seed):
    events = _task_events(seed)
    assert tstate.summarize_events(events) == jstate.summarize_events(events)
    want = jstate.events_to_chrome_trace(events)
    assert tstate.events_to_chrome_trace(events) == want
    assert all(e["ph"] == "X" for e in want) and want


def _spans(seed: int):
    """One trace across three processes, duplicates and an orphan."""
    rng = np.random.default_rng(seed)
    spans, ids = [], []
    for i in range(15):
        sid = f"{seed:02x}{i:014x}"
        parent = (ids[int(rng.integers(len(ids)))] if ids else None)
        if i == 7:
            parent = "never-flushed"
        t0 = float(rng.uniform(0, 10))
        spans.append({
            "trace_id": "t", "span_id": sid, "parent_id": parent,
            "name": f"op{i % 5}", "kind": ["task", "user"][i % 2],
            "node": NODES[i % 2], "pid": 100 + i % 3,
            "start_ts": t0, "end_ts": t0 + float(rng.exponential(1.0)),
            "queue_wait_s": float(rng.exponential(0.01)),
            "arg_fetch_s": float(rng.exponential(0.01)),
            "run_s": float(rng.exponential(0.5)), "ok": True, "args": {}})
        ids.append(sid)
    return spans + spans[:3]


@pytest.mark.parametrize("seed", [8, 9])
def test_trace_assembly_equal_jax(seed):
    spans = _spans(seed)
    want = jtracing.assemble_trace("t", spans)
    got = ttracing.assemble_trace("t", spans)
    assert got == want
    assert got["summary"]["num_spans"] == 15 and len(got["tree"]) >= 2
    assert ttracing.trace_to_chrome_events(got["spans"]) == \
        jtracing.trace_to_chrome_events(want["spans"])


def test_chrome_export_without_a_runtime(tmp_path):
    """``export_chrome_trace`` writes this process's spans (and, under a
    runtime, the task timeline); ``export_otel_spans`` is import-gated."""
    n = ttracing.export_chrome_trace(str(tmp_path / "t.json"),
                                     include_task_events=False)
    data = json.loads((tmp_path / "t.json").read_text())
    assert len(data["traceEvents"]) == n
    try:
        import opentelemetry  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            ttracing.export_otel_spans()


# ---------------------------------------------------------------------------
# the CLI against a live port cluster

@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch as rt

    saved = {k: os.environ.get(k) for k in ("RTPU_TSDB_SAMPLE_S",
                                            "RTPU_METRICS_FLUSH_S")}
    os.environ["RTPU_TSDB_SAMPLE_S"] = "0.5"
    os.environ["RTPU_METRICS_FLUSH_S"] = "0.25"
    node = rt.init(min_workers=1, resources={"CPU": 2.0})
    ttracing.enable_tracing()
    try:
        yield rt, node
    finally:
        ttracing.disable_tracing()
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cli(node, *argv) -> str:
    from ray_tpu_torch.scripts import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv) + ["--address", node.sched_address])
    return buf.getvalue()


def test_cli_status_summary_and_memory(port):
    rt, node = port

    @rt.remote
    def cli_probe(x):
        return x + 1

    assert rt.get([cli_probe.remote(i) for i in range(3)], timeout=60) == \
        [1, 2, 3]
    out = _cli(node, "status")
    assert "Cluster status" in out and "head" in out and "ALIVE" in out
    deadline = time.monotonic() + 20
    while "cli_probe" not in _cli(node, "summary"):
        assert time.monotonic() < deadline
        time.sleep(0.2)
    assert "FINISHED=3" in _cli(node, "summary")
    assert "Object store memory" in _cli(node, "memory")
    summary = tstate.summarize_tasks()["cluster"]["summary"]
    assert summary["cli_probe"]["FINISHED"] == 3


def test_cli_trace_and_timeline(port, tmp_path):
    rt, node = port

    @rt.remote
    def traced_child(x):
        return x * 2

    with ttracing.trace_span("cli-root") as root:
        assert rt.get(traced_child.remote(4), timeout=60) == 8
    deadline = time.monotonic() + 20
    while True:
        tr = tstate.get_trace(root.trace_id)
        if tr["summary"]["num_spans"] >= 2:
            break
        assert time.monotonic() < deadline, tr
        time.sleep(0.25)
    assert len(tr["tree"]) == 1 and tr["tree"][0]["name"] == "cli-root"
    out = _cli(node, "trace", root.trace_id)
    assert "cli-root" in out and "traced_child" in out
    assert root.trace_id in _cli(node, "trace")
    chrome = tmp_path / "trace.json"
    _cli(node, "trace", root.trace_id, "-o", str(chrome))
    assert json.loads(chrome.read_text())["traceEvents"]
    tl = tmp_path / "timeline.json"
    assert "wrote" in _cli(node, "timeline", "-o", str(tl))
    assert any(e["name"] == "traced_child"
               for e in json.loads(tl.read_text()))


def test_cli_events_slo_and_top(port):
    rt, node = port
    from ray_tpu_torch.util import events

    events.emit("cli.probe", severity="warning", message="from the test",
                data={"n": 1}, flush=True)
    deadline = time.monotonic() + 20
    while "cli.probe" not in _cli(node, "events", "--kind", "cli."):
        assert time.monotonic() < deadline
        time.sleep(0.25)
    assert any(e["kind"] == "cli.probe"
               for e in tstate.list_events(kind="cli."))
    slo = _cli(node, "slo")
    assert "SLOs" in slo and "llm_ttft_p90" in slo
    assert {r["rule"] for r in tstate.slo_status()["rules"]} >= {
        "llm_ttft_p90"}
    deadline = time.monotonic() + 20
    while "node_workers" not in _cli(node, "top", "--window", "60"):
        assert time.monotonic() < deadline
        time.sleep(0.25)
    assert any(r["family"] == "node_workers"
               for r in tstate.tsdb_overview(60.0))


def test_check_reports_a_clean_tree(port, capsys):
    """``check`` runs the port's static checker through the CLI."""
    _, node = port
    from ray_tpu_torch.scripts import cli

    with pytest.raises(SystemExit) as exit_:
        cli.main(["check"])
    assert exit_.value.code == 0
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "6 pass(es)" in out
    assert tstate.list_data_jobs() == []
    out = _cli(node, "serve")
    assert "no serve deployments" in out


def test_microbenchmark_writes_its_record_to_out(port, tmp_path):
    """``rtpu microbenchmark`` on the running cluster, at short windows:
    its ten rates and their ratios to Ray's, written only to ``--out``."""
    from ray_tpu_torch.scripts import cli

    path = tmp_path / "core.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["microbenchmark", "--out", str(path), "--window", "0.05",
                  "--reps", "1"])
    record = json.loads(path.read_text())
    rates = record["results_per_s"]
    assert len(rates) == 10 and all(v > 0 for v in rates.values()), rates
    assert json.dumps({"microbenchmark": rates}) in buf.getvalue()
    assert set(record["vs_reference"]) < set(rates)
    assert record["reference_source"] == \
        "release/perf_metrics/microbenchmark.json"
    assert os.listdir(tmp_path) == ["core.json"]


def test_chrome_export_holds_the_cluster_task_timeline(port, tmp_path):
    rt, _ = port

    @rt.remote
    def exported_work():
        time.sleep(0.01)
        return 1

    with ttracing.trace_span("driver_block"):
        assert rt.get([exported_work.remote() for _ in range(2)],
                      timeout=60) == [1, 1]
    path = str(tmp_path / "export.json")
    deadline = time.monotonic() + 20
    while True:
        n = ttracing.export_chrome_trace(path)
        names = {e["name"] for e in json.loads(open(path).read())[
            "traceEvents"]}
        if "driver_block" in names and any("exported_work" in x
                                           for x in names):
            break
        assert time.monotonic() < deadline, names
        time.sleep(0.25)
    assert n == len(json.loads(open(path).read())["traceEvents"])


def test_usage_tags_land_in_the_session(port, monkeypatch):
    _, node = port
    from ray_tpu_torch._private import usage_lib

    usage_lib.record_library_usage("data")
    usage_lib.record_extra_usage_tag("test_tag", "42")
    tags = usage_lib.get_recorded_tags()
    assert tags.get("library_data") == "1" and tags.get("test_tag") == "42"
    with open(os.path.join(node.session_dir, "usage_tags.json")) as f:
        assert json.load(f)["tags"]["test_tag"] == "42"
    monkeypatch.setenv("RAY_TPU_USAGE_STATS_DISABLED", "1")
    usage_lib.record_extra_usage_tag("off_tag", "1")
    assert "off_tag" not in usage_lib.get_recorded_tags()
