"""The port's data service (``ray_tpu_torch.data.service``) held to the JAX
package's on the CPU.

Each deterministic case of ``tests/test_data_service.py`` is written once
as a function of the package under test: the split layout of a two-split
job, the first-epoch cache over two epochs, the job's snapshot through
``service.jobs()``, ``util.state.list_data_jobs()`` and a ``data_ctl``
scale command, barrier ops and bad arguments refused, a materialized
dataset's input chunks, and the dashboard's ``/api/data/jobs``.  It runs
under the JAX package's session cluster (``ray_cluster``) and under the
port's runtime, started by a module fixture in the same process, makes its
JAX test's assertions in both, and returns what it saw as plain values
(the snapshots without their times, rates, worker ids and cached bytes);
the two results must be equal.

On top of that, checks of the port alone: a data worker killed mid-epoch
loses no row and each split's rows are the JAX service's without a kill;
the chaos flag's worker deaths lose no row; and a job spec of more than a
megabyte reaches a new service worker with no call from this process
carrying it inline (the JAX service sends it inline).
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request

import cloudpickle
import numpy as np
import pytest
import torch

# UDFs defined here run in the services' worker processes: pickle them by
# value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# snapshot fields that depend on time or on the process, not on the job:
# compared by type only (a bundle's bytes differ too: JAX's blocks are
# Arrow tables, the port's numpy columns)
VOLATILE = {"created_at", "rows_per_s", "workers", "id", "age_s", "bytes"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runtime(ray_cluster, _one_torch_thread):
    import ray_tpu_torch as rt

    node = rt.init(num_cpus=8, min_workers=2, object_store_memory=1 << 28)
    try:
        yield node
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def packages(ray_cluster, runtime):
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu import data as jrd
    from ray_tpu._private import data_service as jsvc
    from ray_tpu.data import service as jservice
    from ray_tpu.util import state as jstate
    from ray_tpu_torch import data as rd
    from ray_tpu_torch._private import data_service as svc
    from ray_tpu_torch.data import service
    from ray_tpu_torch.util import state

    return [types.SimpleNamespace(name="jax", rt=ray_tpu, rd=jrd,
                                  svc=jsvc, service=jservice, state=jstate,
                                  dashboard_url=ray_cluster.dashboard_url),
            types.SimpleNamespace(name="torch", rt=ray_tpu_torch, rd=rd,
                                  svc=svc, service=service, state=state,
                                  dashboard_url=runtime.dashboard_url)]


def _both(packages, scenario, *args):
    """``scenario(p, *args)`` under each package; the results, equal."""
    res = {p.name: scenario(p, *args) for p in packages}
    assert res["torch"] == res["jax"], res
    return res["torch"]


def _stable(v, key=None):
    """A snapshot as plain values, its VOLATILE fields by type alone."""
    if key in VOLATILE:
        return type(v).__name__
    if isinstance(v, dict):
        return {k: _stable(x, k) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_stable(x) for x in v]
    return v


def _consume_epoch(it, out, idx, errors, batch_size=8):
    """One full epoch on a consumer thread, collecting row ids in order."""
    try:
        rows = []
        for batch in it.iter_batches(batch_size=batch_size):
            rows.extend(int(v) for v in batch["id"])
        out[idx] = rows
    except BaseException as e:  # noqa: BLE001 — re-raised on the driver
        errors.append(e)


def _wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _splits(p, kill):
    """Two consumers on one named job of 96 rows in 8 chunks, each on a
    thread; with ``kill``, each chunk's batches take 0.06 s and a busy
    data worker is killed mid-epoch.  Returns the job's info, each split's
    rows in order and the job's snapshot after the epoch."""
    n = 96

    def double(batch):
        if kill:
            time.sleep(0.06)  # stretch the epoch so the kill lands mid-flight
        return {"id": batch["id"] * 2}

    ds = p.rd.range(n, override_num_blocks=8).map_batches(
        double, batch_size=4)
    name = "x-split"
    info = p.service.register(name, ds, num_splits=2,
                              min_workers=2, max_workers=3)
    try:
        assert info["chunks"] == 8 and info["num_splits"] == 2
        its = [p.service.attach(name, s) for s in range(2)]
        out = [None, None]
        errors = []
        threads = [threading.Thread(target=_consume_epoch,
                                    args=(its[i], out, i, errors),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        killed = False
        if kill:
            # kill a busy worker mid-epoch (kill_worker prefers one holding
            # a lease); retry while the epoch runs in case the lease
            # completed
            coord = p.rt.get_actor(p.svc.COORDINATOR_NAME)
            for _ in range(5):
                if not _wait_for(
                        lambda: p.service.describe(name)["in_flight"] > 0,
                        timeout=30.0):
                    break
                p.rt.get(coord.kill_worker.remote(name))
                killed = True
                if _wait_for(
                        lambda: p.service.describe(name)["failovers"] > 0,
                        timeout=3.0):
                    break
                if not any(t.is_alive() for t in threads):
                    break
            assert killed, "epoch finished before any worker became busy"
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(out[i] is not None for i in range(2))
        # disjoint and complete across consumers
        assert set(out[0]) | set(out[1]) == {2 * v for v in range(n)}
        assert not set(out[0]) & set(out[1])
        snap = p.service.describe(name)
        assert snap["epoch"] == 0, "epoch restarted"
        assert snap["state"] == "running"
        if kill:
            assert snap["failovers"] >= 1, snap
    finally:
        p.service.unregister(name)
    return {"info": info, "rows": out, "snap": _stable(snap)}


def _cache(p):
    """Two epochs of one split; the second from the first-epoch cache."""
    n = 64
    ds = p.rd.range(n, override_num_blocks=8).map_batches(
        lambda b: {"id": b["id"] + 1})
    name = "x-cache"
    info = p.service.register(name, ds, num_splits=1, min_workers=1,
                              max_workers=2)
    try:
        it = p.service.attach(name, 0)
        epochs = []
        for _ in range(2):  # each iter_batches pass is one epoch
            rows = []
            for batch in it.iter_batches(batch_size=16):
                rows.extend(int(v) for v in batch["id"])
            epochs.append(rows)
        assert epochs[0] == epochs[1] == [v + 1 for v in range(n)]
        snap = p.service.describe(name)
        assert snap["epoch"] == 1
        # the whole dataset fits the default budget: every epoch-1 chunk
        # is a hit
        assert snap["cache"]["hits"] == 8
        assert snap["cache"]["misses"] == 0
        assert snap["cache"]["hit_rate"] == 1.0
        assert snap["rows_total"] == 2 * n
    finally:
        p.service.unregister(name)
    return {"info": info, "epochs": epochs, "snap": _stable(snap)}


def _error(fn, *args):
    """The ValueError ``fn(*args)`` raises, as its message."""
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def _job_fields(snap):
    """A job snapshot's keys (nested) and the fields fixed by its
    registration; the rest move while its workers produce."""
    def keys(v):
        return ({k: keys(x) for k, x in v.items()} if isinstance(v, dict)
                else type(v).__name__)

    fixed = ("name", "state", "error", "num_splits", "chunks", "epoch",
             "min_workers", "max_workers")
    return {"keys": keys(snap), **{k: snap[k] for k in fixed}}


def _surface(p):
    """``service.jobs()`` and ``state.list_data_jobs()`` see the job; a
    scale command written to the data_ctl namespace (``rtpu data scale``)
    is applied by the coordinator's poll loop; ``service.scale``."""
    ds = p.rd.range(32, override_num_blocks=4)
    name = "x-surface"
    info = p.service.register(name, ds, num_splits=2, min_workers=1,
                              max_workers=2)
    try:
        listed = [j for j in p.service.jobs() if j["name"] == name]
        assert listed
        assert _wait_for(
            lambda: any(j.get("name") == name
                        for j in p.state.list_data_jobs()),
            timeout=10.0), "job never reached the data_jobs KV snapshot"
        kv = [j for j in p.state.list_data_jobs() if j.get("name") == name]
        p.svc._kv("kv_put", p.svc.CTL_NAMESPACE, name.encode(),
                  json.dumps({"job": name, "min": 2, "max": 5}).encode())
        assert _wait_for(
            lambda: (lambda s: s["min_workers"] == 2
                     and s["max_workers"] == 5)(p.service.describe(name)),
            timeout=10.0), "ctl scale command never applied"
        # the pool converges up to the new floor
        assert _wait_for(
            lambda: len(p.service.describe(name)["workers"]) >= 2,
            timeout=10.0)
        scaled = p.service.describe(name)
        rescaled = p.service.scale(name, max_workers=3)
    finally:
        p.service.unregister(name)
    return {"info": info, "jobs": _job_fields(listed[0]),
            "kv": _job_fields(kv[0]), "scaled": _job_fields(scaled),
            "rescaled": rescaled,
            "gone": _error(p.service.describe, name)}


def _refusals(p):
    """Barrier ops and bad arguments, refused with JAX's messages."""
    ds = p.rd.range(32, override_num_blocks=4)
    out = [_error(p.service.register, "x-shuffle", ds.random_shuffle()),
           _error(p.service.register, "x-too-many-splits", ds, 9)]
    name = "x-dup"
    info = p.service.register(name, ds)
    try:
        out.append(_error(p.service.register, name, ds))
        out.append(_error(p.service.attach, name, 7))
    finally:
        p.service.unregister(name)
    out.append(_error(p.service.attach, name, 0))
    for msg, match in zip(out, ("materialize", "num_splits",
                                "already registered", "out of range",
                                "unknown data job")):
        assert match in msg, (match, msg)
    return {"info": info, "errors": out}


def _materialized(p):
    """A materialized dataset registers with its bundles as chunks: the
    path for a pipeline whose barrier ops ``.materialize()`` folds in."""
    mat = p.rd.range(24, override_num_blocks=3).materialize()
    name = "x-mat"
    info = p.service.register(name, mat, num_splits=1)
    try:
        assert info["chunks"] == 3
        rows = [int(r["id"]) for r in p.service.attach(name, 0).iter_rows()]
        assert sorted(rows) == list(range(24))
    finally:
        p.service.unregister(name)
    return {"info": info, "rows": rows}


def _dashboard(p):
    """``/api/data/jobs`` serves the coordinator's KV snapshots (the list,
    and one job)."""
    url = p.dashboard_url
    assert url, "dashboard did not start"
    ds = p.rd.range(32, override_num_blocks=4)
    name = "x-dash"
    p.service.register(name, ds, num_splits=2)
    try:
        def fetch(path):
            with urllib.request.urlopen(url + path, timeout=10) as r:
                return json.loads(r.read().decode())

        assert _wait_for(
            lambda: any(j.get("name") == name
                        for j in fetch("/api/data/jobs")),
            timeout=10.0), "job never appeared on /api/data/jobs"
        one = fetch(f"/api/data/jobs?job={name}")
        assert one["name"] == name
        assert one["num_splits"] == 2
        assert "cache" in one and "queue_depth" in one
        missing = fetch("/api/data/jobs?job=no-such-job")
        assert "error" in missing
    finally:
        p.service.unregister(name)
    return {"one": _job_fields(one), "missing": missing}


def test_shared_splits_with_midepoch_worker_kill(packages):
    """Two consumers on one named job each receive their full disjoint
    split, in chunk order: the JAX service's rows without a kill.  In the
    port a data worker killed mid-epoch is recovered by recomputing from
    the plan: no epoch restart, no duplicate or missing row."""
    jax_p, port_p = packages
    ref = _splits(jax_p, kill=False)
    got = _splits(port_p, kill=True)
    assert got["info"] == ref["info"]
    assert got["rows"] == ref["rows"]
    # chunk i -> split i % 2; chunks are 12 rows each, delivered in chunk
    # order: each split's rows are fixed
    expect = {0: [], 1: []}
    for c in range(8):
        expect[c % 2].extend(2 * v for v in range(c * 12, (c + 1) * 12))
    assert ref["rows"] == [expect[0], expect[1]]
    assert ref["snap"]["failovers"] == 0
    assert got["snap"] == {**ref["snap"], "failovers": got["snap"]
                           ["failovers"], "in_flight": got["snap"]
                           ["in_flight"]}


def test_shared_splits_layout_matches(packages):
    """Without a kill, the two services give the same info, the same rows
    per split in the same order and the same snapshot."""
    _both(packages, _splits, False)


def test_first_epoch_cache_serves_second_epoch(packages):
    _both(packages, _cache)


def test_state_surface_and_ctl_scale(packages):
    _both(packages, _surface)


def test_register_rejects_barrier_ops_and_bad_args(packages):
    _both(packages, _refusals)


def test_materialized_dataset_registers_as_input_chunks(packages):
    _both(packages, _materialized)


def test_dashboard_data_jobs_endpoint(packages):
    _both(packages, _dashboard)


def test_chaos_env_flag_worker_kills(tmp_path):
    """``RTPU_TESTING_DATA_FAILURE='<kill%>'``: data workers ``_exit(1)``
    per chunk with that probability; the epoch still completes with
    exactly its rows (a subprocess, so the flag reaches its runtime's
    workers)."""
    script = """
import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import service

rt.init(num_cpus=8, min_workers=2, object_store_memory=1 << 27)
try:
    ds = rd.range(60, override_num_blocks=6).map_batches(
        lambda b: {"id": b["id"] * 3})
    service.register("chaos", ds, num_splits=2,
                     min_workers=2, max_workers=4)
    rows = []
    for split in range(2):
        it = service.attach("chaos", split)
        for batch in it.iter_batches(batch_size=10):
            rows.extend(int(v) for v in batch["id"])
    assert sorted(rows) == [3 * v for v in range(60)], sorted(rows)
    snap = service.describe("chaos")
    print("FAILOVERS", snap["failovers"])
    print("DATA-CHAOS-SURVIVED")
finally:
    rt.shutdown()
"""
    env = dict(os.environ, RTPU_TESTING_DATA_FAILURE="30",
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DATA-CHAOS-SURVIVED" in proc.stdout


class _Recorder:
    """Records the size of every blob ``fn`` makes."""

    def __init__(self, fn, sizes):
        self._fn = fn
        self._sizes = sizes

    def __call__(self, *a, **k):
        blob = self._fn(*a, **k)
        self._sizes.append(len(blob))
        return blob


class _CloudpickleRecorder:
    """Stands in for a module's ``cloudpickle``."""

    def __init__(self, sizes):
        self.dumps = _Recorder(cloudpickle.dumps, sizes)

    def __getattr__(self, name):
        return getattr(cloudpickle, name)


def test_a_spec_of_more_than_a_megabyte_reaches_a_new_service_worker(
        runtime, monkeypatch):
    """The native transport drops a new worker that reads nothing for
    10 s (ROADMAP.md, faults ported as they are), so a job spec larger
    than ``INLINE_MAX`` (here 1.3 MB of rows inside its read tasks) goes
    to the coordinator through the store, and the job's new worker reads
    it from the GCS.  No actor call, actor creation or task this process
    sends carries it inline; every row arrives."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch._private import data_service as svc_mod
    from ray_tpu_torch.core import actor, remote_function
    from ray_tpu_torch.data import executor, service

    rng = np.random.default_rng(8)
    rows = [{"i": i, "x": rng.standard_normal(2048)} for i in range(80)]
    ds = rd.from_items(rows, override_num_blocks=4)
    assert len(cloudpickle.dumps(service._decompose(ds._plan))) > 1 << 20
    sizes = []
    monkeypatch.setattr(actor, "dumps_args",
                        _Recorder(actor.dumps_args, sizes))
    for mod in (actor, remote_function):
        monkeypatch.setattr(mod, "cloudpickle", _CloudpickleRecorder(sizes))
    name = "t-big-spec"
    info = service.register(name, ds, num_splits=1, min_workers=1,
                            max_workers=1)
    try:
        got = {}
        for b in service.attach(name, 0).iter_batches(batch_size=None):
            got.update(zip(b["i"].tolist(), b["x"]))
        monkeypatch.undo()
        assert info["chunks"] == 4
        assert len(service.describe(name)["workers"]) == 1
        assert len(svc_mod._kv("kv_get", svc_mod.PLANS_NAMESPACE,
                               name.encode())) > 1 << 20
    finally:
        monkeypatch.undo()
        service.unregister(name)
    assert sorted(got) == list(range(len(rows)))
    for r in rows:
        np.testing.assert_array_equal(got[r["i"]], r["x"])
    assert sizes and max(sizes) < executor.INLINE_MAX, sorted(sizes)[-3:]
