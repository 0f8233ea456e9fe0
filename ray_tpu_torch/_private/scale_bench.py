"""Control-plane scale benchmark: the scaled-down one-host version of
Ray's release benchmarks (release/benchmarks/README.md:11-14: 2,000
nodes, 40k actors, 10k concurrent tasks, 1k placement groups; Ray's
committed perf_metrics JSONs record the sustained rates).

Counterpart of ``ray_tpu/_private/scale_bench.py`` on the port's runtime.
One host cannot run 2,000 nodes, so each scenario exercises the REAL
control-plane stack at a scaled envelope and records sustained rates:

  tasks   — 1M queued plain tasks through the native raylet lane
            (submit -> C++ queue -> dispatch -> DONE), a sim-worker fleet
            acknowledging at once: this measures the dispatch plane, not
            user code (what Ray's benchmark_throughput mock tasks
            measure).  Specs are built streaming (1M prebuilt TaskSpec
            objects would hold ~1 GB of Python dicts before the first
            submit), so submit_per_s includes per-spec construction.
            queue_peak is the MEASURED maximum of the raylet's pending
            counter.
  actors  — 1,000 actor creations through the Python policy lane and the
            GCS actor table to ALIVE, each claiming a (sim) worker
  pgs     — 100 placement groups reserved and committed (2PC) across 20
            in-process nodes, then removed
  nodes   — those 20 nodes registering and heartbeating

Run ``python -m ray_tpu_torch._private.scale_bench [--quick] [--out
PATH]`` as a process of its own: the task and actor scenarios set
``RTPU_ALLOW_SIM_WORKERS`` in the process's environment.  The record is
written only to ``--out`` (never under ``--quick``); every scenario's
line is printed either way.  ``tests/test_torch_core_bench.py`` runs the
same scenarios at 1/50 scale (``--quick``).
"""

from __future__ import annotations

import argparse
import json
import os
import time


PROGRESS_STALL_S = float(os.environ.get("RTPU_SCALE_STALL_S", 30.0))
_last_progress = [0.0]


def _progress(label: str, done: int, total: int, t0: float):
    """At most one status line per second, always flushed."""
    now = time.monotonic()
    if now - _last_progress[0] >= 1.0:
        _last_progress[0] = now
        print(f"[scale_bench] {label}: {done}/{total} "
              f"({now - t0:.1f}s)", flush=True)


def _submit_storm(sched, n_tasks: int, t0: float):
    """Streamed build-and-submit with everything bound local: at 1M
    iterations each attribute lookup and helper-call frame is ~0.1s of
    submit phase, and the fleet's ack thread shares the GIL with this
    loop — bench-loop fat directly depresses the measured overlap
    dispatch rate.  Ids are counter-derived (salted per run): unique
    without paying an os.urandom syscall per spec.  Returns the max
    pending depth seen while submitting."""
    from ray_tpu_torch._private.task_spec import TaskSpec

    submit = sched.submit
    stats = sched._node_srv.raylet_stats
    salt = os.urandom(8)
    fn_id = b"\x00" * 20
    queue_peak = 0
    next_poll = 0
    for i in range(n_tasks):
        submit(TaskSpec(
            task_id=salt + i.to_bytes(8, "little"), kind="task",
            fn_id=fn_id, args_blob=b"",
            return_ids=[salt + i.to_bytes(12, "little")],
            resources={"CPU": 1}, name="scale_noop"))
        if i == next_poll:
            next_poll = i + 16384
            p = stats()["pending"]
            if p > queue_peak:
                queue_peak = p
            _progress("submit", i, n_tasks, t0)
    return queue_peak


def bench_tasks(n_tasks: int = 1_000_000, sim_workers: int = 16) -> dict:
    """Queued-task storm through the native raylet."""
    import ray_tpu_torch
    import ray_tpu_torch.api as api
    from ray_tpu_torch._private.sim_workers import SimWorkerFleet

    os.environ["RTPU_ALLOW_SIM_WORKERS"] = "1"
    ray_tpu_torch.init(min_workers=0, max_workers=0,
                       resources={"CPU": float(sim_workers)},
                       object_store_memory=1 << 27, ignore_reinit_error=True)
    sched = api._global_node.scheduler
    assert sched._raylet_native, "scale bench needs the native raylet"
    fleet = SimWorkerFleet(sched.socket_path, sim_workers)
    fleet.start()
    deadline = time.monotonic() + 30
    while sched._node_srv.raylet_stats()["idle"] < sim_workers:
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"sim-worker fleet never became idle: "
                f"{sched._node_srv.raylet_stats()}")
        time.sleep(0.05)

    base = sched._node_srv.raylet_stats()["done"]
    t0 = time.monotonic()
    # Streamed: build-and-submit, never holding more than one spec.
    queue_peak = _submit_storm(sched, n_tasks, t0)
    t_submit = time.monotonic() - t0
    queue_peak = max(queue_peak, sched._node_srv.raylet_stats()["pending"])
    target = base + n_tasks
    # Per-second progress + stall detection (no silent multi-minute
    # spins): the drain must make progress every PROGRESS_STALL_S or the
    # bench fails loudly with the stuck counters.
    last_done, last_change = base, time.monotonic()
    while True:
        st = sched._node_srv.raylet_stats()
        done_now = st["done"]
        queue_peak = max(queue_peak, st["pending"])
        if done_now >= target:
            break
        now = time.monotonic()
        if done_now != last_done:
            last_done, last_change = done_now, now
        elif now - last_change > PROGRESS_STALL_S:
            raise RuntimeError(
                f"task drain stalled: {done_now - base}/{n_tasks} done, "
                f"no progress for {PROGRESS_STALL_S}s "
                f"(stats={sched._node_srv.raylet_stats()})")
        _progress("tasks", done_now - base, n_tasks, t0)
        time.sleep(0.05)
    t_total = time.monotonic() - t0
    st = sched._node_srv.raylet_stats()
    done = st["done"] - base
    fleet.close()
    ray_tpu_torch.shutdown()
    return {
        "n_tasks": n_tasks,
        "sim_workers": sim_workers,
        "submit_per_s": round(n_tasks / t_submit, 1),
        "dispatch_per_s": round(done / t_total, 1),
        "completed": done,
        "queue_peak": queue_peak,  # measured max of raylet pending
    }


def bench_actors(n_actors: int = 1_000) -> dict:
    """Actor-creation storm: submit -> dispatch -> GCS ALIVE."""
    import ray_tpu_torch
    import ray_tpu_torch.api as api
    from ray_tpu_torch._private import gcs as gcs_mod
    from ray_tpu_torch._private.sim_workers import SimWorkerFleet
    from ray_tpu_torch._private.task_spec import TaskSpec

    os.environ["RTPU_ALLOW_SIM_WORKERS"] = "1"
    ray_tpu_torch.init(min_workers=0, max_workers=0,
                       resources={"CPU": 4.0}, object_store_memory=1 << 27,
                       ignore_reinit_error=True)
    sched = api._global_node.scheduler
    fleet = SimWorkerFleet(sched.socket_path, n_actors + 4)
    fleet.start()
    deadline = time.monotonic() + 60
    while True:
        with sched._lock:
            ready = sum(1 for w in sched._workers.values()
                        if w.conn is not None)
        if ready >= n_actors:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"sim-worker fleet incomplete: {ready}/{n_actors} "
                f"connected after 60s")
        time.sleep(0.1)

    actor_ids = [os.urandom(16) for _ in range(n_actors)]
    t0 = time.monotonic()
    for aid in actor_ids:
        spec = TaskSpec(
            task_id=os.urandom(16), kind="actor_creation",
            fn_id=b"\x00" * 20, args_blob=b"",
            return_ids=[os.urandom(20)], resources={},
            actor_id=aid, name="ScaleActor")
        sched.submit(spec)
    t_submit = time.monotonic() - t0
    gcs = sched.gcs
    alive = 0
    last_alive, last_change = 0, time.monotonic()
    while True:
        alive = sum(1 for aid in actor_ids
                    if (info := gcs.get_actor(aid)) is not None
                    and info.state == gcs_mod.ALIVE)
        if alive >= n_actors:
            break
        now = time.monotonic()
        if alive != last_alive:
            last_alive, last_change = alive, now
        elif now - last_change > PROGRESS_STALL_S:
            raise RuntimeError(
                f"actor creation stalled: {alive}/{n_actors} ALIVE, "
                f"no progress for {PROGRESS_STALL_S}s")
        _progress("actors", alive, n_actors, t0)
        time.sleep(0.25)
    t_total = time.monotonic() - t0
    fleet.close()
    ray_tpu_torch.shutdown()
    return {
        "n_actors": n_actors,
        "submit_per_s": round(n_actors / t_submit, 1),
        "alive": alive,
        "actors_alive_per_s": round(alive / t_total, 1),
    }


def bench_pgs_and_nodes(n_nodes: int = 20, n_pgs: int = 100) -> dict:
    """20 in-process nodes + 100 placement groups (2PC reserve/commit)."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    os.environ.pop("RTPU_ALLOW_SIM_WORKERS", None)
    cluster = Cluster(initialize_head=True,
                      head_node_args={"min_workers": 0, "max_workers": 2,
                                      "resources": {"CPU": 8.0},
                                      "object_store_memory": 1 << 26})
    # the driver must attach to the head before any PG API call
    ray_tpu_torch.init(_existing_node=cluster.head_node)
    t0 = time.monotonic()
    for i in range(n_nodes - 1):
        cluster.add_node(min_workers=0, max_workers=0,
                         resources={"CPU": 8.0},
                         object_store_memory=1 << 26)
        _progress("nodes", i + 2, n_nodes, t0)
    n_up = cluster.wait_for_nodes(timeout=120)
    t_nodes = time.monotonic() - t0

    pgs = []
    t0 = time.monotonic()
    for i in range(n_pgs):
        pgs.append(placement_group([{"CPU": 1}], strategy="PACK"))
    created = 0
    deadline = time.monotonic() + 300
    for i, pg in enumerate(pgs):
        try:
            if pg.wait(max(1.0, deadline - time.monotonic())):
                created += 1
        except Exception:
            pass
        _progress("pgs", i + 1, n_pgs, t0)
    t_pgs = time.monotonic() - t0
    if created < n_pgs:
        print(f"[scale_bench] WARNING: only {created}/{n_pgs} PGs "
              f"created within the deadline", flush=True)
    for pg in pgs:
        try:
            remove_placement_group(pg)
        except Exception:
            pass
    ray_tpu_torch.shutdown()
    cluster.shutdown()
    return {
        "n_nodes": n_up,
        "nodes_up_s": round(t_nodes, 2),
        "n_pgs": n_pgs,
        "pgs_created": created,
        "pgs_per_s": round(created / t_pgs, 1) if t_pgs > 0 else 0.0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="1/50-scale smoke (CI)")
    ap.add_argument("--out", default=None,
                    help="write the record (JSON) here; nothing is "
                         "written without it or under --quick")
    args = ap.parse_args()
    scale = 50 if args.quick else 1

    record = {"scaled_down_from":
              "Ray's release/benchmarks (2,000 nodes / 40k actors / "
              "1k PGs on a cluster); one-host envelope"}
    record["tasks"] = bench_tasks(n_tasks=1_000_000 // scale)
    print(json.dumps({"tasks": record["tasks"]}), flush=True)
    record["actors"] = bench_actors(n_actors=1_000 // scale)
    print(json.dumps({"actors": record["actors"]}), flush=True)
    record["pgs_nodes"] = bench_pgs_and_nodes(
        n_nodes=max(3, 20 // scale), n_pgs=max(4, 100 // scale))
    print(json.dumps({"pgs_nodes": record["pgs_nodes"]}), flush=True)

    if args.out and not args.quick:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"scale_bench": record}))


if __name__ == "__main__":
    main()
