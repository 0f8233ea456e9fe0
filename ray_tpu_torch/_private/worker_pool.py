"""Worker process pool: spawn, track, select, and reap worker processes.

Counterpart of the reference's ``WorkerPool``
(Ray's src/ray/raylet/worker_pool.h:52-126 PopWorker /
StartWorkerProcess): owns the table of worker subprocesses and their
connection/lease state.  Mutations happen under the scheduler's lock (passed
in), exactly as the reference's pool is driven from the raylet's single asio
loop — the pool itself adds no locking discipline of its own.
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch._private.protocol import Connection


@dataclass
class WorkerState:
    worker_id: bytes
    proc: subprocess.Popen
    conn: Optional[Connection] = None
    conn_id: Optional[int] = None  # native-server connection id (raylet)
    # the worker process's direct-call server endpoint (reported at
    # registration); published to the GCS when an actor lands on it
    server_addr: Optional[str] = None
    idle: bool = False
    actor_id: Optional[bytes] = None  # set once this worker hosts an actor
    in_flight: dict = field(default_factory=dict)  # task_id -> TaskSpec
    held_resources: dict = field(default_factory=dict)
    held_pg: Optional[tuple[bytes, int]] = None
    alive: bool = True
    # Blocked-in-get bookkeeping: while a worker blocks on an unresolved
    # object its granted resources are released back to the pool (reference:
    # NotifyDirectCallTaskBlocked in src/ray/raylet/node_manager.cc) so
    # dependency chains can't deadlock the node.
    blocked_count: int = 0
    blocked_resources: dict = field(default_factory=dict)
    blocked_pg: Optional[tuple[bytes, int]] = None
    # Native-lane in-flight count, refreshed by _handle_memory_pressure
    # before victim selection (C++ owns the authoritative table).
    native_inflight: int = 0
    held_chips: list = field(default_factory=list)  # physical GPU indices
    held_share: Optional[tuple[int, float]] = None  # (card, fraction)
    retiring: bool = False  # exits after a GPU task (worker_main)


class WorkerPool:
    """Process pool for one node. All reads/writes of pool state must hold
    the scheduler lock; spawn/terminate do process I/O outside any critical
    decision but are safe to call under the RLock (Popen is quick)."""

    def __init__(
        self,
        scheduler_addr: str,
        store_socket: str,
        shm_name: str,
        store_capacity: int,
        node_id: bytes,
        min_workers: int,
        max_workers: int,
        worker_env: Optional[dict] = None,
    ):
        self.scheduler_addr = scheduler_addr
        self.store_socket = store_socket
        self.shm_name = shm_name
        self.store_capacity = store_capacity
        self.node_id = node_id
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.worker_env = worker_env or {}
        self.workers: dict[bytes, WorkerState] = {}

    @property
    def logs_dir(self) -> str:
        return os.path.join(os.path.dirname(self.store_socket), "logs")

    def spawn_worker(self) -> WorkerState:
        worker_id = os.urandom(8)
        env = dict(os.environ)
        # One OpenMP thread a worker unless the caller chose otherwise, as
        # Ray sets it: torch's default of one thread per core in every
        # worker process oversubscribes the host as soon as two workers
        # compute at once (two RLlib runner actors' small forwards took
        # ~30x longer at the default on an 8-core host).
        env.setdefault("OMP_NUM_THREADS", "1")
        env.update(self.worker_env)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        # Worker stdout/stderr go to per-worker session log files tailed to
        # the driver by the log monitor (reference: worker .out/.err files
        # under /tmp/ray/session_*/logs + log_monitor.py).  Unbuffered so
        # print() lines reach the driver promptly, not at flush time.
        env["PYTHONUNBUFFERED"] = "1"
        os.makedirs(self.logs_dir, exist_ok=True)
        tag = f"worker-{worker_id.hex()[:8]}"
        # The note_task bracket mirrors the executing task here; the log
        # monitor joins it against captured lines (rtpu logs --task).
        env["RTPU_TASK_ATTR_PATH"] = os.path.join(self.logs_dir,
                                                  tag + ".task")
        out = open(os.path.join(self.logs_dir, tag + ".out"), "ab")
        err = open(os.path.join(self.logs_dir, tag + ".err"), "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.worker_main",
                 "--scheduler-socket", self.scheduler_addr,
                 "--store-socket", self.store_socket,
                 "--shm-name", self.shm_name,
                 "--store-capacity", str(self.store_capacity),
                 "--worker-id", worker_id.hex()],
                env=env, stdout=out, stderr=err,
            )
        finally:
            out.close()  # the child holds its own descriptors now
            err.close()
        w = WorkerState(worker_id=worker_id, proc=proc)
        self.workers[worker_id] = w
        return w

    def find_idle_worker(self) -> Optional[WorkerState]:
        for w in self.workers.values():
            if w.alive and w.idle and w.conn is not None and w.actor_id is None:
                return w
        return None

    def maybe_grow(self):
        n_normal = len([w for w in self.workers.values()
                        if w.alive and w.actor_id is None])
        if n_normal < self.max_workers:
            self.spawn_worker()

    @staticmethod
    def terminate_worker(w: WorkerState):
        if w.proc is None:  # sim worker (scale harness): close its conn
            if w.conn is not None:
                try:
                    w.conn.close()
                except Exception:
                    pass
            return
        try:
            w.proc.terminate()
        except OSError:
            pass

    def shutdown_all(self):
        workers = [w for w in self.workers.values() if w.proc is not None]
        for w in workers:
            try:
                w.proc.terminate()
            except OSError:
                pass
        for w in workers:
            try:
                w.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                w.proc.kill()
