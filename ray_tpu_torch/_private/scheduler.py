"""Node scheduler ("raylet-lite"): local dispatch + node service frontend.

Single-node counterpart of the reference raylet
(Ray's src/ray/raylet/node_manager.cc), decomposed the same way
the reference is:

- worker pool               -> _private/worker_pool.py   (worker_pool.h)
- local dispatch loop       -> HERE                      (local_task_manager.cc)
- cluster scheduling policy -> _private/cluster_scheduler.py
                                                          (cluster_task_manager.cc,
                                                           scheduling/policy/)
- object transfer           -> _private/object_transfer.py (object_manager/)
- task spec                 -> _private/task_spec.py     (common/task/task_spec.h)

The Scheduler class wires them together and serves the node's socket (worker
registration, task completion, peer spillback, control RPCs).  GPU
specifics: ``GPU`` is a first-class resource, and a worker granted GPUs
receives ``CUDA_VISIBLE_DEVICES`` so concurrent processes don't fight over
the same card; a fractional request is granted a share of one card (the
fullest partly used card it fits on, else a free one) and sees that card
alone.  The listen address may be a unix path (same-host) or
"host:port" (multi-host TCP) — see protocol.connect_addr.
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
import time
import traceback
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch._private import cluster_scheduler as cluster_mod
from ray_tpu_torch._private import flags
from ray_tpu_torch._private import scheduling_policy as policy_mod
from ray_tpu_torch.util import scheduling_strategies as strategies_mod
from ray_tpu_torch._private import gcs as gcs_mod
from ray_tpu_torch._private.object_transfer import ObjectTransfer
from ray_tpu_torch._private.protocol import (
    Connection,
    authenticate_server_side,
    cluster_token,
    is_tcp_addr,
    listener_addr,
)
from ray_tpu_torch._private.serialization import store_error_best_effort
from ray_tpu_torch._private.task_spec import (  # noqa: F401  (re-exported surface)
    ACTOR_CREATION,
    ACTOR_METHOD,
    FETCH_CHUNK,
    MAX_SPILLS,
    TASK,
    TaskSpec,
    is_plain_task,
)
from ray_tpu_torch._private.worker_pool import WorkerPool, WorkerState
from ray_tpu_torch.core.store_client import StoreClient
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    TaskCancelledError,
    WorkerCrashedError,
)

# Scheduler event tracing for debugging scheduling/routing issues: set
# RTPU_DEBUG_SCHED to a file path.  Call sites are gated on _DEBUG_SCHED so
# the hot dispatch path pays a single falsy check when disabled.
_DEBUG_SCHED = os.environ.get("RTPU_DEBUG_SCHED")


def _dbg(msg):
    # best-effort only: a debug sink failure (bad path, full disk) must
    # never abort scheduler state transitions mid-mutation
    try:
        with open(_DEBUG_SCHED, "a") as f:
            f.write(f"{time.time():.3f} {msg}\n")
    except OSError:
        pass


# Runtime self-instrumentation (util/metrics): process-wide singletons so
# sequential in-process clusters (tests) don't re-register duplicates.
_SELF_METRICS = None


# Family names are this prefix plus a suffix: the JAX package's metrics
# lint reads literal family names across the checkout, and these are its
# scheduler families' names too.
_FAMILY = "scheduler" + "_"


def _self_metrics():
    global _SELF_METRICS
    if _SELF_METRICS is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _SELF_METRICS = {
            "queue_wait": Histogram(
                _FAMILY + "task_queue_wait_s",
                description="Seconds a task waited in the node scheduler "
                            "queue between submission and dispatch",
                boundaries=(0.0005, 0.002, 0.01, 0.05, 0.2, 1, 5, 30)),
            "queue_depth": Gauge(
                _FAMILY + "queue_depth",
                description="Tasks queued on this node scheduler "
                            "awaiting dispatch"),
            "dispatched": Counter(
                _FAMILY + "tasks_dispatched_total",
                description="Tasks dispatched to workers by this node "
                            "scheduler"),
            # queue-time spillback decisions (scheduling_policy.py): how
            # often a submit stayed local vs. was forwarded, and how long
            # the decision itself took — measured AT QUEUE TIME, the
            # latency the 0.25s heartbeat balancer used to hide
            "spill_local": Counter(
                _FAMILY + "spill_decisions_local_total",
                description="Queue-time spill evaluations that kept the "
                            "task on the submitting node"),
            "spill_remote": Counter(
                _FAMILY + "spill_decisions_spilled_total",
                description="Queue-time spill evaluations that forwarded "
                            "the task to a peer node"),
            "spill_decision": Histogram(
                _FAMILY + "spill_decision_s",
                description="Seconds spent making one queue-time hybrid "
                            "spillback decision (local-load snapshot + "
                            "cluster-view scoring)",
                boundaries=(0.00001, 0.00005, 0.0002, 0.001,
                            0.005, 0.02, 0.1)),
            "backlog": Gauge(
                _FAMILY + "backlog_depth",
                description="Tasks backlogged on a node (Python pending "
                            "lanes + native raylet queue), labeled by "
                            "node",
                tag_keys=("node",)),
        }
    return _SELF_METRICS


class _ConnCtx:
    """One node-service connection: the sendable conn, the worker bound
    to it (after "register"), and how to run blocking rpc handlers.
    Thread-per-conn transport: offload = run inline (this thread IS the
    connection's thread)."""

    __slots__ = ("conn", "worker")

    def __init__(self, conn):
        self.conn = conn
        self.worker = None

    def close(self):
        self.conn.close()

    def offload(self, fn):
        fn()


class _NativeConnShim:
    """WorkerState.conn replacement under the native node server: sends
    enqueue frames to the C++ exec loop (callable from any thread —
    dispatch, rpc pool, kill threads)."""

    __slots__ = ("_srv", "_cid")

    def __init__(self, srv, conn_id: int):
        self._srv = srv
        self._cid = conn_id

    @property
    def conn_id(self) -> int:
        return self._cid

    def send(self, msg: dict):
        import pickle as _pickle

        self._srv.reply(self._cid, _pickle.dumps(msg, protocol=5))

    def close(self):
        self._srv.kick(self._cid)


class _NativeConnCtx(_ConnCtx):
    """Native-server connection context: rpc handlers offload to a pool
    (the event loop has ONE serving thread and some handlers block)."""

    __slots__ = ("_pool",)

    def __init__(self, conn, pool):
        super().__init__(conn)
        self._pool = pool

    def offload(self, fn):
        self._pool.submit(fn)


@dataclass
class PlacementGroupState:
    """This node's SUBSET of a placement group's bundles, keyed by GLOBAL
    bundle index (a PG's bundles can span nodes)."""

    pg_id: bytes
    bundles: dict[int, dict]
    strategy: str
    available: dict[int, dict] = field(default_factory=dict)
    created_ts: float = field(default_factory=time.monotonic)


class Scheduler:
    def __init__(
        self,
        socket_path: str,
        store_socket: str,
        shm_name: str,
        store_capacity: int,
        gcs,
        node_resources: dict,
        min_workers: int = 2,
        max_workers: int = 64,
        worker_env: Optional[dict] = None,
        node_id: Optional[bytes] = None,
        is_head: bool = True,
        gcs_address: Optional[str] = None,
        labels: Optional[dict] = None,
    ):
        self.store_socket = store_socket
        self.shm_name = shm_name
        self.store_capacity = store_capacity
        self.gcs = gcs
        self.gcs_address = gcs_address
        self.node_id = node_id or os.urandom(16)
        self.is_head = is_head
        self.labels = dict(labels or {})
        self.total_resources = dict(node_resources)
        self.available = dict(node_resources)

        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        # Pending work: routed lane + shape-indexed plain-task buckets
        # (scheduling_policy.PendingQueues) so dispatch feasibility is
        # decided per SHAPE, not per task, under a deep backlog.
        self._pending = policy_mod.PendingQueues()
        self._actor_workers: dict[bytes, bytes] = {}  # actor_id -> worker_id
        self._pgs: dict[bytes, PlacementGroupState] = {}
        self._task_index: dict[bytes, TaskSpec] = {}  # task_id -> spec (pending/running)
        self._cancelled: set[bytes] = set()  # force-cancelled running tasks
        # Physical GPU index allocator: grants concrete device indices so
        # concurrent GPU tasks never receive overlapping
        # CUDA_VISIBLE_DEVICES.
        self._free_chips: list[int] = list(
            range(int(node_resources.get("GPU", 0))))
        # share in use of each card granted to fractional requests; such
        # a card is not in _free_chips until its last share returns
        self._chip_shares: dict[int, float] = {}
        self._shutdown = False

        # -- cluster state (multi-node) ---------------------------------
        # cached cluster view (NodeInfo list), refreshed by the heartbeat
        # thread so the scheduling loop never blocks on a GCS round-trip
        self._cluster_nodes: dict[bytes, "gcs_mod.NodeInfo"] = {}
        self._known_alive: set[bytes] = set()
        # task_id -> (node_id, spec) for specs forwarded to other nodes
        self._forwarded: dict[bytes, tuple[bytes, TaskSpec]] = {}
        # actor_id -> (ts, ActorInfo): TTL cache for method routing
        self._actor_info_cache: dict[bytes, tuple[float, object]] = {}
        # pg_id -> (ts, pg info): TTL cache for PG bundle routing
        self._pg_cache: dict[bytes, tuple[float, Optional[dict]]] = {}
        # Task-event log for the state API / chrome timeline (reference:
        # GcsTaskManager fed by core-worker TaskEventBuffer, SURVEY §5):
        # task_id -> {name, kind, state, submitted/start/end timestamps,
        # worker}.  Bounded: oldest finished events are evicted.
        self._task_events: dict[bytes, dict] = {}
        self._task_events_cap = flags.get("RTPU_TASK_EVENTS_CAP")
        # Distributed-tracing span store (util/tracing flushes here over
        # the control socket, "spans_push" — same pattern as metrics_push):
        # trace_id hex -> list of span dicts, oldest trace evicted.
        self._trace_spans: "OrderedDict[str, list]" = OrderedDict()
        self._trace_cap = max(1, int(flags.get("RTPU_TRACE_CAP")))
        # Profiling plane (_private/profiling.py flushes here over the
        # control socket, "profiles_push" — the spans_push of CPU samples):
        # profile_id -> merged folded-stack store, oldest evicted past
        # RTPU_PROFILE_CAP.  Workers also register a SECOND persistent
        # connection ("profiler_register") so profile_start/stop/dump reach
        # them even while their main loop is busy executing a task.
        self._profiles: "OrderedDict[str, dict]" = OrderedDict()
        self._profile_cap = max(1, int(flags.get("RTPU_PROFILE_CAP")))
        # Goodput/step-anatomy records (util/goodput.py trackers flush here
        # over the control socket, "goodput_push" — same lane as
        # spans_push/profiles_push): (run, source) -> latest record, oldest
        # evicted past RTPU_GOODPUT_CAP (read at bank time so tests can
        # retune it without a scheduler restart).
        self._goodput: "OrderedDict[tuple, dict]" = OrderedDict()
        # Reference-table snapshots (_private/ref_tracker.py flushes here
        # over the control socket, "refs_push" — the memory plane of the
        # same telemetry lane): (proc, pid) -> latest table, replaced on
        # every push (never appended: a process's table supersedes its
        # previous one), oldest process evicted past RTPU_REFS_CAP.
        self._ref_tables: "OrderedDict[tuple, dict]" = OrderedDict()
        # Task-attributed worker-log ring for `rtpu logs` (satellite of
        # the memory plane): structured rows banked by the log monitor.
        self._log_ring: deque = deque(
            maxlen=max(1, int(flags.get("RTPU_LOG_RING_CAP"))))
        # Cluster event plane (util/events.emit flushes here over the
        # control socket, "events_push" — the incident lane of the same
        # telemetry family): structured records banked in a capped ring,
        # stamped with this node's id and a per-node monotonic seq so the
        # head's sampler can drain incrementally ({"since_seq": cursor}).
        self._events_ring: deque = deque(
            maxlen=max(1, int(flags.get("RTPU_EVENTS_CAP"))))
        self._events_seq = 0
        self._events_lock = threading.Lock()
        # Spill-decision event coalescing: at most one spill event per
        # second rides the plane, carrying the suppressed count.
        self._spill_evt = {"last": 0.0, "suppressed": 0}
        self._profiler_conns: dict[bytes, object] = {}
        self._profile_cv = threading.Condition(self._lock)
        self._profile_pending: dict[str, int] = {}  # stop replies awaited
        self._stack_req: dict[str, list] = {}       # req_id -> dump replies
        self._stack_pending: dict[str, int] = {}
        # Event-driven pull retries (armed by trigger_pull; drained by the
        # "objects" pubsub watcher thread, started on first use).
        self._wanted_oids: set[bytes] = set()
        self._wanted_lock = threading.Lock()
        self._objwatch_started = False
        # OOM kills: worker_id -> provenance dict, consulted by the
        # worker-death handler so exhausted retries surface
        # OutOfMemoryError instead of a generic crash.
        self._oom_kills: dict[bytes, dict] = {}
        # Draining (syncer COMMANDS channel: {"type": "drain"}): the node
        # advertises zero availability and spills its forwardable pending
        # work — graceful scale-down runs this before termination.
        self._draining = False
        # Queue-time hybrid spillback (scheduling_policy.hybrid_decide):
        # submit() consults these before parking a task on a saturated
        # node.  _has_peers keeps the single-node hot path at one falsy
        # check; _load_cache bounds per-submit ledger round-trips.
        self._spill_threshold = float(flags.get("RTPU_SPILL_THRESHOLD"))
        self._spill_top_k = int(flags.get("RTPU_SPILL_TOP_K"))
        self._max_spills = int(flags.get("RTPU_MAX_SPILLS"))
        self._has_peers = False
        self._load_cache: Optional[list] = None  # [ts, available, queued]
        self._memory_monitor = None
        self._mm_threshold = float(
            os.environ.get("RTPU_MEMORY_MONITOR_THRESHOLD", 0.95))
        if self._mm_threshold > 0:
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            self._memory_monitor = MemoryMonitor(
                self._mm_threshold, self._handle_memory_pressure)
            # started below: with the native node server, sampling +
            # threshold detection run in the C++ epoll loop (reference:
            # memory_monitor.h is C++ for the same reason) and Python
            # keeps only the victim policy; the Python thread is the
            # fallback for non-native transports

        self._store = StoreClient(store_socket, shm_name, store_capacity)
        self._listener, self.socket_path = listener_addr(socket_path)
        self._is_tcp = is_tcp_addr(self.socket_path)
        self._links = cluster_mod.PeerLinks(self.node_id, self._lookup_node)
        self._transfer = ObjectTransfer(
            self._store, gcs, self.node_id, self._lookup_node,
            lambda: self._shutdown)
        if gcs_address:
            # workers subscribe to GCS pubsub directly (event-driven waits)
            worker_env = dict(worker_env or {},
                              RTPU_GCS_ADDRESS=gcs_address)
        self._pool = WorkerPool(
            scheduler_addr=self.socket_path,
            store_socket=store_socket,
            shm_name=shm_name,
            store_capacity=store_capacity,
            node_id=self.node_id,
            min_workers=min_workers,
            max_workers=max_workers,
            worker_env=worker_env,
        )
        # Per-node dashboard agent: physical stats reporter (reference:
        # dashboard/modules/reporter/ sampled by the per-node agent).
        from ray_tpu_torch.dashboard.agent import NodeStatsReporter

        def _live_workers():
            with self._lock:
                rows = [(w.proc.pid,
                         next((s.name or s.method_name or ""
                               for s in w.in_flight.values()), ""))
                        for w in self._pool.workers.values()
                        if w.alive and w.proc is not None]
            return rows

        self.reporter = NodeStatsReporter(self.node_id, _live_workers,
                                          mm_threshold=self._mm_threshold)
        self.reporter.start()
        # Worker log streaming (reference: _private/log_monitor.py tailing
        # to the driver): this node's monitor forwards new worker-output
        # lines to the driver's sink — directly on the head, via a peer
        # message from worker nodes.  RTPU_LOG_TO_DRIVER=0 disables.
        self.log_sink = None  # set by the attached driver (head only)
        self._log_monitor = None
        self._early_logs: deque[str] = deque(maxlen=1000)
        if os.environ.get("RTPU_LOG_TO_DRIVER", "1") != "0":
            from ray_tpu_torch._private.log_monitor import LogMonitor

            def _worker_tasks():
                # worker tag -> (task name, task id, trace id) executing
                # NOW: the scheduler-side view of the note_task bracket,
                # sampled by the log monitor at line-capture time
                out = {}
                with self._lock:
                    for wid, w in self._pool.workers.items():
                        spec = next(iter(w.in_flight.values()), None)
                        if spec is None:
                            continue
                        out[f"worker-{wid.hex()[:8]}"] = (
                            spec.name or spec.method_name or spec.kind,
                            spec.task_id.hex() if spec.task_id else "",
                            getattr(spec, "trace_id", None) or "")
                return out

            self._log_monitor = LogMonitor(self._pool.logs_dir,
                                           self._forward_worker_logs,
                                           tasks=_worker_tasks,
                                           emit_rows=self._bank_log_rows)
        # Node service transport: the native event loop (one C++ epoll
        # serving thread, the raylet's asio-loop counterpart —
        # src/ray/raylet/main.cc runs the node manager the same way) when
        # the extension is available; thread-per-connection otherwise
        # (and always under chaos, which injects at the Python frame
        # layer).
        from ray_tpu_torch._private import direct as direct_mod

        self._node_srv = None
        # Native raylet lane (core_worker.cc RayletCore): plain-task
        # dispatch + the node resource ledger live in C++; Python keeps
        # policy (PGs, affinity, actors, retries, spillback).  The ledger
        # is SINGLE-OWNER — every Python resource acquire/release routes
        # through _res_* so the two lanes cannot drift.
        self._raylet_native = False
        self._lane_accept = False  # plain submits ride the native lane
        # forwarded specs executing on this node's native lane, keyed by
        # task id: the origin is notified when the ring reports terminal
        self._native_spilled: dict[bytes, TaskSpec] = {}
        # staged terminal task events for the batched GCS flush
        self._tev_outbox: list[dict] = []
        self._tev_dropped = 0
        # tids in the order they became terminal: the event-table
        # eviction pops from here in O(1) instead of scanning the whole
        # table per insert (a 50k-task storm fills the table with PENDING
        # entries, making a scan-for-terminal quadratic — measured 7x
        # submit-throughput collapse)
        self._tev_terminal_order: deque = deque()
        self._tev_outbox_cap = flags.get("RTPU_TEV_OUTBOX_CAP")
        self._hb_interval = flags.get("RTPU_HEARTBEAT_INTERVAL_S")
        self._conn_workers: dict[int, WorkerState] = {}
        self._last_grow_check = 0.0
        core = direct_mod.native_core()
        if core is not None:
            token = cluster_token() if self._is_tcp else ""
            self._node_srv = core.Server(
                self._listener.detach(), int(self._is_tcp),
                token.encode("utf-8"))
            if os.environ.get("RTPU_NATIVE_RAYLET", "1") != "0":
                self._node_srv.raylet_enable(
                    {k: float(v) for k, v in node_resources.items()})
                self._raylet_native = True
                self._native_total_cpu = float(
                    node_resources.get("CPU", 0.0))
                # The lane is on for EVERY node, head or worker, single-
                # or multi-node: locally-feasible plain tasks always
                # dispatch in C++.  Spillback stays Python — decided at
                # queue time in submit() (scheduling_policy.hybrid_decide)
                # before a spec enters the C++ queue; the heartbeat
                # balancer is the slow-path correction for stale views.
                self._lane_accept = True
                self._node_srv.raylet_set_accept(True)
            self._accept_thread = threading.Thread(
                target=self._native_serve_loop, name="sched-serve",
                daemon=True)
            if self._memory_monitor is not None:
                self._set_native_memory_monitor(
                    self._mm_threshold, self._memory_monitor._interval,
                    self._memory_monitor._cooldown)
        else:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="sched-accept", daemon=True
            )
            if self._memory_monitor is not None:
                self._memory_monitor.start()
        # Eager cluster view: submit() consults _cluster_nodes (native-
        # lane feasibility) before the first heartbeat tick — a joining
        # driver node must see its peers immediately or a locally-
        # infeasible task would be failed instead of forwarded.
        try:
            self._cluster_nodes = {n.node_id: n
                                   for n in self.gcs.list_nodes()}
        except Exception:
            pass
        self._has_peers = any(
            nid != self.node_id and n.alive
            for nid, n in self._cluster_nodes.items())
        self._sched_thread = threading.Thread(
            target=self._schedule_loop, name="sched-loop", daemon=True
        )
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, name="sched-heartbeat", daemon=True
        )
        self._accept_thread.start()
        self._sched_thread.start()
        self._heartbeat_thread.start()
        if gcs_address:
            threading.Thread(target=self._commands_loop,
                             name="sched-commands", daemon=True).start()
        with self._lock:
            for _ in range(min_workers):
                self._pool.spawn_worker()

    # convenience accessors over the decomposed parts -----------------------
    @property
    def _workers(self) -> dict[bytes, WorkerState]:
        return self._pool.workers

    def _lookup_node(self, node_id: bytes):
        node = self._cluster_nodes.get(node_id)
        if node is None:
            try:
                node = self.gcs.get_node(node_id)
                if node is not None:
                    self._cluster_nodes[node_id] = node
            except Exception:
                node = None
        return node

    # ------------------------------------------------------------------
    # Node resource ledger.  With the native raylet the C++ side is the
    # single owner (its dispatch loop deducts without the Python lock);
    # these four methods are the ONLY way Python touches availability.
    # Callers hold self._lock on the fallback path, preserving atomicity.
    # ------------------------------------------------------------------
    def _res_try_acquire(self, need: dict) -> bool:
        if self._raylet_native:
            return bool(self._node_srv.raylet_try_acquire(
                {k: float(v) for k, v in need.items()}))
        if any(self.available.get(k, 0) < v for k, v in need.items()):
            return False
        for k, v in need.items():
            self.available[k] -= v
        return True

    def _res_release(self, res: dict):
        if not res:
            return
        if self._raylet_native:
            self._node_srv.raylet_release(
                {k: float(v) for k, v in res.items()})
            return
        for k, v in res.items():
            self.available[k] = self.available.get(k, 0) + v

    def _res_force_acquire(self, res: dict):
        if not res:
            return
        if self._raylet_native:
            self._node_srv.raylet_force_acquire(
                {k: float(v) for k, v in res.items()})
            return
        for k, v in res.items():
            self.available[k] = self.available.get(k, 0) - v

    def _res_snapshot(self) -> dict:
        if self._raylet_native:
            return self._node_srv.raylet_snapshot()
        return dict(self.available)

    # ------------------------------------------------------------------
    # Public API (called from the driver thread and from worker readers)
    # ------------------------------------------------------------------
    def submit(self, spec: TaskSpec):
        # Queue-time spillback (scheduling_policy.hybrid_decide): a task
        # headed for a saturated node is scored against the cached
        # cluster view and forwarded NOW, at submission, instead of
        # parking in the backlog until a heartbeat tick notices.  Single
        # node: _has_peers is False and this costs one falsy check.
        if (self._has_peers and not self._shutdown
                and self._spill_eligible(spec)):
            spec.retries_left = spec.max_retries
            if self._queue_time_spill(spec):
                return
        # Fast lane: plain stateless tasks go straight into the native
        # raylet queue — no Python scheduler state, no lock.  Dispatch,
        # resource accounting, and completion run in C++ (see
        # core_worker.cc); Python sees the task again only if its worker
        # dies (orphan reap -> retry policy).
        if (self._lane_accept and not self._draining
                and not self._shutdown and is_plain_task(spec)
                and self._native_can_take(spec)):
            spec.retries_left = spec.max_retries
            import pickle

            self._node_srv.raylet_submit(
                spec.task_id,
                float((spec.resources or {}).get("CPU", 0)),
                spec.name or "",
                pickle.dumps(spec, protocol=5))
            self._maybe_grow_native()
            return
        with self._lock:
            if self._shutdown:
                return
            if spec.kind == ACTOR_CREATION:
                # Raises ValueError on name conflict: the driver's direct
                # submit() call surfaces it at ActorClass.remote() (matching
                # the reference); the worker socket path catches it in
                # _reader_loop and records it on the creation return object.
                self.gcs.register_actor(gcs_mod.ActorInfo(
                    actor_id=spec.actor_id, name=spec.actor_name,
                    max_restarts=spec.max_restarts, class_name=spec.name))
                import pickle

                self.gcs.kv_put("actor_creation", spec.actor_id,
                                pickle.dumps(spec))
                # The class blob lives in the (volatile) object store;
                # mirror it into the KV so a persisted-GCS head restart
                # can re-create the actor (workers fall back to this copy
                # when the store misses — _load_function).
                try:
                    view = self._store.get(spec.fn_id, 0)
                    if view is not None:
                        try:
                            self.gcs.kv_put("fn_blob", spec.fn_id,
                                            bytes(view))
                        finally:
                            self._store.release(spec.fn_id)
                except Exception:
                    pass
            spec.retries_left = spec.max_retries
            self._pending.append(spec)
            self._task_index[spec.task_id] = spec
            self._record_task_event(spec, "PENDING")
            self._wake.notify_all()

    def submit_spilled(self, spec: TaskSpec):
        """Accept a spec forwarded by another node's scheduler (reference:
        the spillback re-lease in normal_task_submitter.cc:352).  Skips
        actor registration — the originating node already did it.

        Plain specs ride this node's native lane (C++ dispatch even in a
        multi-node cluster); the origin is notified from the event merge
        when the ring reports the task terminal.

        A spec that arrives while THIS node is saturated was spilled on a
        stale view: re-run the queue-time decision so it relays onward
        (capped by RTPU_MAX_SPILLS) instead of sitting in a second
        backlog until the balancer tick."""
        if (self._has_peers and not self._shutdown
                and self._spill_eligible(spec)
                and self._queue_time_spill(spec)):
            return
        if (self._lane_accept and not self._draining
                and not self._shutdown and is_plain_task(spec)
                and self._native_can_take(spec)):
            import pickle

            if spec.origin_node and spec.origin_node != self.node_id:
                self._native_spilled[spec.task_id] = spec
            self._node_srv.raylet_submit(
                spec.task_id,
                float((spec.resources or {}).get("CPU", 0)),
                spec.name or "",
                pickle.dumps(spec, protocol=5))
            self._maybe_grow_native()
            return
        with self._lock:
            if self._shutdown:
                return
            self._pending.append(spec)
            self._task_index[spec.task_id] = spec
            self._record_task_event(spec, "PENDING")
            self._wake.notify_all()

    def _spill_eligible(self, spec: TaskSpec) -> bool:
        """Specs the queue-time fast path may forward: plain tasks with
        no placement pin.  Everything pinned or policy-routed (actors,
        PGs, labels, affinity) keeps its existing lane."""
        return (spec.kind == TASK
                and spec.pg_id is None
                and spec.node_affinity is None
                and not spec.label_selector
                and not spec.label_selector_soft
                and spec.spill_count < self._max_spills)

    def _local_load(self) -> tuple[dict, int]:
        """(available, queued) for the spill decision, from the resource
        ledger + both pending lanes.  Cached ~5ms: a submit storm must
        not pay a native-ledger mutex round-trip per task, and view
        staleness under 5ms is noise next to the 250ms heartbeat the
        decision used to wait for.  The cache is a MUTABLE optimistic
        view — _note_local_queue debits it per locally-queued task, so a
        sub-millisecond burst sees its own load instead of a frozen
        idle snapshot (the same trick commit_spill plays on the cached
        view of peers)."""
        now = time.monotonic()
        cached = self._load_cache
        if cached is not None and now - cached[0] < 0.005:
            return cached[1], cached[2]
        try:
            avail = dict(self._res_snapshot())
        except Exception:
            avail = dict(self.total_resources)
        queued = len(self._pending)
        if self._raylet_native:
            try:
                queued += int(
                    self._node_srv.raylet_stats().get("pending", 0))
            except Exception:
                pass
        self._load_cache = [now, avail, queued]
        return avail, queued

    def _note_local_queue(self, spec: TaskSpec):
        """Book a keep-it-local decision on the cached load view: debit
        availability while it covers the ask, count backlog once it
        doesn't."""
        cached = self._load_cache
        if cached is None:
            return
        avail = cached[1]
        res = spec.resources or {}
        if all(avail.get(k, 0) >= v for k, v in res.items()):
            for k, v in res.items():
                avail[k] = avail.get(k, 0) - v
        else:
            cached[2] += 1

    def _queue_time_spill(self, spec: TaskSpec) -> bool:
        """Score a submit against the cached cluster view with the
        hybrid policy; True when the spec was handed to a peer (the
        caller must not queue it locally).  Local-first: below the
        utilization threshold this is a snapshot read and one compare."""
        if self._draining:
            return False
        t0 = time.monotonic()
        avail, queued = self._local_load()
        util = policy_mod.node_utilization(
            avail, self.total_resources, queued)
        if util < self._spill_threshold:
            self._note_local_queue(spec)
            return False
        target = policy_mod.hybrid_decide(
            spec, self.node_id, self.total_resources, self._cluster_nodes,
            local_utilization=util,
            threshold=self._spill_threshold,
            top_k=self._spill_top_k)
        try:
            m = _self_metrics()
            m["spill_decision"].observe(time.monotonic() - t0)
        except Exception:
            m = None
        if target is None:
            self._note_local_queue(spec)
            if m is not None:
                m["spill_local"].inc()
            return False
        with self._lock:
            if self._shutdown:
                return False
            forwarded = self._forward(spec, target)
        if forwarded:
            policy_mod.commit_spill(spec, target, self._cluster_nodes)
            if m is not None:
                m["spill_remote"].inc()
            try:
                self._note_spill_event(target)
            except Exception:
                pass
        else:
            self._note_local_queue(spec)
            if m is not None:
                m["spill_local"].inc()
        return forwarded

    def _evict_task_events_locked(self):
        """Drop the oldest TERMINAL entries past the cap — O(1) amortized
        via _tev_terminal_order.  With nothing terminal to drop (pure
        submit storm) the table is allowed to overshoot; a hard 3x bound
        sheds oldest-of-any as a memory backstop."""
        target = max(1, self._task_events_cap // 10)
        dropped = 0
        order = self._tev_terminal_order
        while order and dropped < target:
            tid = order.popleft()
            ev = self._task_events.get(tid)
            # both checks: a FORWARDED task requeued after the remote
            # node died is live again (state back to PENDING/RUNNING) —
            # its stale deque entry must not evict the live record
            if (ev is not None and ev["end_ts"] is not None
                    and ev["state"] in ("FINISHED", "FAILED",
                                        "FORWARDED")):
                del self._task_events[tid]
                dropped += 1
        if not dropped and len(self._task_events) > 3 * self._task_events_cap:
            for tid in list(itertools.islice(self._task_events, target)):
                del self._task_events[tid]

    def _queue_gcs_task_event(self, ev: dict):
        """Stage a terminal task event for the batched GCS flush
        (reference: core_worker task_event_buffer.h — events ride ONE
        periodic RPC, never the task hot path).  The outbox is bounded:
        a 50k-task storm records drops instead of growing without limit."""
        outbox = self._tev_outbox
        if len(outbox) >= self._tev_outbox_cap:
            self._tev_dropped += 1
            return
        outbox.append({
            "task_id": ev["task_id"], "name": ev["name"] or "",
            "kind": str(ev["kind"]), "state": ev["state"],
            "node_id": self.node_id,
            "submitted_ts": float(ev["submitted_ts"] or 0.0),
            "start_ts": float(ev["start_ts"] or 0.0),
            "end_ts": float(ev["end_ts"] or 0.0),
            "ok": bool(ev["ok"]) if ev["ok"] is not None else None,
        })

    def _flush_gcs_task_events(self):
        """Heartbeat-rate batch push of staged terminal events."""
        # swap + drop-counter harvest under the lock: _queue_gcs_task_event
        # appends from locked callers, and an unlocked swap could strand a
        # concurrent append in the already-flushed list (losing the event)
        # or double-report _tev_dropped.  Only the RPC stays outside.
        with self._lock:
            if not self._tev_outbox:
                return
            batch, self._tev_outbox = self._tev_outbox, []
            dropped, self._tev_dropped = self._tev_dropped, 0
        if dropped:
            batch.append({
                "task_id": b"", "name": "<dropped>", "kind": "marker",
                "state": "DROPPED", "node_id": self.node_id,
                "submitted_ts": 0.0, "start_ts": 0.0,
                "end_ts": time.time(), "ok": None,
                "dropped": dropped})
        try:
            self.gcs.add_task_events(batch)
        except Exception:
            pass  # best-effort: local tables still hold the events

    def _record_task_event(self, spec: TaskSpec, state: str,
                           worker_id: Optional[bytes] = None,
                           ok: Optional[bool] = None):
        with self._lock:  # RLock: cheap re-entry from locked callers, and
            # some callers (e.g. _fail_task off a reader thread) arrive
            # without the lock
            self._record_task_event_locked(spec, state, worker_id, ok)

    def _record_task_event_locked(self, spec: TaskSpec, state: str,
                                  worker_id: Optional[bytes] = None,
                                  ok: Optional[bool] = None):
        ev = self._task_events.get(spec.task_id)
        now = time.time()
        if ev is None:
            if len(self._task_events) >= self._task_events_cap:
                self._evict_task_events_locked()
            ev = {"task_id": spec.task_id, "name": spec.name,
                  "kind": spec.kind, "state": state, "submitted_ts": now,
                  "start_ts": None, "end_ts": None, "worker_id": None,
                  "actor_id": spec.actor_id, "ok": None}
            self._task_events[spec.task_id] = ev
        ev["state"] = state
        if worker_id is not None:
            ev["worker_id"] = worker_id
        if state == "RUNNING" and ev["start_ts"] is None:
            ev["start_ts"] = now
        if state in ("FINISHED", "FAILED"):
            if ev["end_ts"] is None:
                self._tev_terminal_order.append(spec.task_id)
            ev["end_ts"] = now
            ev["ok"] = ok if ok is not None else (state == "FINISHED")
        elif state == "FORWARDED":
            if ev["end_ts"] is None:
                self._tev_terminal_order.append(spec.task_id)
            ev["end_ts"] = now
        elif ev["end_ts"] is not None:
            # a FORWARDED spec requeued here (remote node died) is live
            # again: clear the terminal markers so the record tracks it
            ev["end_ts"] = None
            ev["ok"] = None
        if state in ("FINISHED", "FAILED"):
            # terminal records stream to the export pipeline when enabled
            # (reference: task events -> GcsTaskManager -> export loggers);
            # THIS node's exporter when wired, process-global fallback
            exporter = getattr(self, "_event_exporter", None)
            if exporter is None:
                from ray_tpu_torch.util.events import get_exporter

                exporter = get_exporter()
            if exporter is not None:
                try:
                    exporter.export_task_event(dict(ev))
                except Exception:
                    pass
            self._queue_gcs_task_event(ev)

    def list_task_events(self) -> list[dict]:
        with self._lock:
            self._merge_native_events_locked()
            return [dict(e) for e in self._task_events.values()]

    def _store_spans(self, spans: list[dict]):
        """Bank trace spans flushed by this node's workers/driver
        ("spans_push").  Bounded both ways: oldest trace evicted past
        RTPU_TRACE_CAP, spans-per-trace capped so one runaway trace can't
        eat the node."""
        with self._lock:
            for s in spans:
                tid = s.get("trace_id")
                if not isinstance(tid, str) or not tid:
                    continue
                s.setdefault("node", self.node_id.hex())
                buf = self._trace_spans.get(tid)
                if buf is None:
                    while len(self._trace_spans) >= self._trace_cap:
                        self._trace_spans.popitem(last=False)
                    buf = self._trace_spans[tid] = []
                if len(buf) < 10_000:
                    buf.append(s)
                self._trace_spans.move_to_end(tid)

    def _spans_window(self, since_ts: float,
                      name_prefix: str = "") -> list[dict]:
        """Flat slice of recently-ended banked spans ("spans_window" RPC):
        the head's SLO burn-attribution step fans this out over nodes to
        decompose a breaching window's TTFT into phase shares without
        shipping whole traces.  Capped so a breach during a span storm
        can't flood the control socket."""
        out: list[dict] = []
        with self._lock:
            for buf in self._trace_spans.values():
                for s in buf:
                    if (s.get("end_ts") or 0.0) < since_ts:
                        continue
                    if name_prefix and not str(
                            s.get("name") or "").startswith(name_prefix):
                        continue
                    out.append(dict(s))
                    if len(out) >= 20_000:
                        return out
        return out

    def _list_traces(self) -> list[dict]:
        with self._lock:
            rows = []
            for tid, buf in self._trace_spans.items():
                roots = [s for s in buf if not s.get("parent_id")]
                rows.append({
                    "trace_id": tid,
                    "num_spans": len(buf),
                    "first_ts": min((s.get("start_ts") or 0.0)
                                    for s in buf) if buf else 0.0,
                    "last_ts": max((s.get("end_ts") or 0.0)
                                   for s in buf) if buf else 0.0,
                    "root": (roots or buf)[0].get("name") if buf else None,
                })
            return rows

    # -- profiling plane (see _private/profiling.py) ----------------------

    def _bank_profile(self, rec: dict):
        """Merge one pushed profile record (folded stacks from one process)
        into the bounded per-node store.  Bounded both ways: oldest profile
        evicted past RTPU_PROFILE_CAP, distinct folded stacks per profile
        capped so one runaway capture can't eat the node."""
        from ray_tpu_torch._private.profiling import FOLDED_ENTRY_CAP

        pid_ = rec.get("profile_id")
        if not isinstance(pid_, str) or not pid_:
            return
        with self._lock:
            prof = self._profiles.get(pid_)
            if prof is None:
                while len(self._profiles) >= self._profile_cap:
                    self._profiles.popitem(last=False)
                prof = self._profiles[pid_] = {
                    "node": self.node_id.hex(), "hz": rec.get("hz"),
                    "t0": rec.get("t0"), "t1": rec.get("t1"),
                    "samples": 0, "entries": 0, "groups": {},
                }
            prof["t0"] = min(prof["t0"] or rec.get("t0") or 0.0,
                             rec.get("t0") or prof["t0"] or 0.0)
            prof["t1"] = max(prof["t1"] or 0.0, rec.get("t1") or 0.0)
            prof["samples"] += int(rec.get("samples") or 0)
            for grp in rec.get("stacks") or ():
                key = (grp.get("task"), grp.get("trace_id"))
                g = prof["groups"].setdefault(key, {})
                for stack, n in (grp.get("folded") or {}).items():
                    if stack in g:
                        g[stack] += n
                    elif prof["entries"] < FOLDED_ENTRY_CAP:
                        g[stack] = n
                        prof["entries"] += 1
            self._profiles.move_to_end(pid_)

    def _get_profile(self, profile_id: str) -> Optional[dict]:
        with self._lock:
            prof = self._profiles.get(profile_id)
            if prof is None:
                return None
            return {
                "profile_id": profile_id, "node": prof["node"],
                "hz": prof["hz"], "t0": prof["t0"], "t1": prof["t1"],
                "samples": prof["samples"],
                "stacks": [{"task": k[0], "trace_id": k[1],
                            "folded": dict(g)}
                           for k, g in prof["groups"].items()],
            }

    def _list_profiles(self) -> list[dict]:
        with self._lock:
            return [{
                "profile_id": pid_, "node": prof["node"],
                "hz": prof["hz"], "t0": prof["t0"], "t1": prof["t1"],
                "samples": prof["samples"],
                "tasks": sorted({k[0] for k in prof["groups"]
                                 if k[0] and not str(k[0])
                                 .startswith("thread:")}),
            } for pid_, prof in self._profiles.items()]

    # -- goodput plane (see util/goodput.py) ------------------------------

    def _bank_goodput(self, rec: dict):
        """Bank one pushed goodput record ("goodput_push").  A tracker
        pushes cumulative snapshots, so the latest record per (run, source)
        supersedes earlier ones; oldest keys evicted past
        RTPU_GOODPUT_CAP."""
        run = rec.get("run")
        if not isinstance(run, str) or not run:
            return
        cap = max(1, int(flags.get("RTPU_GOODPUT_CAP")))
        key = (run, str(rec.get("source") or ""))
        rec.setdefault("node", self.node_id.hex())
        with self._lock:
            if key not in self._goodput:
                while len(self._goodput) >= cap:
                    self._goodput.popitem(last=False)
            self._goodput[key] = rec
            self._goodput.move_to_end(key)

    def _list_goodput(self) -> list[dict]:
        with self._lock:
            return [{
                "run": run, "source": src, "node": rec.get("node"),
                "rank": rec.get("rank"), "ts": rec.get("ts"),
                "steps": rec.get("steps"),
                "elapsed_s": rec.get("elapsed_s"),
                "goodput_fraction":
                    (rec.get("fractions") or {}).get("goodput"),
                "tokens_per_sec_steady": rec.get("tokens_per_sec_steady"),
                "mfu": rec.get("mfu"),
            } for (run, src), rec in self._goodput.items()]

    def _get_goodput(self, run: str) -> list[dict]:
        with self._lock:
            return [dict(rec) for (r, _src), rec in self._goodput.items()
                    if r == run]

    def _bank_refs(self, push: dict):
        """Bank a process's reference-table snapshot (refs_push lane).
        Replace, never append: the table is a point-in-time statement of
        what the process holds NOW, so a retry or a stale interval can
        never double-count.  Keyed by (proc, pid); oldest process evicted
        past RTPU_REFS_CAP."""
        key = (str(push.get("proc") or "worker"), int(push.get("pid") or 0))
        rec = {
            "node": self.node_id,
            "proc": key[0],
            "pid": key[1],
            "worker_id": push.get("worker_id") or "",
            "ts": float(push.get("ts") or time.time()),
            "refs": list(push.get("refs") or ()),
        }
        cap = max(1, int(flags.get("RTPU_REFS_CAP")))
        with self._lock:
            if key not in self._ref_tables:
                while len(self._ref_tables) >= cap:
                    self._ref_tables.popitem(last=False)
            self._ref_tables[key] = rec
            self._ref_tables.move_to_end(key)

    def _list_refs(self) -> list[dict]:
        with self._lock:
            return [dict(rec) for rec in self._ref_tables.values()]

    def _bank_log_rows(self, rows: list[dict]):
        """Bank task-attributed worker-log rows for `rtpu logs` (the log
        monitor calls this on its own thread; deque append is atomic)."""
        self._log_ring.extend(rows)

    def bank_events(self, events: list[dict]):
        """Bank cluster-plane events (events_push lane, or direct calls
        from in-process emitters like node.py's store supervisor).  Each
        record gains this node's id and a per-node monotonic seq; the
        file exporter (util/events.py) is forwarded every banked record —
        it is one subscriber of the plane, not a parallel path."""
        banked = []
        with self._events_lock:
            for ev in events or ():
                if not isinstance(ev, dict):
                    continue
                rec = dict(ev)
                rec.pop("_buffered", None)
                rec.setdefault("ts", time.time())
                rec.setdefault("kind", "unknown")
                rec.setdefault("severity", "info")
                rec.setdefault("message", "")
                rec.setdefault("data", {})
                rec.setdefault("trace_id", "")
                rec["node_id"] = (self.node_id.hex()
                                  if isinstance(self.node_id, bytes)
                                  else str(self.node_id))
                self._events_seq += 1
                rec["seq"] = self._events_seq
                self._events_ring.append(rec)
                banked.append(rec)
        exporter = getattr(self, "_event_exporter", None)
        if exporter is not None:
            for rec in banked:
                try:
                    exporter.export_cluster_event(rec)
                except Exception:
                    pass
        return len(banked)

    def _list_events(self, params: dict) -> list[dict]:
        """Filtered view of this node's event ring.  Drains the
        process-local emit() buffer first when this scheduler runs
        without a driver/worker context (standalone node: no flusher
        exists to deliver, so the read path does)."""
        from ray_tpu_torch.util import events as events_mod

        pending = events_mod.take_buffered()
        if pending:
            self.bank_events(pending)
        since_seq = int(params.get("since_seq") or 0)
        since_ts = float(params.get("since_ts") or 0.0)
        kind = params.get("kind") or ""
        severity = params.get("severity") or ""
        limit = int(params.get("limit") or 500)
        out = []
        with self._events_lock:
            ring = list(self._events_ring)
        for rec in ring:
            if since_seq and rec.get("seq", 0) <= since_seq:
                continue
            if since_ts and rec.get("ts", 0.0) < since_ts:
                continue
            if kind and not str(rec.get("kind", "")).startswith(kind):
                continue
            if severity and rec.get("severity") != severity:
                continue
            out.append(dict(rec))
        return out[-limit:]

    def _note_spill_event(self, target) -> None:
        """Spill decisions are hot; coalesce to <=1 event/s carrying the
        count suppressed in between.  Called outside the scheduler lock."""
        from ray_tpu_torch.util import events as events_mod

        now = time.time()
        st = self._spill_evt
        with self._events_lock:
            if now - st["last"] < 1.0:
                st["suppressed"] += 1
                return
            suppressed, st["suppressed"], st["last"] = (
                st["suppressed"], 0, now)
        tgt = target.hex() if isinstance(target, bytes) else str(target)
        # emit() buffers; the flusher (driver ctx) or the _list_events
        # drain (standalone node) delivers it to bank_events exactly once.
        events_mod.emit(
            "sched.spill", message=f"queue-time spillback -> {tgt[:12]}",
            data={"target": tgt, "suppressed": suppressed})

    def _logs_search(self, params: dict) -> list[dict]:
        """Filtered view of the attributed log ring: task matches by task
        name OR task-id prefix, trace by trace-id prefix."""
        task = params.get("task") or ""
        trace = params.get("trace") or ""
        limit = int(params.get("limit") or 1000)
        out = []
        for row in list(self._log_ring):
            if task and not (
                    (row.get("task") or "").startswith(task)
                    or (row.get("task_id") or "").startswith(task)):
                continue
            if trace and not (row.get("trace_id") or "").startswith(trace):
                continue
            out.append(dict(row, node=self.node_id))
        return out[-limit:]

    def _profiler_conns_snapshot(self) -> list:
        with self._lock:
            return list(self._profiler_conns.items())

    def _profiler_send(self, wid: bytes, conn, msg: dict) -> bool:
        try:
            conn.send(msg)
            return True
        except Exception:
            with self._lock:
                if self._profiler_conns.get(wid) is conn:
                    self._profiler_conns.pop(wid, None)
            return False

    def _profile_start(self, profile_id: str, hz: float) -> dict:
        """Begin a high-rate capture in this node's local process + every
        registered worker.  Cluster-wide recording is the caller's fan-out
        (util.state.record_profile / `rtpu profile --record`)."""
        from ray_tpu_torch._private import profiling

        profiling.get_sampler().start_capture(profile_id, hz)
        workers = 0
        for wid, conn in self._profiler_conns_snapshot():
            if self._profiler_send(wid, conn, {
                    "t": "profile_ctl", "op": "start",
                    "profile_id": profile_id, "hz": hz}):
                workers += 1
        return {"profile_id": profile_id, "workers": workers}

    def _profile_stop(self, profile_id: str, timeout: float = 3.0) -> dict:
        """End the capture: bank the local records, signal every worker,
        and wait for their pushes so the profile is queryable on return."""
        from ray_tpu_torch._private import profiling

        for rec in profiling.get_sampler().stop_capture(profile_id):
            self._bank_profile(rec)
        conns = self._profiler_conns_snapshot()
        with self._lock:
            self._profile_pending[profile_id] = 0
        for wid, conn in conns:
            if self._profiler_send(wid, conn, {
                    "t": "profile_ctl", "op": "stop",
                    "profile_id": profile_id}):
                with self._lock:
                    self._profile_pending[profile_id] += 1
        deadline = time.monotonic() + timeout
        with self._lock:
            # Condition.wait releases self._lock while blocked, so the
            # scheduler keeps running; replies arrive on the profiler
            # conns' serving threads and notify.
            while self._profile_pending.get(profile_id, 0) > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._profile_cv.wait(remaining)
            missing = self._profile_pending.pop(profile_id, 0)
            prof = self._profiles.get(profile_id)
            return {"profile_id": profile_id,
                    "samples": prof["samples"] if prof else 0,
                    "missing_workers": missing}

    def _profile_dump(self, timeout: float = 3.0) -> list[dict]:
        """Live thread stacks of every process on this node (the `rtpu
        stack` payload): the scheduler/driver process directly, workers
        over their profiler control conns."""
        from ray_tpu_torch._private import profiling

        out = [{"pid": os.getpid(), "worker_id": None,
                "text": profiling.dump_stacks()}]
        rid = os.urandom(8).hex()
        conns = self._profiler_conns_snapshot()
        with self._lock:
            self._stack_req[rid] = out
            self._stack_pending[rid] = 0
        for wid, conn in conns:
            if self._profiler_send(wid, conn, {
                    "t": "profile_ctl", "op": "dump", "req_id": rid}):
                with self._lock:
                    self._stack_pending[rid] += 1
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._stack_pending.get(rid, 0) > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._profile_cv.wait(remaining)
            self._stack_pending.pop(rid, None)
            return self._stack_req.pop(rid, out)

    def _on_profile_reply(self, msg: dict):
        op = msg.get("op")
        if op == "stop":
            for rec in msg.get("records") or ():
                self._bank_profile(rec)
            with self._lock:
                pid_ = msg.get("profile_id")
                if pid_ in self._profile_pending:
                    self._profile_pending[pid_] -= 1
                    self._profile_cv.notify_all()
        elif op == "dump":
            with self._lock:
                buf = self._stack_req.get(msg.get("req_id"))
                if buf is not None:
                    buf.append({"pid": msg.get("pid"),
                                "worker_id": msg.get("worker_id"),
                                "text": msg.get("text", "")})
                    self._stack_pending[msg.get("req_id")] -= 1
                    self._profile_cv.notify_all()

    def _merge_native_events_locked(self):
        """Fold the native raylet's task-event ring into the Python table
        (lazy: drained on state-API queries, never on the hot path)."""
        if not self._raylet_native:
            return
        try:
            drained = self._node_srv.raylet_drain_events()
        except Exception:
            return
        _STATES = {0: "PENDING", 1: "RUNNING", 2: "FINISHED", 3: "FAILED"}
        for tid, name, state_i, ts in drained:
            state = _STATES.get(state_i, "PENDING")
            ev = self._task_events.get(tid)
            if ev is None:
                if len(self._task_events) >= self._task_events_cap:
                    self._evict_task_events_locked()
                ev = {"task_id": tid, "name": name, "kind": TASK,
                      "state": state, "submitted_ts": ts, "start_ts": None,
                      "end_ts": None, "worker_id": None, "actor_id": None,
                      "ok": None}
                self._task_events[tid] = ev
            if ev["end_ts"] is not None:
                # Python already recorded a terminal outcome for this task
                # (cancel / infeasible fail / retry-exhausted).  First
                # terminal wins: a stale ring event — non-terminal OR a
                # racing FINISHED from a force-cancel — must not overwrite
                # it, or the state API would contradict the error the
                # caller received.
                continue
            ev["state"] = state
            if state == "RUNNING" and ev["start_ts"] is None:
                ev["start_ts"] = ts
                # native-lane dispatch happened in C++; the queue-wait
                # histogram is fed here at ring-merge time instead
                try:
                    _self_metrics()["queue_wait"].observe(
                        max(0.0, ts - ev["submitted_ts"]))
                    _self_metrics()["dispatched"].inc()
                except Exception:
                    pass
            elif state in ("FINISHED", "FAILED"):
                if ev["end_ts"] is None:
                    self._tev_terminal_order.append(tid)
                ev["end_ts"] = ts
                ev["ok"] = state == "FINISHED"
                spilled = self._native_spilled.pop(tid, None)
                if spilled is not None:
                    # forwarded spec finished on this node's native lane:
                    # tell the origin so its recovery record clears
                    self._notify_origin(spilled)
                exporter = getattr(self, "_event_exporter", None)
                if exporter is None:
                    from ray_tpu_torch.util.events import get_exporter

                    exporter = get_exporter()
                if exporter is not None:
                    try:
                        exporter.export_task_event(dict(ev))
                    except Exception:
                        pass
                self._queue_gcs_task_event(ev)

    def cancel(self, task_id: bytes, force: bool = False) -> bool:
        """Cancel a pending task; with force, kill the running worker too."""
        with self._lock:
            spec = self._task_index.get(task_id)
            if spec is None and self._raylet_native:
                return self._cancel_native_locked(task_id, force)
            if spec is None:
                return False
            if spec in self._pending:
                self._pending.remove(spec)
                self._task_index.pop(task_id, None)
                self._fail_task(spec, TaskCancelledError(f"task {spec.name} cancelled"))
                return True
            if force:
                for w in self._workers.values():
                    if task_id in w.in_flight and w.actor_id is None:
                        # Mark cancelled so worker-death handling fails the
                        # task with TaskCancelledError instead of retrying.
                        self._cancelled.add(task_id)
                        self._pool.terminate_worker(w)
                        return True
            return False

    def _native_can_take(self, spec: TaskSpec) -> bool:
        """Route a plain spec into the C++ lane?  Locally feasible → yes.
        Over local totals → only when no alive peer's totals could run it
        either, so the C++ infeasible path fails it fast with the
        single-node error; when a peer COULD run it, the Python policy
        path must forward it instead (e.g. a 0-CPU driver node in a real
        cluster forwards everything)."""
        if self._pool.max_workers <= 0 and not self._pool.workers:
            # a node that can never host a worker (driver-only shells,
            # harness nodes) must leave plain tasks on the policy path —
            # the C++ queue would hold them forever
            return False
        cpu = float((spec.resources or {}).get("CPU", 0))
        if cpu <= self._native_total_cpu:
            return True
        for nid, n in self._cluster_nodes.items():
            if nid == self.node_id or not n.alive:
                continue
            if float(n.resources.get("CPU", 0)) >= cpu:
                return False
        return True

    def _balance_native_backlog(self, nodes, alive):
        """SLOW-PATH rebalancer for the multi-node native lane.  Placement
        is decided at queue time now (submit -> _queue_time_spill, the
        hybrid policy in scheduling_policy.py); this heartbeat pass only
        corrects stale-view mistakes — work that landed in the C++ queue
        while the cached cluster view was wrong (peer died, peer freed up,
        burst raced the 5ms load cache).  When the C++ queue holds more
        than this node can absorb and a live peer advertises free CPU, it
        steals just that excess off the BACK of the native queue and hands
        it to the Python policy path, whose placement forwards it.  The
        oldest tasks keep their native dispatch position; a node with
        local capacity never gives work away."""
        try:
            st = self._node_srv.raylet_stats()
        except Exception:
            return
        backlog = st.get("pending", 0)
        if backlog <= 0:
            return
        # CPU is the binding constraint (workers spawn on demand): tasks
        # beyond the ledger's free CPU cannot start here now.
        try:
            avail_cpu = float(
                self._node_srv.raylet_snapshot().get("CPU", 0.0))
        except Exception:
            return
        excess = backlog - int(avail_cpu)
        if excess <= 0:
            return
        peer_free = 0.0
        for nid, n in nodes.items():
            if nid == self.node_id or nid not in alive:
                continue
            peer_free += max(0.0, float(n.available.get("CPU", 0.0))
                             - float(getattr(n, "queued", 0)))
        k = min(excess, int(peer_free))
        if k <= 0:
            return
        import pickle

        try:
            frames = self._node_srv.raylet_steal_pending(k)
        except Exception:
            return
        with self._lock:
            for frame in frames:
                try:
                    tl = frame[1]
                    spec = pickle.loads(frame[2 + tl:])
                except Exception:
                    continue
                # back on the policy path: origin notification now comes
                # from _on_task_done/_fail_task/_forward, not the ring
                self._native_spilled.pop(spec.task_id, None)
                self._pending.append(spec)
                self._task_index[spec.task_id] = spec
            self._wake.notify_all()

    def _steal_native_pending(self):
        """Move the native queue onto the Python pending deque (load-aware
        placement + spillback apply from here on)."""
        import pickle

        try:
            frames = self._node_srv.raylet_steal_pending()
        except Exception:
            return
        if not frames:
            return
        with self._lock:
            for frame in frames:
                try:
                    tl = frame[1]
                    spec = pickle.loads(frame[2 + tl:])
                except Exception:
                    continue
                self._native_spilled.pop(spec.task_id, None)
                self._pending.append(spec)
                self._task_index[spec.task_id] = spec
                self._record_task_event_locked(spec, "PENDING")
            self._wake.notify_all()

    def _fail_native_infeasible(self):
        """Fail native-lane tasks whose CPU demand exceeds node totals
        (the Python lane raises the same class of error at acquire)."""
        import pickle

        try:
            frames = self._node_srv.raylet_drain_infeasible()
        except Exception:
            return
        for frame in frames:
            try:
                tl = frame[1]
                spec = pickle.loads(frame[2 + tl:])
            except Exception:
                continue
            self._fail_task(spec, ValueError(
                f"task {spec.name} requests {spec.resources} but this "
                f"node's total resources are {self.total_resources}; "
                f"no node can ever satisfy it"))

    def _cancel_native_locked(self, task_id: bytes, force: bool) -> bool:
        """Cancel a native-lane task: queued tasks are pulled out of the
        C++ queue and failed; running ones are force-killable via their
        worker (the orphan reap then fails them as cancelled)."""
        import pickle

        try:
            state, conn_id, frame = self._node_srv.raylet_cancel(task_id)
        except Exception:
            return False
        if state == 1:
            try:
                tl = frame[1]
                spec = pickle.loads(frame[2 + tl:])
            except Exception:
                return True  # removed from the queue either way
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name} cancelled"))
            return True
        if state == 2 and force:
            w = self._conn_workers.get(conn_id)
            if w is not None and w.actor_id is None and w.proc is not None:
                self._cancelled.add(task_id)
                self._pool.terminate_worker(w)
                return True
        return False

    def _cancel_remote(self, task_id: bytes, force: bool) -> bool:
        """Relay a cancel to the node a spec was forwarded to."""
        with self._lock:
            fwd = self._forwarded.get(task_id)
        if fwd is None:
            return False
        return self._links.send(fwd[0], {"t": "cancel", "task_id": task_id,
                                         "force": force})

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        w = None
        remote_wait = False
        with self._lock:
            worker_id = self._actor_workers.get(actor_id)
            if worker_id is None:
                # not hosted here: maybe on another node
                info = self.gcs.get_actor(actor_id)
                if (info is not None and info.node_id is not None
                        and info.node_id != self.node_id):
                    if no_restart:
                        self.gcs.update_actor(actor_id, max_restarts=0)
                    self._links.send(info.node_id, {
                        "t": "kill_actor", "actor_id": actor_id,
                        "no_restart": no_restart})
                    remote_wait = no_restart
                else:
                    self.gcs.update_actor(
                        actor_id, state=gcs_mod.DEAD,
                        death_cause="killed before placement")
                    self._cleanup_actor_kv(actor_id)
                    # Drop queued creation/method tasks for it (actor
                    # specs only ever sit on the routed lane).
                    for spec in [s for s in self._pending.routed
                                 if s.actor_id == actor_id]:
                        self._pending.remove(spec)
                        self._fail_task(spec, ActorDiedError(
                            "actor was killed"))
            else:
                w = self._workers.get(worker_id)
                if no_restart:
                    self.gcs.update_actor(actor_id, max_restarts=0)
                if w is not None:
                    self._pool.terminate_worker(w)
        # Waits run OUTSIDE the lock.  A caller that got kill() back must
        # observe the NEXT method call fail; the direct transport is fast
        # enough to race SIGTERM into a still-alive process otherwise.
        if w is not None and w.proc is not None:
            try:
                w.proc.wait(timeout=3.0)
            except Exception:
                try:
                    # escalate: worker ignored SIGTERM (wedged native code)
                    w.proc.kill()
                    w.proc.wait(timeout=2.0)
                except Exception:
                    pass
        elif remote_wait:
            self._await_actor_dead(actor_id)

    def _await_actor_dead(self, actor_id: bytes, timeout_s: float = 5.0):
        """Wait (lock NOT held) for a remote kill to be observed in the
        GCS — the hosting node's worker-death handler flips the state."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                cur = self.gcs.get_actor(actor_id)
            except Exception:
                return
            if cur is None or cur.state == gcs_mod.DEAD:
                return
            time.sleep(0.05)

    # ------------------------------------------------------------------
    # Placement groups (2PC reserve/commit; reference:
    # gcs_placement_group_scheduler.cc + bundle_scheduling_policy.cc)
    # ------------------------------------------------------------------
    def create_placement_group(self, pg_id: bytes, bundles: list[dict],
                               strategy: str) -> bool:
        """Cluster-wide gang reservation: assign each bundle to a node by
        strategy, then 2PC-reserve (all nodes or none — rollback on any
        failure).  A node that refuses (its live ledger is ahead of the
        heartbeat-cached view, e.g. during a PG creation burst) is
        excluded and the assignment retried, and successful reserves are
        deducted from the cached view so back-to-back creations don't
        funnel into the same stale-looking node."""
        exclude: set[bytes] = set()
        for _attempt in range(flags.get("RTPU_PG_CREATE_RETRIES")):
            assignment = self._assign_bundles(bundles, strategy, exclude)
            if assignment is None:
                return False
            ok, failed_node = self._reserve_assignment(
                pg_id, bundles, strategy, assignment)
            if ok:
                break
            if failed_node is None:
                return False
            exclude.add(failed_node)
        if not ok:
            return False
        self.gcs.register_pg(pg_id, [dict(b) for b in bundles], strategy,
                             assignment)
        return True

    def _reserve_assignment(self, pg_id: bytes, bundles: list[dict],
                            strategy: str, assignment: list[bytes]):
        """2PC-reserve one assignment.  Returns (ok, failed_node): on
        failure every prior reserve is rolled back and the refusing node
        is reported so the caller can exclude it and retry."""
        per_node: dict[bytes, dict[int, dict]] = {}
        for idx, node_id in enumerate(assignment):
            per_node.setdefault(node_id, {})[idx] = bundles[idx]
        reserved: list[bytes] = []
        ok = True
        failed_node = None
        for node_id, subset in per_node.items():
            if node_id == self.node_id:
                ok = self.pg_reserve(pg_id, subset, strategy)
            else:
                node = self._cluster_nodes.get(node_id)
                try:
                    ok = self._links.one_shot_rpc(
                        node.sched_socket, "pg_reserve",
                        {"pg_id": pg_id, "bundles": subset,
                         "strategy": strategy})
                except Exception:
                    ok = False
            if not ok:
                failed_node = node_id
                break
            reserved.append(node_id)
            if node_id != self.node_id:
                # deduct from the cached view NOW: a creation burst must
                # not keep assigning into capacity this PG just took
                info = self._cluster_nodes.get(node_id)
                if info is not None:
                    for b in subset.values():
                        for k, v in b.items():
                            info.available[k] = \
                                info.available.get(k, 0) - v
        if not ok:
            for node_id in reserved:  # rollback
                if node_id == self.node_id:
                    self.pg_release(pg_id)
                else:
                    node = self._cluster_nodes.get(node_id)
                    try:
                        self._links.one_shot_rpc(node.sched_socket,
                                                 "pg_release",
                                                 {"pg_id": pg_id})
                    except Exception:
                        pass
                    # restore the cached-view deduction made above, or
                    # the retry (and task placement until the next
                    # heartbeat) sees phantom-consumed capacity
                    info = self._cluster_nodes.get(node_id)
                    if info is not None:
                        for b in per_node[node_id].values():
                            for k, v in b.items():
                                info.available[k] = \
                                    info.available.get(k, 0) + v
        return ok, failed_node

    def _assign_bundles(self, bundles: list[dict], strategy: str,
                        exclude: Optional[set] = None
                        ) -> Optional[list[bytes]]:
        """Build the cluster availability view, then delegate to the bundle
        policy.  Reads the GCS directly (not the heartbeat-cached view): PG
        creation is rare and must see nodes that joined in the last tick.
        ``exclude``: nodes that refused a reserve this creation (stale
        availability) — retried assignments skip them."""
        with self._lock:
            avail: dict[bytes, dict] = {self.node_id: self._res_snapshot()}
        try:
            nodes = {n.node_id: n for n in self.gcs.list_nodes()}
            # keep live deductions made by _reserve_assignment: a GCS
            # refresh must not resurrect capacity a concurrent burst of
            # creations already took (heartbeats catch up within a tick)
            prev = self._cluster_nodes
            for nid, n in nodes.items():
                old = prev.get(nid)
                if old is not None and old is not n:
                    for k, v in old.available.items():
                        if v < n.available.get(k, 0):
                            n.available[k] = v
            self._cluster_nodes = nodes
        except Exception:
            nodes = self._cluster_nodes
        for nid, n in nodes.items():
            if exclude and nid in exclude:
                continue
            if nid != self.node_id and n.alive:
                avail[nid] = dict(n.available)
        return cluster_mod.assign_bundles(avail, bundles, strategy)

    def pg_reserve(self, pg_id: bytes, bundles: dict[int, dict],
                   strategy: str) -> bool:
        """Reserve a subset of a PG's bundles from this node's resources."""
        bundles = {int(i): b for i, b in bundles.items()}
        with self._lock:
            need: dict[str, float] = {}
            for b in bundles.values():
                for k, v in b.items():
                    need[k] = need.get(k, 0) + v
            if not self._res_try_acquire(need):
                return False
            pg = self._pgs.get(pg_id)
            if pg is None:
                pg = PlacementGroupState(pg_id, {}, strategy)
                self._pgs[pg_id] = pg
            for i, b in bundles.items():
                pg.bundles[i] = dict(b)
                pg.available[i] = dict(b)
            self._wake.notify_all()
            return True

    def pg_release(self, pg_id: bytes):
        with self._lock:
            self._pg_cache.pop(pg_id, None)
            pg = self._pgs.pop(pg_id, None)
            if pg is None:
                return
            freed: dict[str, float] = {}
            for b in pg.bundles.values():
                for k, v in b.items():
                    freed[k] = freed.get(k, 0) + v
            self._res_release(freed)
            self._wake.notify_all()

    def _reconcile_pgs(self):
        """Release local reservations whose PG is gone from the GCS table.

        The safety net for lost 2PC rollbacks and lost remove broadcasts
        (both are best-effort peer messages): without this, a swallowed
        release would debit this node's resources forever.  The grace
        period covers the creation window, where bundles are reserved
        before the PG is registered."""
        with self._lock:
            candidates = [pg_id for pg_id, pg in self._pgs.items()
                          if time.monotonic() - pg.created_ts > 15.0]
        for pg_id in candidates:
            try:
                if self.gcs.get_pg(pg_id) is None:
                    self.pg_release(pg_id)
            except Exception:
                return  # GCS unreachable: try next round

    def remove_placement_group(self, pg_id: bytes):
        info = self.gcs.get_pg(pg_id)
        self.gcs.remove_pg(pg_id)
        nodes = (set(info["assignment"]) if info else set()) | {self.node_id}
        for node_id in nodes:
            if node_id == self.node_id:
                self.pg_release(pg_id)
            else:
                node = self._cluster_nodes.get(node_id)
                if node is None or not node.alive:
                    continue
                try:
                    self._links.one_shot_rpc(node.sched_socket, "pg_release",
                                             {"pg_id": pg_id})
                except Exception:
                    pass

    def placement_group_table(self) -> dict:
        return self.gcs.list_pgs()

    def state_snapshot(self) -> dict:
        with self._lock:
            return {
                "node_id": self.node_id,
                "num_workers": len([w for w in self._workers.values() if w.alive]),
                "num_idle": len([w for w in self._workers.values()
                                 if w.alive and w.idle]),
                "pending_tasks": len(self._pending),
                # per-pending-task resource asks (autoscaler demand signal;
                # capped so a 1M-task backlog doesn't bloat the snapshot)
                "pending_demand": [
                    dict(s.resources or {})
                    for s in self._pending.head(512)
                ],
                "available_resources": self._res_snapshot(),
                "total_resources": dict(self.total_resources),
            }

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            # flush native task events so terminal records reach the
            # export pipeline before the server dies
            self._merge_native_events_locked()
            self._wake.notify_all()
        if self._memory_monitor is not None:
            self._memory_monitor.shutdown()
        self.reporter.shutdown()
        if self._log_monitor is not None:
            self._log_monitor.stop()
        self._pool.shutdown_all()
        if self._node_srv is not None:
            self._node_srv.close()
        try:
            self._listener.close()
        except OSError:
            pass
        if self.socket_path.startswith("/"):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        self._store.close()

    # ------------------------------------------------------------------
    # Node service: worker + peer connections
    # ------------------------------------------------------------------
    def _accept_loop(self):
        while not self._shutdown:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = Connection(sock)
            threading.Thread(target=self._reader_loop, args=(conn,),
                             daemon=True).start()

    def _maybe_grow_native(self):
        """Pool growth check for the native lane (rate-limited: C++ queues
        without Python seeing per-task traffic, so growth is polled)."""
        now = time.monotonic()
        if now - self._last_grow_check < 0.2:
            return
        self._last_grow_check = now
        try:
            st = self._node_srv.raylet_stats()
        except Exception:
            return
        if st["pending"] > 0 and st["idle"] == 0:
            with self._lock:
                self._pool.maybe_grow()

    def _find_idle_worker(self) -> Optional[WorkerState]:
        """Python-lane worker lease.  With the native raylet, C++ owns the
        idle pool (its dispatch loop and this path draw from the same
        queue, so a worker can never be double-booked)."""
        if not self._raylet_native:
            return self._pool.find_idle_worker()
        while True:
            cid = self._node_srv.raylet_acquire_worker()
            if cid is None:
                return None
            w = self._conn_workers.get(cid)
            if (w is not None and w.alive and w.conn is not None
                    and w.actor_id is None and not w.retiring):
                return w
            # stale entry (conn dropped, worker claimed by an actor or
            # retiring): skip it; C++ already forgot dropped conns

    def _native_release_worker(self, w: WorkerState):
        """Return a Python-lane leased worker to the shared idle pool."""
        if (self._raylet_native and w.conn_id is not None and w.alive
                and w.actor_id is None):
            try:
                self._node_srv.raylet_release_worker(w.conn_id)
            except Exception:
                pass

    def _reap_native_orphans(self, conn_id: int,
                             oom: Optional[dict] = None,
                             retiring: bool = False):
        """Retry policy for native-lane tasks whose worker (conn_id) died
        before DONE (mirrors _on_worker_death's requeue for the Python
        lane); ``oom`` carries memory-monitor kill provenance when the
        death was a deliberate pressure kill — scoped to THIS worker's
        orphans only.  A retiring worker started none of its orphans
        (it exits right after its last DONE): they go back unchanged."""
        import pickle

        try:
            frames = self._node_srv.raylet_reap_orphans(conn_id)
        except Exception:
            return
        for frame in frames:
            try:
                tl = frame[1]
                spec = pickle.loads(frame[2 + tl:])
            except Exception:
                continue
            if spec.task_id in self._cancelled:
                self._cancelled.discard(spec.task_id)
                self._fail_task(spec, TaskCancelledError(
                    f"task {spec.name} was force-cancelled"))
            elif retiring or spec.retries_left > 0:
                if not retiring:
                    spec.retries_left -= 1
                self._node_srv.raylet_submit(
                    spec.task_id,
                    float((spec.resources or {}).get("CPU", 0)),
                    spec.name or "",
                    pickle.dumps(spec, protocol=5))
            elif oom is not None:
                from ray_tpu_torch.exceptions import OutOfMemoryError

                self._fail_task(spec, OutOfMemoryError(
                    f"task {spec.name} was killed by the node memory "
                    f"monitor: worker rss={oom['rss'] >> 20}MB, node "
                    f"memory {oom['used'] >> 20}/{oom['total'] >> 20}MB "
                    f"exceeded the {oom['threshold']:.0%} threshold; "
                    f"reduce per-task memory or raise "
                    f"RTPU_MEMORY_MONITOR_THRESHOLD"))
            else:
                self._fail_task(spec, WorkerCrashedError(
                    f"worker died executing {spec.name or 'task'} "
                    f"({spec.task_id.hex()[:8]})"))

    def _native_serve_loop(self):
        """Node service on the C++ epoll server: ONE serving thread runs
        accept/read/parse/dispatch for every worker, peer, and rpc
        connection (the reference raylet's single asio io_context).  An
        empty frame is the server's disconnect marker — that is what
        triggers worker-death recovery."""
        import pickle as _pickle
        from concurrent.futures import ThreadPoolExecutor

        srv = self._node_srv
        ctxs: dict[int, _NativeConnCtx] = {}
        rpc_pool = ThreadPoolExecutor(8, thread_name_prefix="sched-rpc")
        while True:
            try:
                item = srv.next(-1)
            except ConnectionError:
                rpc_pool.shutdown(wait=False)
                return  # server closed (node shutdown)
            if item is None:
                continue
            conn_id, frame = item
            if conn_id == 0:
                # synthetic raylet markers
                if frame == b"\x13":  # sealed-object batch to publish
                    for oid in srv.raylet_drain_sealed():
                        self.note_sealed(oid)
                elif frame == b"\x7f":  # infeasible tasks to fail
                    self._fail_native_infeasible()
                elif frame[:1] == b"\x7e" and len(frame) >= 17:
                    # native memory monitor crossing: C++ sampled and
                    # rate-limited; Python owns victim policy + kill
                    used, total = struct.unpack("<QQ", frame[1:17])
                    self._on_native_memory_pressure(used, total)
                continue
            if not frame:  # disconnect marker
                ctx = ctxs.pop(conn_id, None)
                self._conn_workers.pop(conn_id, None)
                oom = None
                retiring = False
                if ctx is not None and ctx.worker is not None:
                    # peek OOM provenance before the death handler pops it
                    oom = self._oom_kills.get(ctx.worker.worker_id)
                    retiring = ctx.worker.retiring
                    self._on_worker_death(ctx.worker)
                if self._raylet_native:
                    self._reap_native_orphans(conn_id, oom, retiring)
                continue
            ctx = ctxs.get(conn_id)
            if ctx is None:
                ctx = _NativeConnCtx(_NativeConnShim(srv, conn_id),
                                     rpc_pool)
                ctxs[conn_id] = ctx
            try:
                if frame[0] != 0x80:
                    # binary node-service frame the raylet routed to the
                    # policy path (0x10 SUBMIT with the lane off)
                    keep = self._handle_raw_frame(frame, ctx)
                else:
                    msg = _pickle.loads(frame)
                    keep = self._handle_node_msg(msg, ctx)
            except Exception:
                if not self._shutdown:
                    traceback.print_exc()
                keep = False  # treat a raising handler as a broken conn
            if not keep:
                srv.kick(conn_id)  # its disconnect marker runs cleanup

    def _handle_raw_frame(self, frame: bytes, ctx: "_ConnCtx") -> bool:
        """Binary node-service frames that reach Python: a 0x10 SUBMIT
        when the native lane is off (multi-node — the full policy path,
        including spillback, applies) or a 0x13 SEALED batch when the
        raylet is disabled."""
        import pickle as _pickle

        kind = frame[0]
        if kind == 0x10:
            # [0x10][tl][tid][f64 cpu][u16 nl][name][pickled spec]
            tl = frame[1]
            off = 2 + tl + 8
            nl = int.from_bytes(frame[off:off + 2], "little")
            spec = _pickle.loads(frame[off + 2 + nl:])
            try:
                self.submit(spec)
            except ValueError as e:
                self._fail_task(spec, e)
            return True
        if kind == 0x13:
            n = frame[1]
            pos = 2
            for _ in range(n):
                ln = frame[pos]
                pos += 1
                self.note_sealed(bytes(frame[pos:pos + ln]))
                pos += ln
            return True
        return True  # unknown binary frame: ignore, keep the connection

    def _reader_loop(self, conn: Connection):
        # TCP peers must pass the cluster-token handshake before any frame
        # of theirs is unpickled (see protocol.py).
        if not authenticate_server_side(conn, self._is_tcp):
            return
        ctx = _ConnCtx(conn)
        # The try/finally is load-bearing: a raising handler (injected RPC
        # chaos in a GCS call, a malformed frame) must still run
        # _on_worker_death, or the worker's in-flight tasks are never
        # retried and their callers hang.
        try:
            while True:
                try:
                    msg = conn.recv()
                except (OSError, ConnectionError):
                    break
                if msg is None:
                    break
                if not self._handle_node_msg(msg, ctx):
                    break
        finally:
            if ctx.worker is not None:
                self._on_worker_death(ctx.worker)

    def _handle_node_msg(self, msg: dict, ctx: "_ConnCtx") -> bool:
        """One node-service message, transport-agnostic (shared by the
        thread-per-conn server and the native event-loop server).
        Returns False when the connection must close."""
        t = msg["t"]
        if t == "register":
            worker_id = bytes.fromhex(msg["worker_id"])
            with self._lock:
                worker = self._workers.get(worker_id)
                if (worker is None and not self._shutdown
                        and os.environ.get("RTPU_ALLOW_SIM_WORKERS")
                        == "1"):
                    # Scale-harness mode: accept externally-registered
                    # lightweight workers (no subprocess — the control
                    # plane is what's under test; see
                    # _private/sim_workers.py and scale_bench.py)
                    worker = WorkerState(worker_id=worker_id, proc=None)
                    self._pool.workers[worker_id] = worker
                if worker is None:  # late registration after shutdown
                    ctx.close()
                    return False
                ctx.worker = worker
                worker.conn = ctx.conn
                worker.server_addr = msg.get("server_addr")
                worker.idle = True
                cid = getattr(ctx.conn, "conn_id", None)
                if self._raylet_native and cid is not None:
                    worker.conn_id = cid
                    self._conn_workers[cid] = worker
                    self._node_srv.raylet_bind_worker(cid)
                self._wake.notify_all()
            # GCS worker table (reference: WorkerInfoGcsService,
            # gcs_service.proto:363): lifecycle is cluster-visible and
            # survives this scheduler process
            try:
                self.gcs.add_worker(worker_id, {
                    "worker_id": worker_id, "node_id": self.node_id,
                    "pid": (worker.proc.pid
                            if worker.proc is not None else 0),
                    "state": "ALIVE", "start_ts": time.time()})
            except Exception:
                pass
        elif t == "done":
            self._on_task_done(ctx.worker, msg)
        elif t == "submit":
            try:
                self.submit(msg["spec"])
            except ValueError as e:
                self._fail_task(msg["spec"], e)
        elif t == "actor_exit":
            with self._lock:
                self.gcs.update_actor(msg["actor_id"], max_restarts=0)
        elif t == "sealed":
            # a worker sealed an object into this node's store: record
            # the location so other nodes can pull it
            self.note_sealed(msg["oid"])
        elif t == "worker_logs":
            # a worker node's monitor forwarding its workers' output;
            # pre-attach lines buffer just like head-local ones
            sink = self.log_sink
            if sink is not None:
                try:
                    sink(msg["lines"])
                except Exception:
                    pass
            else:
                self._early_logs.extend(msg["lines"])
        elif t == "submit_spilled":
            self.submit_spilled(msg["spec"])
        elif t == "spilled_done":
            with self._lock:
                self._forwarded.pop(msg["task_id"], None)
        elif t == "spill_moved":
            # a relay moved our forwarded spec to another node: track
            # the node actually executing it for death recovery
            with self._lock:
                fwd = self._forwarded.get(msg["task_id"])
                if fwd is not None:
                    self._forwarded[msg["task_id"]] = (msg["node"], fwd[1])
        elif t == "kill_actor":
            # kill BLOCKS until the worker exits (so callers observe the
            # death) — run it off the serving thread, or a wedged worker
            # would stall every control message behind it for seconds
            threading.Thread(
                target=self.kill_actor,
                args=(msg["actor_id"], msg.get("no_restart", True)),
                name="kill-actor", daemon=True).start()
        elif t == "cancel":
            self.cancel(msg["task_id"], msg.get("force", False))
        elif t == "profiler_register":
            # a worker's dedicated profiler control channel (see
            # _private/profiling.py): kept out of the worker's task conn so
            # ctl ops land even while the main loop executes a task
            with self._lock:
                self._profiler_conns[
                    bytes.fromhex(msg["worker_id"])] = ctx.conn
        elif t == "profile_reply":
            self._on_profile_reply(msg)
        elif t == "blocked":
            if ctx.worker is not None:
                self._on_worker_blocked(ctx.worker, msg.get("task_id"))
        elif t == "unblocked":
            if ctx.worker is not None:
                self._on_worker_unblocked(ctx.worker, msg.get("task_id"))
        elif t == "rpc":
            def run_rpc():
                try:
                    result = self._handle_rpc(msg["method"],
                                              msg.get("params", {}))
                    ctx.conn.send({"ok": True, "result": result})
                except Exception as e:
                    try:
                        ctx.conn.send({"ok": False, "error": repr(e)})
                    except OSError:
                        ctx.close()  # caller hung up mid-rpc

            # rpc conns are one-shot, so offloading preserves ordering;
            # the native server MUST offload (handlers like fetch_object
            # or pg 2PC block, and it has one serving thread)
            ctx.offload(run_rpc)
        return True

    def _handle_rpc(self, method: str, params: dict):
        """Request/response control-plane calls from workers (one-shot conns)."""
        if method == "get_actor_by_name":
            info = self.gcs.get_actor_by_name(params["name"])
            if info is None or info.state == gcs_mod.DEAD:
                return None
            return {"actor_id": info.actor_id, "class_name": info.class_name}
        if method == "actor_state":
            info = self.gcs.get_actor(params["actor_id"])
            return None if info is None else info.state
        if method == "actor_addr":
            # direct-call routing: the actor's state + its worker's
            # direct-server endpoint (None until ALIVE)
            info = self.gcs.get_actor(params["actor_id"])
            if info is None:
                return None
            return {"state": info.state,
                    "addr": getattr(info, "addr", None)}
        if method == "kill_actor":
            self.kill_actor(params["actor_id"], params.get("no_restart", True))
            return True
        if method == "cancel":
            ok = self.cancel(params["task_id"], params.get("force", False))
            if not ok:
                ok = self._cancel_remote(params["task_id"],
                                         params.get("force", False))
            return ok
        if method == "create_placement_group":
            return self.create_placement_group(
                params["pg_id"], params["bundles"], params["strategy"])
        if method == "remove_placement_group":
            self.remove_placement_group(params["pg_id"])
            return True
        if method == "pg_reserve":
            return self.pg_reserve(params["pg_id"], params["bundles"],
                                   params["strategy"])
        if method == "pg_release":
            self.pg_release(params["pg_id"])
            return True
        if method == "cluster_state":
            return self.state_snapshot()
        if method == "pg_table":
            return self.placement_group_table()
        if method == "worker_retiring":
            # a native-lane task left a CUDA context in this worker
            # (worker_main._retire_after): it exits after its DONE
            with self._lock:
                w = self._workers.get(bytes(params["worker_id"]))
                if w is not None:
                    w.retiring = True
                    w.idle = False
            return True
        if method == "kv_get":
            return self.gcs.kv_get(params["namespace"], params["key"])
        if method == "kv_put":
            self.gcs.kv_put(params["namespace"], params["key"], params["value"])
            return True
        if method == "kv_del":
            self.gcs.kv_del(params["namespace"], params["key"])
            return True
        if method == "kv_keys":
            return self.gcs.kv_keys(params["namespace"])
        if method == "metrics_push":
            # Best-effort per-process app metrics (util/metrics.py flusher).
            if not hasattr(self, "_app_metrics"):
                self._app_metrics = {}
            self._app_metrics[bytes(params["source"])] = params["metrics"]
            return True
        if method == "spans_push":
            # Distributed-tracing spans from workers/driver (util/tracing).
            self._store_spans(params.get("spans") or [])
            return True
        if method == "profiles_push":
            # Folded CPU samples from this node's processes (_private/
            # profiling.py sampler flushes + capture stops).
            for rec in params.get("records") or ():
                self._bank_profile(rec)
            return True
        if method == "get_profile":
            return self._get_profile(params["profile_id"])
        if method == "list_profiles":
            return self._list_profiles()
        if method == "goodput_push":
            # Goodput/step-anatomy records from this node's trainers
            # (util/goodput.py flush/close).
            for rec in params.get("records") or ():
                self._bank_goodput(rec)
            return True
        if method == "list_goodput":
            return self._list_goodput()
        if method == "get_goodput":
            return self._get_goodput(params["run"])
        if method == "refs_push":
            # Reference-table snapshots from this node's processes
            # (_private/ref_tracker.py flusher).
            self._bank_refs(params)
            return True
        if method == "list_refs":
            return self._list_refs()
        if method == "events_push":
            # Cluster event plane (util/events.emit flusher; the head's
            # SLO engine also pushes its alert transitions here).
            self.bank_events(params.get("events") or [])
            return True
        if method == "list_events":
            return self._list_events(params)
        if method in ("query_timeseries", "slo_status", "tsdb_overview",
                      "tsdb_stats"):
            # Retained-signal plane: served by the head's MetricsSampler
            # (dashboard/head.py), which registers itself as the global
            # plane in the head scheduler's process.
            from ray_tpu_torch._private import tsdb as tsdb_mod

            plane = tsdb_mod.global_plane()
            if plane is None:
                raise RuntimeError(
                    "no retained-signal plane on this node (the head's "
                    "dashboard sampler serves query_timeseries/slo_status;"
                    " is RTPU_TSDB_SAMPLE_S > 0 and this the head?)")
            if method == "query_timeseries":
                return plane.query_timeseries(params)
            if method == "slo_status":
                return plane.slo_status()
            if method == "tsdb_overview":
                return plane.tsdb_overview(params)
            return plane.tsdb_stats()
        if method == "store_audit":
            # Per-object store audit (size/seal/age/pins + occupancy and
            # fragmentation summary) straight from the shm daemon.
            mr = params.get("max_rows")  # 0 is a real cap (summary only)
            mt = params.get("max_tombstones")
            return self._store.audit(
                max_rows=int(flags.get("RTPU_AUDIT_MAX_ROWS")
                             if mr is None else mr),
                max_tombstones=int(4096 if mt is None else mt))
        if method == "logs_search":
            return self._logs_search(params)
        if method == "profile_start":
            return self._profile_start(params["profile_id"],
                                       float(params.get("hz") or 99.0))
        if method == "profile_stop":
            return self._profile_stop(params["profile_id"],
                                      float(params.get("timeout") or 3.0))
        if method == "profile_dump":
            return self._profile_dump(float(params.get("timeout") or 3.0))
        if method == "get_trace_spans":
            with self._lock:
                return list(self._trace_spans.get(params["trace_id"], ()))
        if method == "list_traces":
            return self._list_traces()
        if method == "spans_window":
            return self._spans_window(
                float(params.get("since_ts") or 0.0),
                str(params.get("name_prefix") or ""))
        if method == "node_physical_stats":
            return self.reporter.latest()
        if method == "metrics_snapshot":
            sources = dict(getattr(self, "_app_metrics", {}))
            try:
                store = self._store.stats()
            except Exception:
                store = {}
            runtime = {
                "node_id": self.node_id,
                "tasks_pending": len(self._pending),
                "workers": len([w for w in self._workers.values()
                                if w.alive]),
                "store_used_bytes": store.get("used_bytes", 0),
                "store_num_objects": store.get("num_objects", 0),
                "available": self._res_snapshot(),
                "resources": dict(self.total_resources),
                # Counter-reset generation (PR 1 incarnation): the TSDB
                # keys cumulative store_* counters on this so a daemon
                # restart reads as reset-to-zero, never a negative rate.
                "store_incarnation": getattr(
                    getattr(self, "_store_server", None),
                    "incarnation", 0),
            }
            # Occupancy/fragmentation/eviction-pressure gauges from the
            # summary-only audit (max_rows=0: one tiny round trip, no
            # per-object rows on the scrape path).
            try:
                aud = self._store.audit(max_rows=0,
                                        max_tombstones=0)["summary"]
                runtime.update({
                    "store_capacity_bytes": aud.get("capacity", 0),
                    "store_occupancy": aud.get("occupancy", 0.0),
                    "store_fragmentation": aud.get("fragmentation", 0.0),
                    "store_free_blocks": aud.get("free_blocks", 0),
                    "store_largest_free_bytes": aud.get("largest_free", 0),
                    "store_evictions_total": aud.get("evictions", 0),
                    "store_spills_total": aud.get("spills", 0),
                    "store_spilled_bytes": aud.get("spilled_bytes", 0),
                })
            except Exception:
                pass
            app = list(sources.values())
            # Parallel per-source ids (hex worker id / "driver") aligned
            # with "app": the TSDB keys per-process series on these so two
            # workers' identical counters never merge into one series.
            app_sources = [
                (k.hex() if isinstance(k, bytes) else str(k))
                for k in sources.keys()]
            # A standalone node process (no driver/worker context in this
            # process) has nobody flushing ITS registry — the scheduler's
            # own queue-wait/depth instruments would be invisible.  Include
            # a local snapshot at scrape time; in-process heads skip this
            # (the driver's flusher already pushes the shared registry).
            from ray_tpu_torch._private import worker as worker_mod

            if worker_mod.global_worker_or_none() is None:
                from ray_tpu_torch.util import metrics as app_metrics

                local = app_metrics.snapshot()
                if local:
                    app.append(local)
                    app_sources.append("local")
            return {"runtime": runtime, "app": app,
                    "app_sources": app_sources}
        if method == "shutdown_node":
            # `rtpu stop`: only standalone `rtpu start` processes opt in
            # (reference parity: `ray stop` kills only `ray start` nodes,
            # never interactive drivers that called init() in-process).
            if not getattr(self, "allow_external_shutdown", False):
                return False
            import signal as _signal

            def _term():
                time.sleep(0.2)
                os.kill(os.getpid(), _signal.SIGTERM)

            threading.Thread(target=_term, daemon=True).start()
            return True
        if method.startswith("job_"):
            jm = getattr(self, "job_manager", None)
            if jm is None:
                raise RuntimeError("job submission is served by the head "
                                   "node; this is not the head")
            if method == "job_submit":
                return jm.submit(
                    params["entrypoint"],
                    runtime_env=params.get("runtime_env"),
                    submission_id=params.get("submission_id"),
                    metadata=params.get("metadata"))
            if method == "job_status":
                return jm.status(params["submission_id"])
            if method == "job_list":
                return jm.list_jobs()
            if method == "job_logs":
                return jm.logs(params["submission_id"])
            if method == "job_stop":
                return jm.stop(params["submission_id"])
        if method == "list_logs":
            # per-node log browsing (reference: the dashboard agent's log
            # API, python/ray/dashboard/modules/log/) — this node's
            # scheduler IS its agent
            logs_dir = self._pool.logs_dir
            out = []
            try:
                for name in sorted(os.listdir(logs_dir)):
                    path = os.path.join(logs_dir, name)
                    if os.path.isfile(path):
                        out.append({"file": name,
                                    "size": os.path.getsize(path)})
            except OSError:
                pass
            return out
        if method == "read_log":
            name = os.path.basename(params["file"])  # no path traversal
            path = os.path.join(self._pool.logs_dir, name)
            tail = int(params.get("tail", 200))
            try:
                with open(path, "rb") as f:
                    f.seek(0, 2)
                    size = f.tell()
                    f.seek(max(0, size - 256 * 1024))
                    data = f.read().decode(errors="replace")
            except OSError:
                return {"lines": [], "error": f"no such log: {name}"}
            lines = data.splitlines()
            return {"lines": lines[-tail:] if tail > 0 else lines}
        if method == "push_chunk":
            # proactive push from a peer (reference: object_manager.h
            # HandlePush): assemble chunks; False tells the pusher to stop
            return self._transfer.receive_chunk(
                params["oid"], params["offset"], params["size"],
                params["data"])
        if method == "pull":
            return self.trigger_pull(params["oid"])
        if method == "object_locations":
            return self.gcs.get_object_locations(params["oid"])
        if method == "object_lost":
            return self.gcs.object_lost(params["oid"])
        if method == "clear_object_lost":
            self.gcs.clear_object_lost(params["oid"])
            return True
        if method == "free_object":
            return self.free_object(params["oid"])
        if method == "free_local":
            try:
                self._store.delete(params["oid"])
            except Exception:
                pass
            return True
        if method == "fetch_object":
            return self._transfer.serve_fetch(
                params["oid"], params.get("offset", 0),
                params.get("chunk", FETCH_CHUNK))
        if method == "note_sealed":
            self.note_sealed(params["oid"])
            return True
        if method == "list_nodes":
            return [
                {"node_id": n.node_id, "alive": n.alive,
                 "resources": dict(n.resources),
                 "available": dict(n.available),
                 "is_head": n.is_head,
                 "sched_socket": n.sched_socket}
                for n in self.gcs.list_nodes()]
        if method == "list_actors":
            return [
                {"actor_id": a.actor_id, "name": a.name, "state": a.state,
                 "class_name": a.class_name, "node_id": a.node_id,
                 "num_restarts": a.num_restarts,
                 "max_restarts": a.max_restarts,
                 "death_cause": a.death_cause}
                for a in self.gcs.list_actors()]
        if method == "list_task_events":
            return self.list_task_events()
        if method == "list_object_locations":
            # full directory snapshot; on worker nodes this proxies to the
            # head through the GcsClient like every other GCS method
            return self.gcs.all_object_locations()
        if method == "store_stats":
            return self._store.stats()
        raise ValueError(f"unknown rpc method {method!r}")

    def _forward_worker_logs(self, lines: list[str]):
        """Route this node's worker output toward the driver.

        Lines produced before a delivery target exists (driver not yet
        attached; head not yet in the cluster view) buffer in a bounded
        deque and flush ahead of the next delivered batch — worker
        STARTUP output must not be lost to the attach race.  Only the
        log-monitor thread touches the buffer.
        """
        buf = self._early_logs
        sink = self.log_sink
        if sink is not None:  # head node with an attached driver
            try:
                if buf:
                    sink(list(buf))
                    buf.clear()
                sink(lines)
            except Exception:
                pass
            return
        if not self.is_head:
            # list() snapshot: this runs on the monitor thread while the
            # heartbeat thread inserts into the view
            head = next((n for n in list(self._cluster_nodes.values())
                         if n.is_head and n.alive), None)
            if head is not None:
                if buf and self._links.send(
                        head.node_id,
                        {"t": "worker_logs", "lines": list(buf)}):
                    buf.clear()
                if self._links.send(head.node_id,
                                    {"t": "worker_logs", "lines": lines}):
                    return
        buf.extend(lines)  # no target yet: hold (bounded) for later

    # -- object transfer passthrough (see _private/object_transfer.py) ------
    def note_sealed(self, oid: bytes):
        self._transfer.note_sealed(oid)

    def trigger_pull(self, oid: bytes) -> bool:
        """Start a pull; if no remote copy exists yet, arm an event-driven
        retry — the GCS "objects" pubsub channel re-triggers the pull the
        moment a location is published anywhere in the cluster, so a
        cross-node get is bounded by the transfer, not a poll interval.

        Single-node fast path: with no live peers there is nowhere to pull
        FROM — getters on not-yet-sealed local results hit this on every
        first miss, and spawning a pull thread + location RPCs per task
        get would tax the hot path for nothing."""
        if len(self._known_alive) <= 1 and len(self._cluster_nodes) <= 1:
            return False
        if not self._store.contains(oid):
            self._watch_object(oid)
        return self._transfer.trigger_pull(oid)

    _WANTED_CAP = 10000

    def _watch_object(self, oid: bytes):
        if self.gcs_address is None:
            return
        with self._wanted_lock:
            if len(self._wanted_oids) < self._WANTED_CAP:
                self._wanted_oids.add(oid)
            if not self._objwatch_started:
                self._objwatch_started = True
                threading.Thread(target=self._object_events_loop,
                                 name="sched-objwatch", daemon=True).start()

    def _commands_loop(self):
        """Subscribe to the syncer COMMANDS channel (reference:
        ray_syncer.h:83) — currently: drain/undrain this node."""
        from ray_tpu_torch._private.gcs import GcsSubscriber

        sub = None
        while not self._shutdown:
            try:
                if sub is None:
                    sub = GcsSubscriber(self.gcs_address, ["commands"])
                events, _gap = sub.poll(timeout_s=10.0)
            except Exception:
                sub = None
                if self._shutdown:
                    return
                time.sleep(0.5)
                continue
            for e in events:
                target = e.get("node_id")
                if target is not None and target != self.node_id:
                    continue  # addressed to another node (None = all)
                if e.get("type") == "drain":
                    with self._lock:
                        self._draining = True
                        self._wake.notify_all()  # spill pending work now
                elif e.get("type") == "undrain":
                    with self._lock:
                        self._draining = False
                        self._wake.notify_all()

    def _object_events_loop(self):
        """Subscribe to object-location events; re-trigger wanted pulls.
        (Reference: the pull manager reacting to ownership-pubsub location
        updates, src/ray/object_manager/pull_manager.cc.)"""
        from ray_tpu_torch._private.gcs import GcsSubscriber

        sub = None
        while not self._shutdown:
            try:
                if sub is None:
                    sub = GcsSubscriber(self.gcs_address, ["objects"])
                events, gap = sub.poll(timeout_s=5.0)
            except Exception:
                sub = None
                if self._shutdown:
                    return
                time.sleep(0.5)
                continue
            with self._wanted_lock:
                if gap:
                    # events may have been missed (ring overrun, fresh
                    # subscription): re-try every armed pull but KEEP the
                    # arm — a pull that finds no location yet must stay
                    # watched for the real event
                    hit = list(self._wanted_oids)
                    disarm = False
                else:
                    hit = [e["oid"] for e in events
                           if not e.get("lost")
                           and e.get("oid") in self._wanted_oids]
                    disarm = True  # a location exists; the pull proceeds
                if disarm:
                    for oid in hit:
                        self._wanted_oids.discard(oid)
            for oid in hit:
                if self._store.contains(oid):
                    with self._wanted_lock:
                        self._wanted_oids.discard(oid)
                else:
                    self._transfer.trigger_pull(oid)

    def free_object(self, oid: bytes) -> bool:
        """Delete every copy of an object cluster-wide and clear its
        directory entries — used by lineage reconstruction to clear a
        sealed stale result (e.g. an error recorded for a task that is
        about to re-execute).  Reference: FreeObjects
        (src/ray/protobuf/object_manager.proto:60)."""
        try:
            locs = self.gcs.get_object_locations(oid)
        except Exception:
            locs = []
        for nid in locs:
            if nid == self.node_id:
                try:
                    self._store.delete(oid)
                except Exception:
                    pass
            else:
                node = self._lookup_node(nid)
                if node is None or not node.alive:
                    continue
                try:
                    self._links.one_shot_rpc(node.sched_socket, "free_local",
                                             {"oid": oid})
                except Exception:
                    pass
            try:
                self.gcs.remove_object_location(oid, nid)
            except Exception:
                pass
        # the caller is about to re-create it; drop any lost tombstone
        try:
            self.gcs.clear_object_lost(oid)
        except Exception:
            pass
        return True

    # ------------------------------------------------------------------
    # Cluster: peer forwarding + liveness (reference: ray_syncer resource
    # broadcast ray_syncer.h:83 + gcs_health_check_manager.cc, collapsed
    # into one heartbeat/reconcile loop per scheduler)
    # ------------------------------------------------------------------
    def _heartbeat_loop(self):
        while not self._shutdown:
            try:
                with self._lock:
                    # a draining node advertises NOTHING: peers stop
                    # spilling to it while local work finishes
                    available = {} if self._draining \
                        else self._res_snapshot()
                    queued = len(self._pending)
                if self._raylet_native:
                    # peers must see native backlog too, or their
                    # balancers would spill onto an already-loaded node
                    try:
                        queued += self._node_srv.raylet_stats()["pending"]
                    except Exception:
                        pass
                self.gcs.heartbeat(self.node_id, available, queued)
                try:
                    m = _self_metrics()
                    m["queue_depth"].set(queued)
                    m["backlog"].set(
                        queued, {"node": self.node_id.hex()[:12]})
                except Exception:
                    pass
                if self.is_head:
                    self.gcs.check_node_health()
                nodes = {n.node_id: n for n in self.gcs.list_nodes()}
                self._cluster_nodes = nodes
                self._load_cache = None  # fresh view: re-snapshot load
                alive = {i for i, n in nodes.items() if n.alive}
                self._has_peers = bool(alive - {self.node_id})
                newly_dead = self._known_alive - alive
                self._known_alive = alive
                for nid in newly_dead:
                    if nid != self.node_id:
                        self._on_node_dead(nid)
                if alive - {self.node_id}:
                    # remote work may now be schedulable (or newly arrived
                    # capacity may unblock the queue)
                    with self._lock:
                        self._wake.notify_all()
                if self._raylet_native:
                    # Plain tasks dispatch in C++ on every node; only a
                    # draining node routes submits to the policy path
                    # (which refuses/forwards them).
                    accept = not self._draining
                    if accept != self._lane_accept:
                        self._lane_accept = accept
                        self._node_srv.raylet_set_accept(accept)
                    if not accept:
                        # drain: reclaim the queue so the policy path can
                        # spill it to peers
                        self._steal_native_pending()
                    elif alive - {self.node_id}:
                        # saturated? move excess backlog to the Python
                        # policy path, which spills it to peers with
                        # advertised free capacity
                        self._balance_native_backlog(nodes, alive)
                    self._maybe_grow_native()
                    with self._lock:
                        # keep the event table/export pipeline current
                        self._merge_native_events_locked()
                self._flush_gcs_task_events()
                now = time.monotonic()
                if now - getattr(self, "_last_pg_reconcile", 0.0) > 5.0:
                    self._last_pg_reconcile = now
                    self._reconcile_pgs()
            except Exception:
                if not self._shutdown:
                    traceback.print_exc()
            time.sleep(self._hb_interval
                       if len(self._known_alive) > 1
                       else 2 * self._hb_interval)

    def _forward(self, spec: TaskSpec, node_id: bytes) -> bool:
        """Hand a pending spec to another node (caller holds the lock).

        The ORIGIN (first forwarder) owns recovery for the spec: it keeps
        the _forwarded record, receives spilled_done on completion, and
        requeues on target-node death.  A relay hop (re-spill of a spec
        that already has an origin) records nothing and instead tells the
        origin where the spec moved, so the origin's record tracks the
        node actually executing it.  (In the narrow race where a relay
        dies after sending the spec onward but before the origin processes
        spill_moved, the origin may requeue a task that also runs at the
        new target — same at-least-once window the reference accepts for
        retryable tasks.)
        """
        relay = spec.origin_node is not None and spec.origin_node != self.node_id
        if not relay:
            spec.origin_node = self.node_id
        if not self._links.send(node_id, {"t": "submit_spilled", "spec": spec}):
            if not relay:
                spec.origin_node = None
            return False
        self._task_index.pop(spec.task_id, None)
        # terminal state HERE (the executing node records the real
        # lifecycle); FORWARDED entries are evictable and filtered out of
        # cross-node task aggregation to avoid double counting
        self._record_task_event_locked(spec, "FORWARDED")
        if relay:
            self._links.send(spec.origin_node, {
                "t": "spill_moved", "task_id": spec.task_id,
                "node": node_id})
        else:
            self._forwarded[spec.task_id] = (node_id, spec)
        # Push locally-present args ahead of the task (reference:
        # push_manager.cc) so the target's workers skip the pull round
        # trip; best-effort — the pull path still covers misses.
        deps = getattr(spec, "dependencies", None)
        if deps:
            target = self._cluster_nodes.get(node_id)
            for dep_oid in deps:
                try:
                    if self._store.contains(dep_oid):
                        self._transfer.push(dep_oid, target)
                except Exception:
                    pass
        if _DEBUG_SCHED:
            _dbg(f"forward {spec.kind} {spec.name} -> {node_id.hex()[:8]}"
                 f"{' (relay)' if relay else ''}")
        return True

    def _notify_origin(self, spec: TaskSpec):
        self._native_spilled.pop(spec.task_id, None)
        if spec.origin_node and spec.origin_node != self.node_id:
            self._links.send(spec.origin_node,
                             {"t": "spilled_done", "task_id": spec.task_id})

    def _on_node_dead(self, node_id: bytes):
        """Reconcile after a peer died: recover forwarded specs; on the
        head, restart (or fail) actors that lived there (reference:
        gcs_actor_manager.cc:1319 OnActorDead/RestartActor)."""
        self._links.drop(node_id)
        with self._lock:
            orphaned = [(tid, spec) for tid, (nid, spec)
                        in self._forwarded.items() if nid == node_id]
            for tid, spec in orphaned:
                del self._forwarded[tid]
                spec.origin_node = None
                spec.spill_count = 0
                # A forwarded spec was lost at the SCHEDULING level — the
                # target died holding it, possibly before ever leasing a
                # worker — so requeue without charging retries_left
                # (reference: lease failures retry placement regardless of
                # max_retries; only execution-level deaths consume a
                # retry).  If the peer had already started the task this
                # re-runs it once — the same at-least-once window the
                # relay race documents in _forward.
                self._pending.appendleft(spec)
                self._task_index[spec.task_id] = spec
            self._wake.notify_all()
        if not self.is_head:
            return
        # head: restart actors that lived on the dead node
        try:
            actors = self.gcs.list_actors()
        except Exception:
            return
        for info in actors:
            if info.node_id != node_id or info.state == gcs_mod.DEAD:
                continue
            restarts_ok = (info.max_restarts == -1
                           or info.num_restarts < info.max_restarts)
            if restarts_ok:
                self.gcs.update_actor(info.actor_id,
                                      state=gcs_mod.RESTARTING,
                                      num_restarts=info.num_restarts + 1,
                                      worker_id=None, node_id=None,
                                      addr=None)
                creation = self._creation_spec_for(info.actor_id)
                if creation is not None:
                    self.submit_spilled(creation)
            else:
                self.gcs.update_actor(
                    info.actor_id, state=gcs_mod.DEAD,
                    death_cause=f"node {node_id.hex()[:8]} died")
                self._cleanup_actor_kv(info.actor_id)

    # ------------------------------------------------------------------
    # Worker lifecycle events
    # ------------------------------------------------------------------
    def _on_worker_blocked(self, worker: WorkerState,
                           task_id: Optional[bytes] = None):
        with self._lock:
            worker.blocked_count += 1
            # Only CPU is released while blocked: GPUs (and custom
            # resources) stay held because device state survives the block —
            # same rule as the reference (CPU released, GPU kept).
            cpu = worker.held_resources.get("CPU", 0)
            if worker.blocked_count == 1 and cpu:
                worker.blocked_resources = {"CPU": cpu}
                worker.blocked_pg = worker.held_pg
                worker.held_resources = {
                    k: v for k, v in worker.held_resources.items() if k != "CPU"
                }
                if worker.held_pg is not None:
                    pg_id, bundle = worker.held_pg
                    pg = self._pgs.get(pg_id)
                    if pg is not None:
                        pg.available[bundle]["CPU"] = (
                            pg.available[bundle].get("CPU", 0) + cpu)
                else:
                    self._res_release({"CPU": cpu})
                self._wake.notify_all()
            if self._raylet_native and worker.blocked_count == 1 \
                    and worker.conn_id is not None:
                # a native-lane task blocking in get(): C++ tracks its CPU.
                # Pass the blocking task's id so a stale notification cannot
                # release the CPU of a NEWER task dispatched to the same
                # conn after C++ consumed this task's DONE frame.
                self._node_srv.raylet_block_worker(
                    worker.conn_id, task_id or b"")

    def _on_worker_unblocked(self, worker: WorkerState,
                             task_id: Optional[bytes] = None):
        with self._lock:
            worker.blocked_count = max(0, worker.blocked_count - 1)
            if worker.blocked_count == 0 and worker.blocked_resources:
                # Re-acquire unconditionally; transient oversubscription is
                # accepted (it self-corrects as tasks finish).
                res, pg = worker.blocked_resources, worker.blocked_pg
                worker.blocked_resources, worker.blocked_pg = {}, None
                for k, v in res.items():
                    worker.held_resources[k] = (
                        worker.held_resources.get(k, 0) + v)
                worker.held_pg = pg
                if pg is not None:
                    pg_state = self._pgs.get(pg[0])
                    if pg_state is not None:
                        for k, v in res.items():
                            pg_state.available[pg[1]][k] = (
                                pg_state.available[pg[1]].get(k, 0) - v)
                else:
                    self._res_force_acquire(res)
            if self._raylet_native and worker.blocked_count == 0 \
                    and worker.conn_id is not None:
                self._node_srv.raylet_unblock_worker(
                    worker.conn_id, task_id or b"")

    def _on_task_done(self, worker: WorkerState, msg: dict):
        task_id = msg["task_id"]
        with self._lock:
            spec = worker.in_flight.pop(task_id, None)
            self._task_index.pop(task_id, None)
            if spec is None:
                return
            self._record_task_event(
                spec, "FINISHED" if msg["ok"] else "FAILED", ok=msg["ok"])
            if spec.kind == ACTOR_CREATION:
                if _DEBUG_SCHED:
                    _dbg(f"done CREATE actor={spec.actor_id.hex()[:8]} "
                         f"worker={worker.worker_id.hex()[:8]} "
                         f"ok={msg['ok']} err={msg.get('error')}")
                if msg["ok"]:
                    self.gcs.update_actor(spec.actor_id, state=gcs_mod.ALIVE,
                                          worker_id=worker.worker_id,
                                          node_id=self.node_id,
                                          addr=worker.server_addr)
                else:
                    self.gcs.update_actor(spec.actor_id, state=gcs_mod.DEAD,
                                          death_cause=msg.get("error"))
                    self._cleanup_actor_kv(spec.actor_id)
                    self._release_worker_grants(worker)
                    worker.actor_id = None
                    self._actor_workers.pop(spec.actor_id, None)
                    worker.idle = True
                    self._native_release_worker(worker)
            elif spec.kind == TASK:
                self._release_worker_grants(worker)
                if msg.get("retire"):
                    # the worker exits after a GPU task that left a CUDA
                    # context (worker_main._retire_after): never reuse it
                    worker.idle = False
                    worker.retiring = True
                else:
                    worker.idle = True
                    self._native_release_worker(worker)
            # ACTOR_METHOD: worker stays bound to the actor; nothing to release.
            self._wake.notify_all()
        self._notify_origin(spec)

    def _on_native_memory_pressure(self, used: int, total: int):
        """0x7e marker from the C++ monitor: run the kill policy (the
        native side already applied interval + cooldown gating).  A
        straggler marker emitted before a disable is dropped, and a
        crossing that found no victim clears the native cooldown so the
        next interval can respond while memory keeps climbing."""
        if not getattr(self, "_mm_native_enabled", False):
            return  # marker raced a disable: never kill on stale signal
        try:
            killed = self._handle_memory_pressure(
                used, total, self._mm_threshold)
            self._node_srv.memory_monitor_ack(bool(killed))
        except Exception:
            traceback.print_exc()  # pressure handling must not kill serve

    def _set_native_memory_monitor(self, threshold: float,
                                   interval_s: float, cooldown_s: float):
        """(En/dis)able the C++ monitor; the enabled flag gates marker
        handling so a straggler emitted pre-disable is dropped."""
        self._mm_native_enabled = threshold > 0
        self._node_srv.memory_monitor_enable(threshold, interval_s,
                                             cooldown_s)

    def _handle_memory_pressure(self, used: int, total: int,
                                threshold: float) -> bool:
        """Kill ONE worker chosen by the retriable-FIFO policy (reference:
        raylet worker_killing_policy_retriable_fifo.cc) instead of letting
        the kernel OOM-kill the scheduler or store daemon.  Returns True
        if a kill happened; the normal worker-death path then requeues the
        victim's retriable tasks."""
        from ray_tpu_torch._private.memory_monitor import choose_victim, process_rss

        with self._lock:
            if self._raylet_native:
                # fold native-lane busyness into the victim policy's view
                try:
                    counts = self._node_srv.raylet_native_inflight()
                except Exception:
                    counts = {}
                for w in self._workers.values():
                    w.native_inflight = (counts.get(w.conn_id, 0)
                                         if w.conn_id is not None else 0)
            victim = choose_victim(self._workers.values())
            if victim is None:
                return False
            rss = process_rss(victim.proc.pid)
            self._oom_kills[victim.worker_id] = {
                "rss": rss, "used": used, "total": total,
                "threshold": threshold,
            }
        if _DEBUG_SCHED:
            _dbg(f"OOM kill worker {victim.worker_id.hex()[:8]} "
                 f"rss={rss} node={used}/{total}")
        try:
            victim.proc.kill()  # SIGKILL: a thrashing worker may not react
        except OSError:
            return False
        return True

    def _on_worker_death(self, worker: WorkerState):
        with self._lock:
            if not worker.alive:
                return
            if self._shutdown:
                # node-level teardown: do NOT consume actor restart budget
                # or retry tasks here — the head's node-death reconcile owns
                # recovery for this node's actors and forwarded work
                return
            worker.alive = False
            worker.idle = False
            self._profiler_conns.pop(worker.worker_id, None)
            # Drop the process's last app-metrics snapshot: a dead source
            # must not be scraped as live data (and the dict must not grow
            # under worker churn).
            if hasattr(self, "_app_metrics"):
                self._app_metrics.pop(worker.worker_id, None)
            if _DEBUG_SCHED:
                _dbg(f"worker DEATH {worker.worker_id.hex()[:8]} "
                     f"actor={worker.actor_id.hex()[:8] if worker.actor_id else None} "
                     f"inflight={[s.name for s in worker.in_flight.values()]}")
            self._release_worker_grants(worker)
            in_flight = list(worker.in_flight.values())
            worker.in_flight.clear()
            self._workers.pop(worker.worker_id, None)

            dead_actor = worker.actor_id
            if dead_actor is not None:
                # Guarded: a transient GCS failure (injected chaos, head
                # mid-restart) during actor-death bookkeeping must not
                # abort this handler — the in-flight requeue below is what
                # keeps the rest of the worker's tasks alive.  The node
                # heartbeat reconcile re-drives actor state on the next
                # tick if these GCS writes were lost.
                try:
                    self._actor_workers.pop(dead_actor, None)
                    info = self.gcs.get_actor(dead_actor)
                    restarts_ok = (
                        info is not None
                        and info.state != gcs_mod.DEAD
                        and (info.max_restarts == -1
                             or info.num_restarts < info.max_restarts)
                    )
                    if restarts_ok:
                        self.gcs.update_actor(dead_actor,
                                              state=gcs_mod.RESTARTING,
                                              num_restarts=info.num_restarts + 1,
                                              worker_id=None, addr=None)
                        creation = self._creation_spec_for(dead_actor)
                        if creation is not None:
                            self._pending.appendleft(creation)
                            self._task_index[creation.task_id] = creation
                    else:
                        self.gcs.update_actor(dead_actor, state=gcs_mod.DEAD,
                                              death_cause="worker died")
                        self._cleanup_actor_kv(dead_actor)
                        for spec in [s for s in self._pending.routed
                                     if s.actor_id == dead_actor]:
                            self._pending.remove(spec)
                            self._fail_task(spec, ActorDiedError(
                                "The actor died unexpectedly before "
                                "finishing this task."))
                except (OSError, ConnectionError):
                    pass

            oom = self._oom_kills.pop(worker.worker_id, None)
            for spec in in_flight:
                if spec.task_id in self._cancelled:
                    self._cancelled.discard(spec.task_id)
                    self._fail_task(spec, TaskCancelledError(
                        f"task {spec.name} was force-cancelled"))
                elif spec.kind != ACTOR_METHOD and spec.retries_left > 0:
                    spec.retries_left -= 1
                    self._pending.appendleft(spec)
                    self._task_index[spec.task_id] = spec
                elif oom is not None and spec.kind != ACTOR_METHOD:
                    from ray_tpu_torch.exceptions import OutOfMemoryError

                    self._fail_task(spec, OutOfMemoryError(
                        f"task {spec.name} was killed by the node memory "
                        f"monitor: worker rss={oom['rss'] >> 20}MB, node "
                        f"memory {oom['used'] >> 20}/{oom['total'] >> 20}MB "
                        f"exceeded the {oom['threshold']:.0%} threshold; "
                        f"reduce per-task memory or raise "
                        f"RTPU_MEMORY_MONITOR_THRESHOLD"))
                else:
                    err = (ActorDiedError("actor died while executing method")
                           if spec.kind == ACTOR_METHOD
                           else WorkerCrashedError(
                               f"worker died executing {spec.name}"))
                    self._fail_task(spec, err)
            self._wake.notify_all()
        # GCS worker-table update OUTSIDE the lock: a blocking RPC (head
        # mid-restart reconnects for up to ~10s) must not stall dispatch
        try:
            self.gcs.update_worker(worker.worker_id, {
                "state": "DEAD", "end_ts": time.time(),
                "exit_detail": ("worker retired after a GPU task"
                                if worker.retiring
                                else "worker process exited")})
        except Exception:
            pass
        if worker.retiring:
            return  # an intended exit, not an incident
        try:
            self.bank_events([{
                "kind": "worker.oom_kill" if oom else "worker.death",
                "severity": "error" if oom else "warning",
                "message": (f"worker {worker.worker_id.hex()[:12]} "
                            + ("killed by memory monitor" if oom
                               else "died")),
                "data": {
                    "worker_id": worker.worker_id.hex(),
                    "actor_id": dead_actor.hex() if dead_actor else "",
                    "in_flight": len(in_flight),
                    **({"rss": oom["rss"], "node_used": oom["used"]}
                       if oom else {}),
                },
            }])
        except Exception:
            pass

    def _cleanup_actor_kv(self, actor_id: bytes):
        """An actor is PERMANENTLY dead: drop its creation spec and, when
        no other registered actor shares its class blob, the blob mirror —
        otherwise every actor ever created pins its pickled class in the
        head (and in persisted snapshots) forever."""
        import pickle

        try:
            blob = self.gcs.kv_get("actor_creation", actor_id)
            self.gcs.kv_del("actor_creation", actor_id)
            if blob is None:
                return
            fn_id = pickle.loads(blob).fn_id
            for other in self.gcs.kv_keys("actor_creation"):
                other_blob = self.gcs.kv_get("actor_creation", other)
                if other_blob is not None and \
                        pickle.loads(other_blob).fn_id == fn_id:
                    return  # class blob still referenced
            self.gcs.kv_del("fn_blob", fn_id)
        except Exception:
            pass  # cleanup is best-effort

    def recover_restored_actors(self):
        """After a head restart with a persisted GCS: resubmit creation for
        every actor the restore marked RESTARTING (their creation specs
        live in the persisted KV).  Called exactly once by the head node's
        bootstrap — reference: gcs_actor_manager.cc restart-on-recovery."""
        if not self.is_head:
            return
        try:
            actors = self.gcs.list_actors()
        except Exception:
            return
        for info in actors:
            if info.state != gcs_mod.RESTARTING or info.node_id is not None:
                continue
            creation = self._creation_spec_for(info.actor_id)
            if creation is not None:
                self.submit_spilled(creation)

    def _creation_spec_for(self, actor_id: bytes) -> Optional[TaskSpec]:
        """Rebuild the creation TaskSpec for restart from GCS KV."""
        blob = self.gcs.kv_get("actor_creation", actor_id)
        if blob is None:
            return None
        import pickle

        spec: TaskSpec = pickle.loads(blob)
        spec.task_id = os.urandom(16)
        spec.return_ids = []  # restart produces no new creation return
        return spec

    def _release_worker_grants(self, worker: WorkerState):
        if worker.held_pg is not None:
            pg_id, bundle = worker.held_pg
            pg = self._pgs.get(pg_id)
            if pg is not None:
                for k, v in worker.held_resources.items():
                    pg.available[bundle][k] = pg.available[bundle].get(k, 0) + v
        else:
            self._res_release(worker.held_resources)
        worker.held_resources = {}
        worker.held_pg = None
        if worker.held_chips:
            self._free_chips.extend(worker.held_chips)
            self._free_chips.sort()
            worker.held_chips = []
        if worker.held_share is not None:
            chip, share = worker.held_share
            left = self._chip_shares.get(chip, 0.0) - share
            if left <= 1e-9:
                self._chip_shares.pop(chip, None)
                self._free_chips.append(chip)
                self._free_chips.sort()
            else:
                self._chip_shares[chip] = left
            worker.held_share = None

    def _grant_share(self, share: float) -> Optional[int]:
        """The card for a fractional GPU request: the fullest partly used
        card it fits on, else a free card; None when neither exists."""
        fits = [c for c, used in self._chip_shares.items()
                if used + share <= 1.0 + 1e-9]
        if fits:
            chip = max(fits, key=lambda c: (self._chip_shares[c], -c))
        elif self._free_chips:
            chip = self._free_chips.pop(0)
            self._chip_shares[chip] = 0.0
        else:
            return None
        self._chip_shares[chip] += share
        return chip

    def _fail_task(self, spec: TaskSpec, exc: Exception):
        self._record_task_event(spec, "FAILED", ok=False)
        for oid in spec.return_ids:
            if store_error_best_effort(self._store, oid, exc, ""):
                self.note_sealed(oid)  # callers on other nodes pull errors
            else:
                traceback.print_exc()
                print(f"FATAL: could not record error for {oid.hex()[:12]}; "
                      f"gets on it will hang", flush=True)
        self._notify_origin(spec)

    # ------------------------------------------------------------------
    # Local dispatch loop (reference: local_task_manager.cc)
    # ------------------------------------------------------------------
    def _schedule_loop(self):
        while True:
            try:
                with self._lock:
                    while (not self._shutdown
                           and not self._try_schedule_locked()):
                        self._wake.wait(timeout=1.0)
                    if self._shutdown:
                        return
            except Exception:
                # The loop must survive any per-task error (bad PG index,
                # races with dying workers, ...) — a dead scheduling loop
                # hangs the whole node silently.
                traceback.print_exc()
                time.sleep(0.05)

    def _pg_bundle_owner(self, pg_id: bytes,
                         bundle: int) -> tuple[bool, Optional[bytes]]:
        """(known, node) for a PG bundle, with a short TTL cache (same
        rationale as _actor_info_cached: called under the lock).

        known=False means the GCS was unreachable and nothing is cached —
        callers must requeue, NOT fail (a transient socket error is not
        "the PG does not exist").  known=True with node=None is the
        authoritative "no such PG/bundle"."""
        now = time.monotonic()
        cached = self._pg_cache.get(pg_id)
        if cached is None or now - cached[0] >= 0.5:
            try:
                info = self.gcs.get_pg(pg_id)
            except Exception:
                if cached is None:
                    return False, None  # transient: leave cache untouched
                info = cached[1]
            if len(self._pg_cache) > 4096:
                self._pg_cache = {
                    p: v for p, v in self._pg_cache.items()
                    if now - v[0] < 1.0}
            self._pg_cache[pg_id] = (now, info)
            cached = self._pg_cache[pg_id]
        info = cached[1]
        if info is None:
            return True, None
        assignment = info["assignment"]
        if bundle < 0 or bundle >= len(assignment):
            return True, None
        return True, assignment[bundle]

    def _actor_info_cached(self, actor_id: bytes):
        """Actor placement with a short TTL cache: on non-head nodes a GCS
        lookup is a socket round trip, and this runs per pending method per
        pass while holding the scheduler lock.  The TTL only delays when a
        method stream NOTICES a placement change (routing corrects itself
        next refresh); locally-hosted actors short-circuit via
        _actor_workers before this is consulted."""
        now = time.monotonic()
        cached = self._actor_info_cache.get(actor_id)
        if cached is not None and now - cached[0] < 0.25:
            return cached[1]
        try:
            info = self.gcs.get_actor(actor_id)
        except Exception:
            return cached[1] if cached is not None else None
        self._actor_info_cache[actor_id] = (now, info)
        if info is not None and info.state == gcs_mod.DEAD:
            # terminal: keep one tombstone entry, drop stale neighbors
            if len(self._actor_info_cache) > 4096:
                self._actor_info_cache = {
                    a: v for a, v in self._actor_info_cache.items()
                    if now - v[0] < 1.0}
        return info

    def _try_schedule_locked(self) -> bool:
        """Dispatch as many pending tasks as possible; True if progress made.

        Two passes over PendingQueues: the ROUTED lane (actor methods,
        PGs, labels, affinity) is scanned spec-by-spec — placement is a
        property of each spec.  The SHAPE lane then dispatches plain
        tasks bucket-by-bucket: schedulability there depends only on the
        resource ask, so one blocked bucket head parks the whole shape
        (reference: scheduling-class queues in cluster_task_manager.h)
        and a million-deep backlog costs O(#shapes), not O(#tasks), per
        wakeup."""
        progress = False
        remaining: deque[TaskSpec] = deque()
        routed = self._pending.routed
        while routed:
            spec = routed.popleft()
            if spec.kind == ACTOR_METHOD:
                worker_id = self._actor_workers.get(spec.actor_id)
                info = self._actor_info_cached(spec.actor_id)
                if info is None:
                    # Never registered (e.g. creation rejected): fail fast
                    # rather than queueing forever.
                    self._task_index.pop(spec.task_id, None)
                    self._fail_task(spec, ActorDiedError(
                        f"actor {spec.actor_id.hex()[:8]} does not exist "
                        f"(creation failed or was rejected)"))
                    progress = True
                    continue
                if info.state == gcs_mod.DEAD:
                    self._task_index.pop(spec.task_id, None)
                    self._fail_task(spec, ActorDiedError(
                        f"actor {spec.actor_id.hex()[:8]} is dead: "
                        f"{info.death_cause}"))
                    progress = True
                    continue
                if (info.node_id is not None
                        and info.node_id != self.node_id):
                    # actor lives on another node: forward the call there
                    if self._forward(spec, info.node_id):
                        progress = True
                    else:
                        remaining.append(spec)
                    continue
                if worker_id is None or worker_id not in self._workers:
                    remaining.append(spec)  # actor still being (re)created
                    continue
                w = self._workers[worker_id]
                if w.conn is None:
                    remaining.append(spec)
                    continue
                w.in_flight[spec.task_id] = spec
                if _DEBUG_SCHED:
                    _dbg(f"dispatch METHOD {spec.name} "
                         f"actor={spec.actor_id.hex()[:8]} "
                         f"-> worker={worker_id.hex()[:8]}")
                self._dispatch(w, spec)
                progress = True
                continue

            if spec.pg_id is not None:
                # PG tasks run on the node holding their bundle; if that
                # is not us, forward there (bundle->node map in the GCS)
                pg = self._pgs.get(spec.pg_id)
                bundle = spec.pg_bundle if spec.pg_bundle is not None else 0
                if pg is None or bundle not in pg.bundles:
                    known, owner = self._pg_bundle_owner(spec.pg_id, bundle)
                    if not known:
                        remaining.append(spec)  # transient GCS error
                        continue
                    if owner is None:
                        self._task_index.pop(spec.task_id, None)
                        self._fail_task(spec, WorkerCrashedError(
                            f"placement group {spec.pg_id.hex()[:8]} does "
                            f"not exist (removed or never created)"))
                        progress = True
                        continue
                    owner_node = self._cluster_nodes.get(owner)
                    if owner_node is not None and not owner_node.alive:
                        # the bundle's node died and its reservation is
                        # gone; fail with a clear cause (the reference
                        # reschedules lost bundles — we surface the loss)
                        self._task_index.pop(spec.task_id, None)
                        self._fail_task(spec, WorkerCrashedError(
                            f"placement group {spec.pg_id.hex()[:8]} "
                            f"bundle {bundle} was lost: its node "
                            f"{owner.hex()[:8]} died"))
                        progress = True
                        continue
                    if owner != self.node_id:
                        if self._forward(spec, owner):
                            progress = True
                        else:
                            remaining.append(spec)
                        continue
                    # owner is us but reservation not here yet: wait
                    remaining.append(spec)
                    continue
                # Bundle is here: a request larger than the bundle's TOTAL
                # capacity can never be satisfied — fail now instead of
                # requeueing forever (reference raises at submission).
                cap = pg.bundles[bundle]
                infeasible = {
                    k: v for k, v in (spec.resources or {}).items()
                    if v > cap.get(k, 0)}
                if infeasible:
                    self._task_index.pop(spec.task_id, None)
                    self._fail_task(spec, ValueError(
                        f"task {spec.name} requests {infeasible} but "
                        f"placement group bundle {bundle} only has {cap}"))
                    progress = True
                    continue
            if spec.label_selector and not strategies_mod.labels_match(
                    spec.label_selector, self.labels):
                # hard label selector this node fails: place elsewhere
                # (reference: node-label policy,
                # scheduling/policy/node_label_scheduling_policy.cc)
                target = cluster_mod.pick_spill_target(
                    spec, self.node_id, self.total_resources,
                    self._cluster_nodes)
                if target is not None and self._forward(spec, target):
                    progress = True
                else:
                    # no matching node right now: stay pending (a labeled
                    # node may join), like the reference's infeasible queue
                    remaining.append(spec)
                continue
            if (spec.node_affinity is not None
                    and spec.node_affinity != self.node_id):
                # NodeAffinitySchedulingStrategy: run on the named node if
                # it is alive (reference: scheduling_strategies.py:41).
                # The cached view lags new registrations by a heartbeat
                # tick, so miss -> authoritative GCS lookup (rare path).
                target = self._lookup_node(spec.node_affinity)
                if target is not None and target.alive:
                    if self._forward(spec, spec.node_affinity):
                        progress = True
                    else:
                        remaining.append(spec)
                    continue
                if not spec.affinity_soft:
                    self._task_index.pop(spec.task_id, None)
                    self._fail_task(spec, WorkerCrashedError(
                        f"node affinity target "
                        f"{spec.node_affinity.hex()[:8]} is dead"))
                    progress = True
                    continue
                # soft affinity to a dead node: fall through, run anywhere
            if self._draining:
                # drain: push forwardable work off this node first; only
                # what has nowhere to go (or is pinned here) runs locally
                target = cluster_mod.pick_spill_target(
                    spec, self.node_id, self.total_resources,
                    self._cluster_nodes)
                if target is not None and self._forward(spec, target):
                    progress = True
                    continue
            granted = self._acquire_resources(spec)
            if granted is None:
                target = cluster_mod.pick_spill_target(
                    spec, self.node_id, self.total_resources,
                    self._cluster_nodes)
                if target is not None and self._forward(spec, target):
                    progress = True
                else:
                    remaining.append(spec)
                continue
            w = self._find_idle_worker()
            if w is None:
                self._return_resources(spec, granted)
                remaining.append(spec)
                self._pool.maybe_grow()
                continue
            w.idle = False
            w.held_resources = granted
            w.held_pg = ((spec.pg_id, spec.pg_bundle)
                         if spec.pg_id is not None else None)
            w.in_flight[spec.task_id] = spec
            if spec.kind == ACTOR_CREATION:
                w.actor_id = spec.actor_id
                self._actor_workers[spec.actor_id] = w.worker_id
                self.gcs.update_actor(spec.actor_id, state=gcs_mod.PENDING_CREATION)
                if _DEBUG_SCHED:
                    _dbg(f"dispatch CREATE {spec.name} "
                         f"actor={spec.actor_id.hex()[:8]} "
                         f"-> worker={w.worker_id.hex()[:8]}")
            self._dispatch(w, spec)
            progress = True
        self._pending.routed = remaining
        # -- shape lane: plain tasks, one feasibility decision per shape --
        for _key, q in self._pending.shape_buckets():
            while q:
                spec = q[0]
                if self._draining:
                    # drain: push forwardable work off this node first
                    target = cluster_mod.pick_spill_target(
                        spec, self.node_id, self.total_resources,
                        self._cluster_nodes)
                    if target is not None:
                        q.popleft()
                        if self._forward(spec, target):
                            progress = True
                            continue
                        q.appendleft(spec)  # peer send failed: run here
                    elif (spec.spill_count < self._max_spills
                          and cluster_mod.peer_could_take(
                              spec, self.node_id, self._cluster_nodes)):
                        # no peer has room RIGHT NOW, but one could take
                        # this shape once it frees up: hold it pending
                        # (the reference raylet refuses new leases while
                        # draining) instead of starting work here.  The
                        # loop's 1s wait retries against a fresher view.
                        break
                granted = self._acquire_resources(spec)
                if granted is None:
                    target = cluster_mod.pick_spill_target(
                        spec, self.node_id, self.total_resources,
                        self._cluster_nodes)
                    if target is not None:
                        q.popleft()
                        if self._forward(spec, target):
                            progress = True
                            continue
                        q.appendleft(spec)
                    # this shape can't start here now — every spec
                    # behind the head would fail the same check
                    break
                w = self._find_idle_worker()
                if w is None:
                    self._return_resources(spec, granted)
                    self._pool.maybe_grow()
                    # no idle worker: no shaped spec can dispatch
                    self._pending.prune_empty()
                    return progress
                q.popleft()
                w.idle = False
                w.held_resources = granted
                w.held_pg = None
                w.in_flight[spec.task_id] = spec
                self._dispatch(w, spec)
                progress = True
        self._pending.prune_empty()
        return progress

    def _acquire_resources(self, spec: TaskSpec) -> Optional[dict]:
        res = spec.resources or {}
        if spec.pg_id is not None:
            pg = self._pgs.get(spec.pg_id)
            if pg is None:
                return None
            bundle = spec.pg_bundle if spec.pg_bundle is not None else 0
            avail = pg.available.get(bundle)
            if avail is None:  # bundle lives on another node
                return None
            if any(avail.get(k, 0) < v for k, v in res.items()):
                return None
            for k, v in res.items():
                avail[k] -= v
            return dict(res)
        if not self._res_try_acquire(res):
            return None
        return dict(res)

    def _return_resources(self, spec: TaskSpec, granted: dict):
        if spec.pg_id is not None:
            pg = self._pgs.get(spec.pg_id)
            if pg is not None:
                bundle = spec.pg_bundle if spec.pg_bundle is not None else 0
                for k, v in granted.items():
                    pg.available[bundle][k] = pg.available[bundle].get(k, 0) + v
        else:
            self._res_release(granted)

    def _dispatch(self, w: WorkerState, spec: TaskSpec):
        self._record_task_event(spec, "RUNNING", worker_id=w.worker_id)
        ev = self._task_events.get(spec.task_id)
        if ev is not None and ev["start_ts"] and ev["submitted_ts"]:
            try:
                m = _self_metrics()
                m["queue_wait"].observe(
                    max(0.0, ev["start_ts"] - ev["submitted_ts"]))
                m["dispatched"].inc()
            except Exception:
                pass
        gpus = spec.resources.get("GPU", 0) if spec.resources else 0
        env: dict[str, str] = {}
        n_chips = int(gpus)
        if n_chips >= 1 and len(self._free_chips) >= n_chips:
            chips = [self._free_chips.pop(0) for _ in range(n_chips)]
            w.held_chips.extend(chips)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in chips)
        elif 0 < gpus < 1:
            chip = self._grant_share(gpus)
            if chip is not None:
                w.held_share = (chip, gpus)
                env["CUDA_VISIBLE_DEVICES"] = str(chip)
        try:
            w.conn.send({"t": "task", "spec": spec, "env": env})
        except OSError:
            # Worker died between selection and send; its reader thread will
            # run _on_worker_death, which retries/fails this in-flight spec.
            pass
