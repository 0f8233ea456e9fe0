"""Global control state (GCS): tables + socket service.

Counterpart of the reference's GCS server
(Ray's src/ray/gcs/gcs_server/gcs_server.cc): actor registry with a
lifecycle FSM, named-actor index, internal KV, node table with liveness
(gcs_health_check_manager.cc), per-node load view (the ray_syncer
RESOURCE_VIEW channel, src/ray/common/ray_syncer/ray_syncer.h:83), and the
object location directory (the ownership directory's role,
src/ray/object_manager/ownership_object_directory.cc, centralized here).

The head node hosts the tables in-process and serves them to other nodes
over a socket (``GcsServer``); non-head schedulers talk through
``GcsClient``, which implements the same method surface, so callers are
oblivious to which side of the socket they are on.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.protocol import (
    Connection,
    authenticate_server_side,
    connect_addr,
    is_tcp_addr,
    listener_addr,
)

# Actor lifecycle states (reference: src/ray/design_docs/actor_states.rst).
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"

# A node is declared dead after this many seconds without a heartbeat
# (reference: gcs_health_check_manager.cc failure threshold).
NODE_DEATH_TIMEOUT_S = float(os.environ.get("RTPU_NODE_DEATH_TIMEOUT_S", 5.0))


@wire.register_struct(1)
@dataclass
class ActorInfo:
    actor_id: bytes
    name: Optional[str] = None
    state: str = PENDING_CREATION
    worker_id: Optional[bytes] = None
    node_id: Optional[bytes] = None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: Optional[str] = None
    class_name: str = ""
    # direct-call endpoint of the hosting worker process (reference: the
    # actor's rpc::Address in gcs.proto ActorTableData) — callers push
    # method calls here, bypassing the node scheduler
    addr: Optional[str] = None


@wire.register_struct(2)
@dataclass
class NodeInfo:
    node_id: bytes
    resources: dict = field(default_factory=dict)
    alive: bool = True
    ts: float = field(default_factory=time.time)
    # socket addresses other nodes use to reach this node
    sched_socket: str = ""
    store_socket: str = ""
    # store daemon's TCP transfer listener ("host:port", "" = disabled):
    # the daemon-to-daemon object data plane (shm_store.cc)
    xfer_addr: str = ""
    is_head: bool = False
    # live load view, refreshed by heartbeats
    available: dict = field(default_factory=dict)
    queued: int = 0
    # static key->value node labels (NodeLabelSchedulingStrategy)
    labels: dict = field(default_factory=dict)


class Gcs:
    """In-memory control-plane tables, optionally persisted to disk.

    ``persist_path`` enables durability (reference: the Redis-backed
    store client, src/ray/gcs/store_client/redis_store_client.h:111, used
    for GCS fault tolerance): mutations snapshot the durable tables —
    actors, named actors, placement groups, KV — to the file (debounced,
    atomic rename), and a restarted head restores them, so registered
    actors/PGs/function blobs survive a head-process restart.  Node and
    object-location tables are deliberately NOT persisted: they describe
    live processes and re-populate from heartbeats/seals, exactly like
    the reference's reconnect-on-GCS-restart flow.
    """

    PERSIST_DEBOUNCE_S = 0.2

    EVENT_RING = 16384

    def __init__(self, persist_path: Optional[str] = None):
        if persist_path and persist_path.startswith("redis://"):
            # the Redis-backed store client lives in the native daemon
            # (gcs_server.cc RedisPersist); the Python fallback is file-only
            raise ValueError(
                "redis:// GCS persistence requires the native GCS daemon "
                "(unset RTPU_PYTHON_GCS)")
        self._lock = threading.RLock()
        # pubsub event log (reference: gcs_server/pubsub_handler.cc —
        # long-poll subscriptions over a bounded ring of change events)
        self._events: "deque[tuple[int, str, dict]]" = deque()
        self._next_seq = 1
        self._events_cond = threading.Condition(self._lock)
        self.actors: dict[bytes, ActorInfo] = {}
        self.named_actors: dict[str, bytes] = {}
        self.nodes: dict[bytes, NodeInfo] = {}
        self.kv: dict[tuple[str, bytes], bytes] = {}
        self.job_config: dict = {}
        # object_id -> set of node_ids holding a sealed copy
        self.object_locations: dict[bytes, set[bytes]] = {}
        # objects that HAD a sealed copy and lost every one (node death):
        # the owner's get() consults this to trigger lineage re-execution
        # instead of waiting forever (reference:
        # src/ray/core_worker/object_recovery_manager.h:43)
        self.lost_objects: set[bytes] = set()
        # pg_id -> {bundles, strategy, assignment: [node_id per bundle]}
        self.placement_groups: dict[bytes, dict] = {}
        # first-class job / worker / task-event tables (reference:
        # gcs_service.proto JobInfo:68 / WorkerInfo:363 / TaskInfo:860)
        self.jobs: dict[str, dict] = {}
        self.workers: dict[bytes, dict] = {}
        self.task_events: "deque[dict]" = deque()
        self._task_event_cap = int(
            os.environ.get("RTPU_GCS_TASK_EVENT_CAP", 1 << 16))
        self._persist_path = persist_path
        self._persist_timer: Optional[threading.Timer] = None
        if persist_path and os.path.exists(persist_path):
            self._restore()

    # -- persistence --------------------------------------------------------
    def _mutated(self):
        """Schedule a debounced snapshot (no-op without persist_path)."""
        if not self._persist_path:
            return
        with self._lock:
            if self._persist_timer is not None:
                return  # one pending snapshot covers this burst
            self._persist_timer = threading.Timer(
                self.PERSIST_DEBOUNCE_S, self._snapshot)
            self._persist_timer.daemon = True
            self._persist_timer.start()

    def _snapshot(self):
        with self._lock:
            self._persist_timer = None
            state = {
                "actors": dict(self.actors),
                "named_actors": dict(self.named_actors),
                "kv": dict(self.kv),
                "placement_groups": {
                    k: dict(v) for k, v in self.placement_groups.items()},
                "jobs": {k: dict(v) for k, v in self.jobs.items()},
                "workers": {k: dict(v) for k, v in self.workers.items()},
                "task_events": list(self.task_events),
            }
        tmp = self._persist_path + ".tmp"
        try:
            # Wire-codec snapshot (not pickle): the same file format the
            # native GCS daemon reads/writes, so head restarts can move
            # between the Python and C++ control planes.
            with open(tmp, "wb") as f:
                f.write(wire.encode(state))
            os.replace(tmp, self._persist_path)  # atomic swap
        except (OSError, wire.WireError):
            pass  # durability is best-effort; next mutation retries

    def _restore(self):
        try:
            with open(self._persist_path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        try:
            state = wire.decode(raw)
        except wire.WireError:
            # Pre-wire-codec snapshot (pickle).  The file is local state
            # this head wrote itself — trusted — so a one-time migration
            # load is safe; the next snapshot rewrites it in wire format.
            import pickle

            try:
                state = pickle.loads(raw)
            except Exception:
                return  # torn/corrupt snapshot: start empty
        except Exception:
            return
        if not isinstance(state, dict):
            return
        self.actors = state.get("actors", {})
        self.named_actors = state.get("named_actors", {})
        self.kv = state.get("kv", {})
        self.placement_groups = state.get("placement_groups", {})
        self.jobs = state.get("jobs", {})
        self.workers = state.get("workers", {})
        self.task_events = deque(state.get("task_events", []))
        # restored workers belonged to the previous incarnation's
        # processes — they are gone
        for w in self.workers.values():
            if w.get("state") != "DEAD":
                w["state"] = "DEAD"
                w["exit_detail"] = "GCS restarted; worker process lost"
        # Every restored actor lived on a node that predates this head
        # incarnation: mark restartable ones RESTARTING so the scheduler
        # recreates them, DEAD otherwise (reference:
        # gcs_actor_manager restart-on-GCS-recovery semantics).
        for info in self.actors.values():
            if info.state == DEAD:
                continue
            if info.max_restarts == -1 or info.num_restarts < \
                    info.max_restarts:
                info.state = RESTARTING
                info.num_restarts += 1
                info.worker_id = None
                info.node_id = None
                info.addr = None
            else:
                info.state = DEAD
                info.death_cause = "GCS restarted; actor not restartable"
                if info.name:  # free the name, like every DEAD transition
                    self.named_actors.pop(info.name, None)
        # the restore itself consumed restart budget / marked deaths: those
        # transitions must survive ANOTHER head crash
        self._mutated()

    # -- pubsub ------------------------------------------------------------
    def _publish(self, channel: str, payload: dict):
        """Append a change event (caller holds the lock)."""
        self._events.append((self._next_seq, channel, payload))
        self._next_seq += 1
        while len(self._events) > self.EVENT_RING:
            self._events.popleft()
        self._events_cond.notify_all()

    def sub_poll(self, channels: list, cursor: int,
                 timeout_ms: int = 0) -> dict:
        """Long-poll for events on the given channels since ``cursor``.

        cursor < 0 tails the log (returns the current end, no events).  A
        subscriber that fell behind the ring gets ``gap=True`` and must
        re-read table state.  Counterpart of the reference's
        PubsubLongPolling (src/ray/protobuf/core_worker.proto) — blocking
        here is fine: every subscriber holds a dedicated connection/thread.
        """
        deadline = time.monotonic() + timeout_ms / 1000.0
        chans = set(channels or ())
        with self._lock:
            if cursor < 0:
                return {"cursor": self._next_seq, "events": [], "gap": False}
            while True:
                oldest = self._events[0][0] if self._events else self._next_seq
                if cursor < oldest:
                    return {"cursor": self._next_seq, "events": [],
                            "gap": True}
                events = [p for (s, ch, p) in self._events
                          if s >= cursor and (not chans or ch in chans)]
                if events:
                    return {"cursor": self._next_seq, "events": events,
                            "gap": False}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # nothing matched in the whole scanned range: advance
                    # the cursor to the end, or unrelated-channel churn
                    # would eventually evict the stale position and turn
                    # every later poll into a spurious gap
                    return {"cursor": self._next_seq, "events": [],
                            "gap": False}
                self._events_cond.wait(remaining)

    def broadcast_command(self, payload: dict):
        """Cluster-wide command broadcast (reference: the ray_syncer
        COMMANDS channel, src/ray/common/ray_syncer/ray_syncer.h:83 —
        resource views ride heartbeats here; commands ride pubsub).
        Schedulers subscribe to the "commands" channel and act on
        payloads like {"type": "drain", "node_id": ...}."""
        with self._lock:
            # "ch" last: a payload must not re-tag the channel (the C++
            # daemon strips a payload "ch" the same way)
            self._publish("commands", {**payload, "ch": "commands"})

    # -- actors ------------------------------------------------------------
    def _actor_event(self, info: ActorInfo) -> dict:
        return {"ch": "actors", "actor_id": info.actor_id,
                "state": info.state, "addr": info.addr}

    def register_actor(self, info: ActorInfo):
        with self._lock:
            if info.name:
                if info.name in self.named_actors:
                    raise ValueError(f"actor name {info.name!r} already taken")
                self.named_actors[info.name] = info.actor_id
            self.actors[info.actor_id] = info
            self._publish("actors", self._actor_event(info))
        self._mutated()

    def update_actor(self, actor_id: bytes, **fields):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            for k, v in fields.items():
                setattr(info, k, v)
            if info.state == DEAD and info.name:
                self.named_actors.pop(info.name, None)
            self._publish("actors", self._actor_event(info))
        self._mutated()

    def get_actor(self, actor_id: bytes) -> Optional[ActorInfo]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_actor_by_name(self, name: str) -> Optional[ActorInfo]:
        with self._lock:
            actor_id = self.named_actors.get(name)
            return self.actors.get(actor_id) if actor_id else None

    def list_actors(self) -> list[ActorInfo]:
        with self._lock:
            return list(self.actors.values())

    # -- nodes -------------------------------------------------------------
    def register_node(self, info: NodeInfo):
        with self._lock:
            info.available = dict(info.resources)
            self.nodes[info.node_id] = info
            self._publish("nodes", {"ch": "nodes", "node_id": info.node_id,
                                    "alive": True})

    def list_nodes(self) -> list[NodeInfo]:
        with self._lock:
            return list(self.nodes.values())

    def get_node(self, node_id: bytes) -> Optional[NodeInfo]:
        with self._lock:
            return self.nodes.get(node_id)

    def heartbeat(self, node_id: bytes, available: dict, queued: int):
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or not info.alive:
                return
            info.ts = time.time()
            info.available = available
            info.queued = queued

    def mark_node_dead(self, node_id: bytes) -> bool:
        """Returns True if the node transitioned alive -> dead.  Schedulers
        react via the heartbeat loop's alive-set diff (_on_node_dead)."""
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or not info.alive:
                return False
            info.alive = False
            # drop the dead node from every object's location set; objects
            # with no surviving copy become tombstoned as LOST so owners
            # can re-execute their lineage
            for oid, locs in list(self.object_locations.items()):
                locs.discard(node_id)
                if not locs:
                    del self.object_locations[oid]
                    if len(self.lost_objects) >= 1_000_000:
                        # bounded: evict an arbitrary OLD tombstone rather
                        # than dropping the new one (fresh losses are the
                        # ones with live waiters)
                        self.lost_objects.pop()
                    self.lost_objects.add(oid)
                    self._publish("objects", {"ch": "objects", "oid": oid,
                                              "lost": True})
            self._publish("nodes", {"ch": "nodes", "node_id": node_id,
                                    "alive": False})
        return True

    def drop_node_objects(self, node_id: bytes) -> int:
        """The node's store daemon restarted empty (crash + supervised
        respawn): drop the node from every object's location set WITHOUT
        marking the node dead.  Objects whose last copy lived there are
        tombstoned LOST exactly as in mark_node_dead, so owners re-execute
        lineage.  Idempotent; returns how many objects lost their last
        copy."""
        lost = 0
        with self._lock:
            for oid, locs in list(self.object_locations.items()):
                if node_id not in locs:
                    continue
                locs.discard(node_id)
                if not locs:
                    del self.object_locations[oid]
                    if len(self.lost_objects) >= 1_000_000:
                        self.lost_objects.pop()
                    self.lost_objects.add(oid)
                    lost += 1
                    self._publish("objects", {"ch": "objects", "oid": oid,
                                              "lost": True})
        return lost

    def check_node_health(self) -> list[bytes]:
        """Mark nodes silent past the timeout dead; returns their ids."""
        now = time.time()
        with self._lock:
            stale = [i for i, n in self.nodes.items()
                     if n.alive and not n.is_head
                     and now - n.ts > NODE_DEATH_TIMEOUT_S]
        return [i for i in stale if self.mark_node_dead(i)]

    # -- object directory ---------------------------------------------------
    def add_object_location(self, oid: bytes, node_id: bytes):
        with self._lock:
            self.object_locations.setdefault(oid, set()).add(node_id)
            self.lost_objects.discard(oid)  # re-created (reconstruction)
            self._publish("objects", {"ch": "objects", "oid": oid,
                                      "lost": False})

    def add_object_locations(self, pairs: list):
        """Batched location publish: one RPC per seal-notification flush
        instead of one per sealed object (the hot put path)."""
        with self._lock:
            for oid, node_id in pairs:
                self.object_locations.setdefault(oid, set()).add(node_id)
                self.lost_objects.discard(oid)
                self._publish("objects", {"ch": "objects", "oid": oid,
                                          "lost": False})

    def object_lost(self, oid: bytes) -> bool:
        with self._lock:
            return oid in self.lost_objects

    def clear_object_lost(self, oid: bytes):
        with self._lock:
            self.lost_objects.discard(oid)

    def remove_object_location(self, oid: bytes, node_id: bytes):
        with self._lock:
            locs = self.object_locations.get(oid)
            if locs is not None:
                locs.discard(node_id)
                if not locs:
                    del self.object_locations[oid]

    def get_object_locations(self, oid: bytes) -> list[bytes]:
        with self._lock:
            return list(self.object_locations.get(oid, ()))

    def all_object_locations(self) -> dict[bytes, list[bytes]]:
        with self._lock:
            return {oid: list(locs)
                    for oid, locs in self.object_locations.items()}

    # -- placement groups ---------------------------------------------------
    # (reference: gcs_placement_group_mgr.cc owns the PG table; the 2PC
    # reserve/commit against raylets lives in the scheduler layer here)
    def register_pg(self, pg_id: bytes, bundles: list, strategy: str,
                    assignment: list):
        with self._lock:
            self.placement_groups[pg_id] = {
                "bundles": bundles, "strategy": strategy,
                "assignment": assignment}
        self._mutated()

    def get_pg(self, pg_id: bytes) -> Optional[dict]:
        with self._lock:
            info = self.placement_groups.get(pg_id)
            return dict(info) if info else None

    def remove_pg(self, pg_id: bytes):
        with self._lock:
            self.placement_groups.pop(pg_id, None)
        self._mutated()

    def list_pgs(self) -> dict:
        with self._lock:
            return {pg_id: dict(info)
                    for pg_id, info in self.placement_groups.items()}

    # -- internal KV (function/class registry, cluster metadata) -----------
    # -- job / worker / task-event tables ---------------------------------
    def add_job(self, job_id: str, info: dict):
        with self._lock:
            self.jobs[job_id] = dict(info)
            self._publish("jobs", {"ch": "jobs", "job_id": job_id})
        self._mutated()

    def update_job(self, job_id: str, fields: dict) -> bool:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return False
            job.update(fields)
            self._publish("jobs", {"ch": "jobs", "job_id": job_id})
        self._mutated()
        return True

    def get_job(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self.jobs.get(job_id)
            return dict(job) if job else None

    def list_jobs(self) -> list:
        with self._lock:
            return [dict(j) for j in self.jobs.values()]

    _MAX_DEAD_WORKERS = int(
        os.environ.get("RTPU_GCS_MAX_DEAD_WORKERS", 4096))

    def add_worker(self, worker_id: bytes, info: dict):
        with self._lock:
            self.workers[worker_id] = dict(info)
            # bound the table: DEAD records are history, not state —
            # evict the oldest ones past the cap (ALIVE rows always kept)
            if len(self.workers) > 2 * self._MAX_DEAD_WORKERS:
                dead = [(w.get("end_ts", 0.0), wid)
                        for wid, w in self.workers.items()
                        if w.get("state") == "DEAD"]
                dead.sort()
                for _, wid in dead[:len(dead) - self._MAX_DEAD_WORKERS]:
                    del self.workers[wid]
        self._mutated()

    def update_worker(self, worker_id: bytes, fields: dict) -> bool:
        with self._lock:
            w = self.workers.get(worker_id)
            if w is None:
                return False
            w.update(fields)
        self._mutated()
        return True

    def list_workers(self) -> list:
        with self._lock:
            return [dict(w) for w in self.workers.values()]

    _TEV_PERSIST_EVERY_S = float(
        os.environ.get("RTPU_GCS_TEV_PERSIST_S", 5.0))

    def add_task_events(self, events: list) -> int:
        with self._lock:
            self.task_events.extend(events)
            while len(self.task_events) > self._task_event_cap:
                self.task_events.popleft()
            n = len(self.task_events)
            # telemetry, not state: heartbeat-rate flushes from every
            # node must not re-serialize the (up to 64k-entry) ring into
            # the snapshot several times a second — persist on a slow
            # cadence; any real state mutation still snapshots it
            now = time.time()
            due = now - getattr(self, "_tev_last_persist",
                                0.0) > self._TEV_PERSIST_EVERY_S
            if due:
                self._tev_last_persist = now
        if due:
            self._mutated()
        return n

    def list_task_events(self, limit: int = 1000) -> list:
        with self._lock:
            evs = list(self.task_events)
        return evs[-limit:]

    def kv_put(self, namespace: str, key: bytes, value: bytes):
        with self._lock:
            self.kv[(namespace, key)] = value
            self._publish(f"kv:{namespace}",
                          {"ch": f"kv:{namespace}", "key": key})
        self._mutated()

    def kv_get(self, namespace: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self.kv.get((namespace, key))

    def kv_del(self, namespace: str, key: bytes):
        with self._lock:
            self.kv.pop((namespace, key), None)
        self._mutated()

    def kv_keys(self, namespace: str) -> list[bytes]:
        with self._lock:
            return [k for (ns, k) in self.kv if ns == namespace]


# ---------------------------------------------------------------------------
# Socket service: GcsServer exposes a Gcs to other nodes; GcsClient mirrors
# the Gcs method surface over the socket (reference: the 11 gRPC services of
# src/ray/protobuf/gcs_service.proto, collapsed to one generic call channel).
# ---------------------------------------------------------------------------

# methods callable over the wire (everything except the death callback hook)
_GCS_METHODS = frozenset({
    "register_actor", "update_actor", "get_actor", "get_actor_by_name",
    "list_actors", "register_node", "list_nodes", "get_node", "heartbeat",
    "mark_node_dead", "drop_node_objects",
    "add_object_location", "add_object_locations",
    "remove_object_location",
    "get_object_locations", "all_object_locations",
    "object_lost", "clear_object_lost",
    "register_pg", "get_pg", "remove_pg", "list_pgs",
    "add_job", "update_job", "get_job", "list_jobs",
    "add_worker", "update_worker", "list_workers",
    "add_task_events", "list_task_events",
    "kv_put", "kv_get", "kv_del", "kv_keys",
    "check_node_health", "sub_poll", "broadcast_command",
})


# Idempotent GCS methods: reads, keyed upserts, and set-adds — safe to
# re-issue across a head restart.  Deliberately excluded:
# add_task_events (append: duplicates), broadcast_command (re-delivery),
# sub_poll (held long-poll: the subscriber loop owns its retry).
_RETRYABLE_METHODS = frozenset({
    "kv_get", "kv_keys", "kv_put", "kv_del",
    "get_actor", "get_actor_by_name", "list_actors", "update_actor",
    "register_node", "list_nodes", "get_node", "heartbeat",
    "mark_node_dead", "drop_node_objects", "check_node_health",
    "add_object_location", "add_object_locations",
    "remove_object_location", "get_object_locations",
    "all_object_locations", "object_lost", "clear_object_lost",
    "register_pg", "get_pg", "remove_pg", "list_pgs",
    "add_job", "update_job", "get_job", "list_jobs",
    "add_worker", "update_worker", "list_workers", "list_task_events",
})
# ~3s of patience across 4 reconnects: covers a head-daemon restart
# without hiding a genuinely dead control plane for long
_RETRY_BACKOFF_S = (0.1, 0.3, 0.8, 1.8)


class GcsServer:
    def __init__(self, gcs: Gcs, socket_path: str):
        self.gcs = gcs
        self._listener, self.socket_path = listener_addr(socket_path)
        self._is_tcp = is_tcp_addr(self.socket_path)
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="gcs-accept", daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._shutdown:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(Connection(sock),),
                             daemon=True).start()

    def _serve(self, conn: Connection):
        # TCP peers must pass the cluster-token handshake first; then every
        # peer (TCP or unix) must speak the wire-codec version.  Nothing a
        # peer sends is ever unpickled on this path.
        if not authenticate_server_side(conn, self._is_tcp):
            return
        if conn.recv_bytes() != wire.HELLO:
            conn.close()
            return
        try:
            conn.send_bytes(wire.HELLO_OK)
        except OSError:
            return
        while True:
            try:
                data = conn.recv_frame()
            except (OSError, ConnectionError, ValueError):
                return  # ValueError = oversize frame: hang up on flooders
            if data is None:
                return
            try:
                method, args, kwargs = wire.decode_request(data)
                if method not in _GCS_METHODS:
                    raise ValueError(f"unknown GCS method {method!r}")
                result = getattr(self.gcs, method)(*args, **kwargs)
                resp = wire.encode_response(True, result)
            except Exception as e:  # noqa: BLE001 — serialize to caller
                resp = wire.encode_response(False, e)
            try:
                conn.send_frame(resp)
            except (OSError, ConnectionError):
                return

    def shutdown(self):
        self._shutdown = True
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


class GcsClient:
    """Same method surface as Gcs, over the GcsServer socket.

    One persistent connection, one in-flight request at a time (guarded by a
    lock): callers are scheduler threads making small control-plane calls.
    """

    def __init__(self, socket_path: str):
        self._socket_path = socket_path
        self._conn = self._connect()
        self._lock = threading.Lock()

    def _connect(self) -> Connection:
        conn = connect_addr(self._socket_path)
        try:
            conn.send_bytes(wire.HELLO)
            if conn.recv_bytes() != wire.HELLO_OK:
                conn.close()
                raise ConnectionError(
                    "GCS wire-protocol version mismatch (node and head run "
                    "different ray_tpu versions)")
        except OSError:
            conn.close()
            raise
        return conn

    def _call(self, method: str, *args, **kwargs):
        from ray_tpu_torch._private.protocol import chaos_should_fail

        req = wire.encode_request(method, args, kwargs)
        # Retry policy (reference: rpc/retryable_grpc_client.h): methods
        # in _RETRYABLE are IDEMPOTENT (reads, keyed upserts, set-adds)
        # and survive a restarting head with reconnect + backoff; the
        # rest keep strict one-reconnect semantics, bounding (not fully
        # eliminating — a response lost after the server applied the
        # request is still resent once, as before) duplication of
        # non-idempotent calls.  Backoff sleeps run OUTSIDE the client
        # lock so other threads' calls aren't serialized behind a dead
        # head's retry window.
        attempts = (len(_RETRY_BACKOFF_S) + 1
                    if method in _RETRYABLE_METHODS else 2)
        data = None
        for attempt in range(attempts):
            if attempt > 0:
                time.sleep(_RETRY_BACKOFF_S[attempt - 1])
            try:
                with self._lock:
                    if attempt > 0:
                        old, self._conn = self._conn, self._connect()
                        try:
                            old.close()
                        except OSError:
                            pass
                    if chaos_should_fail(method, "req"):
                        raise ConnectionResetError(
                            f"rpc chaos: injected {method} request failure")
                    self._conn.send_frame(req)
                    data = self._conn.recv_frame()
                    if data is not None and chaos_should_fail(method,
                                                              "resp"):
                        raise ConnectionResetError(
                            f"rpc chaos: injected {method} response "
                            f"failure")
                if data is not None:
                    break
            except ConnectionError as e:
                # a version-mismatch handshake failure is permanent:
                # surface the actionable message, never backoff past it
                if "version mismatch" in str(e):
                    raise
                data = None
            except OSError:
                data = None
        if data is None:
            raise ConnectionError("GCS connection lost")
        ok, payload = wire.decode_response(data)
        if not ok:
            raise payload
        return payload


def _make_proxy(name):
    def proxy(self, *args, **kwargs):
        return self._call(name, *args, **kwargs)

    proxy.__name__ = name
    return proxy


for _m in _GCS_METHODS:
    setattr(GcsClient, _m, _make_proxy(_m))


class GcsSubscriber:
    """Dedicated long-poll subscription to GCS change events.

    Replaces sleep-polling of GCS tables (reference: the long-poll
    subscriber in src/ray/pubsub/subscriber.h:216).  Holds its own
    connection — a parked long-poll must not block other RPCs.

    ``poll`` returns (events, gap): ``gap=True`` means the subscriber fell
    behind the server's event ring and must re-read table state before
    trusting events again.
    """

    def __init__(self, gcs_address: str, channels: list):
        self._client = GcsClient(gcs_address)
        self._channels = list(channels)
        self._cursor = -1

    def poll(self, timeout_s: float = 10.0) -> tuple[list, bool]:
        if self._cursor < 0:
            self._cursor = self._client.sub_poll(
                self._channels, -1, 0)["cursor"]
            return [], True  # first poll: caller reads current state
        r = self._client.sub_poll(self._channels, self._cursor,
                                  int(timeout_s * 1000))
        self._cursor = r["cursor"]
        return r["events"], bool(r["gap"])
