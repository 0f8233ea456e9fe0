"""Autoscaler v2: declarative instance reconciliation + slice atomicity.

Counterpart of ``ray_tpu/autoscaler/v2.py`` (Ray's autoscaler v2,
python/ray/autoscaler/v2/autoscaler.py, instance_manager/, and the
instance FSM of src/ray/protobuf/instance_manager.proto:242): where v1
imperatively launches/kills nodes per tick, v2 keeps a declarative
**instance table** with an explicit lifecycle FSM and reconciles desired
vs actual every tick, so retries, partial failures, and termination all
fall out of state convergence instead of ad-hoc bookkeeping.

The unit of scaling is an **instance** that may span multiple hosts — a
slice of GPU hosts (e.g. two hosts of 8 cards joined for one NCCL job) is
created and destroyed as ONE atomic instance.  If any host of a slice
fails to come up, the whole slice is torn down and re-queued; idle
scale-down terminates whole slices, never individual hosts (a partial
slice cannot run its collective program and still bills every card).

Instance lifecycle (instance_manager.proto names where they map):

    QUEUED -> REQUESTED -> ALLOCATED -> RUNNING -> TERMINATING -> TERMINATED
                   \\-> ALLOCATION_FAILED -> (re-QUEUED, bounded retries)
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import _fits, _subtract
from ray_tpu_torch.autoscaler.node_provider import (
    launch_node_process,
    stop_node_process,
)

# -- instance FSM states ----------------------------------------------------
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"          # provider says every host exists
RUNNING = "RUNNING"              # every host's node is alive in the GCS
ALLOCATION_FAILED = "ALLOCATION_FAILED"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"


@dataclass
class SliceType:
    """A launchable shape.  hosts > 1 models a multi-host slice (atomic);
    resources are PER HOST (what each joining node advertises, e.g.
    ``{"CPU": 8, "GPU": 8}``)."""

    resources: Dict[str, float]
    hosts: int = 1
    min_instances: int = 0
    max_instances: int = 10
    # interconnect topology tag (e.g. "2x8") — recorded on nodes for
    # slice-aware gang placement; informational for providers that don't
    # use it
    topology: str = ""


@dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = QUEUED
    # one node id per host; GCS node ids once RUNNING
    node_ids: List[bytes] = field(default_factory=list)
    launch_ts: float = 0.0
    status_ts: float = field(default_factory=time.monotonic)
    retries: int = 0
    error: str = ""
    idle_since: Optional[float] = None

    def transition(self, status: str, error: str = ""):
        self.status = status
        self.status_ts = time.monotonic()
        if error:
            self.error = error


class CloudInstanceProvider:
    """v2 provider contract: allocate/terminate whole instances.

    ``allocate`` must be all-or-nothing per instance: on any host failure
    it raises after cleaning up whatever it partially created (the
    reconciler additionally re-queues the instance).
    """

    def allocate(self, instance: Instance, slice_type: SliceType) -> None:
        raise NotImplementedError

    def terminate(self, instance: Instance) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class GPUSliceProvider(CloudInstanceProvider):
    """Launches each host of a slice of GPU hosts as a real worker-node
    process joined to the head (one process per host, all created and
    deleted together; the counterpart of the JAX package's
    ``TPUSliceProvider``).  ``host_launcher``/``host_terminator`` are
    injectable so unit tests can model host-level failures without
    processes; the default launches OS processes as the v1
    ``FakeNodeProvider`` does (``launch_node_process``), so the full node
    bootstrap + GCS join is exercised, and terminates a host as v1 does
    (``stop_node_process``):
    its process group (the node, its workers and its store daemon) is
    stopped and waited for, so the host's cards are free when
    ``terminate`` returns.  The JAX package's ``TPUSliceProvider`` sends
    SIGTERM to the node process alone and returns at once; a host
    terminated while it starts leaves its store daemon running.
    """

    def __init__(self, gcs_address: str,
                 host_launcher: Optional[Callable] = None,
                 host_terminator: Optional[Callable] = None):
        self._gcs_address = gcs_address
        self._procs: Dict[bytes, object] = {}
        self._lock = threading.Lock()
        self._launch = host_launcher or self._launch_process
        self._terminate_host = host_terminator or self._terminate_process

    def allocate(self, instance: Instance, slice_type: SliceType) -> None:
        launched: List[bytes] = []
        instance.node_ids = [os.urandom(16) for _ in range(slice_type.hosts)]
        try:
            for nid in instance.node_ids:
                self._launch(nid, slice_type, instance)
                launched.append(nid)
        except Exception:
            # slice atomicity: ANY host failure unwinds the WHOLE slice
            for nid in launched:
                try:
                    self._terminate_host(nid)
                except Exception:
                    pass
            instance.node_ids = []
            raise

    def terminate(self, instance: Instance) -> None:
        for nid in instance.node_ids:
            try:
                self._terminate_host(nid)
            except Exception:
                pass

    def _launch_process(self, node_id: bytes, slice_type: SliceType,
                        instance: Instance) -> None:
        proc = launch_node_process(self._gcs_address, slice_type.resources,
                                   node_id)
        with self._lock:
            self._procs[node_id] = proc

    def _terminate_process(self, node_id: bytes) -> None:
        with self._lock:
            proc = self._procs.pop(node_id, None)
        if proc is not None:
            stop_node_process(proc, node_id)

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.items())
            self._procs.clear()
        for nid, p in procs:
            try:
                stop_node_process(p, nid)
            except Exception:
                pass


class InstanceManager:
    """The instance table + transitions (Ray's
    autoscaler/v2/instance_manager/instance_manager.py).  Thread-safe;
    reconciliation is the only writer, status readers are free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}

    def add(self, node_type: str) -> Instance:
        inst = Instance(instance_id=uuid.uuid4().hex[:12],
                        node_type=node_type)
        with self._lock:
            self._instances[inst.instance_id] = inst
        return inst

    def all(self, *statuses: str) -> List[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if statuses:
            out = [i for i in out if i.status in statuses]
        return out

    def prune_terminated(self, keep: int = 100):
        with self._lock:
            dead = [i for i in self._instances.values()
                    if i.status == TERMINATED]
            dead.sort(key=lambda i: i.status_ts)
            for i in dead[:-keep] if len(dead) > keep else []:
                self._instances.pop(i.instance_id, None)

    def summary(self) -> dict:
        with self._lock:
            counts: Dict[str, int] = {}
            for i in self._instances.values():
                counts[i.status] = counts.get(i.status, 0) + 1
            return {"counts": counts,
                    "instances": [{
                        "id": i.instance_id, "type": i.node_type,
                        "status": i.status, "hosts": len(i.node_ids),
                        "error": i.error,
                    } for i in self._instances.values()]}


class AutoscalerV2:
    """Declarative reconciler: desired instance set from demand, converged
    against the instance table + the GCS's live-node view each tick."""

    MAX_ALLOC_RETRIES = 3
    ALLOC_JOIN_TIMEOUT_S = 120.0

    def __init__(self, gcs, provider: CloudInstanceProvider,
                 slice_types: Dict[str, SliceType],
                 idle_timeout_s: float = 30.0,
                 interval_s: float = 1.0,
                 demand_fn: Optional[Callable[[], List[Dict[str, float]]]] = None):
        self._gcs = gcs
        self._provider = provider
        self.slice_types = slice_types
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        self.im = InstanceManager()
        self._demand_fn = demand_fn or self._demand_from_schedulers
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._snapshots: Dict[bytes, dict] = {}

    # -- demand -------------------------------------------------------------
    def _demand_from_schedulers(self) -> List[Dict[str, float]]:
        """Unmet per-task resource asks across the cluster (same source as
        v1: each node's scheduler snapshot), minus current availability."""
        from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler

        nodes = [n for n in self._gcs.list_nodes() if n.alive]
        snapshots = {}
        for n in nodes:
            try:
                snapshots[n.node_id] = StandardAutoscaler._node_rpc(
                    n.sched_socket, "cluster_state")
            except Exception:
                continue
        self._snapshots = snapshots
        avail = [dict(s["available_resources"]) for s in snapshots.values()]
        unmet: List[Dict[str, float]] = []
        for s in snapshots.values():
            for demand in s.get("pending_demand", []):
                if not demand:
                    continue
                for a in avail:
                    if _fits(demand, a):
                        _subtract(a, demand)
                        break
                else:
                    unmet.append(demand)
        return unmet

    # -- one reconcile tick -------------------------------------------------
    def reconcile(self) -> dict:
        alive = {n.node_id for n in self._gcs.list_nodes() if n.alive}
        unmet = list(self._demand_fn())
        stats = {"launched": 0, "terminated": 0, "failed": 0,
                 "unmet_demand": len(unmet)}

        # 1. Advance in-flight instances: ALLOCATED -> RUNNING when every
        #    host's node is alive; time-outs / dead hosts -> re-queue.
        for inst in self.im.all(ALLOCATED):
            if inst.node_ids and all(n in alive for n in inst.node_ids):
                inst.transition(RUNNING)
            elif time.monotonic() - inst.status_ts > self.ALLOC_JOIN_TIMEOUT_S:
                self._fail_instance(inst, "hosts did not join in time")
                stats["failed"] += 1
        for inst in self.im.all(RUNNING):
            if any(n not in alive for n in inst.node_ids):
                # a host died: the slice is no longer whole — terminate the
                # remnant atomically; demand (if any) re-queues a fresh one
                self._terminate_instance(inst)
                stats["terminated"] += 1

        # 2. Desired delta from demand: net unmet asks against capacity
        #    already in flight (queued/allocating instances are invisible
        #    to scheduler snapshots but WILL arrive — without this netting
        #    every reconcile tick would launch the same demand again),
        #    then pack the remainder onto hypothetical new slices.
        pending_capacity: List[Dict[str, float]] = []
        for inst in self.im.all(QUEUED, REQUESTED, ALLOCATED):
            stype = self.slice_types[inst.node_type]
            pending_capacity.extend(
                dict(stype.resources) for _ in range(stype.hosts))
        unmet = [d for d in unmet
                 if not self._consume(pending_capacity, d)]
        stats["unmet_demand"] = len(unmet)
        counts = self._live_counts()
        for demand in unmet:
            # a slice queued for an EARLIER demand this tick may still have
            # room: consume it before provisioning another (one 8-CPU slice
            # holds eight 1-CPU asks, not eight slices)
            if self._consume(pending_capacity, demand):
                continue
            placed = False
            for tname, stype in sorted(
                    self.slice_types.items(),
                    key=lambda kv: sum(kv[1].resources.values())):
                if counts.get(tname, 0) >= stype.max_instances:
                    continue
                if _fits(demand, dict(stype.resources)):
                    self.im.add(tname)
                    counts[tname] = counts.get(tname, 0) + 1
                    new_capacity = [dict(stype.resources)
                                    for _ in range(stype.hosts)]
                    self._consume(new_capacity, demand)
                    pending_capacity.extend(new_capacity)
                    placed = True
                    break
            if not placed:
                pass  # infeasible demand; surfaced via summary()

        # 3. min_instances floors.
        for tname, stype in self.slice_types.items():
            for _ in range(max(0, stype.min_instances
                               - counts.get(tname, 0))):
                self.im.add(tname)
                counts[tname] = counts.get(tname, 0) + 1

        # 4. Launch QUEUED instances (atomic per slice).
        for inst in self.im.all(QUEUED):
            stype = self.slice_types[inst.node_type]
            inst.transition(REQUESTED)
            inst.launch_ts = time.monotonic()
            try:
                self._provider.allocate(inst, stype)
                inst.transition(ALLOCATED)
                stats["launched"] += 1
            except Exception as e:
                self._fail_instance(inst, f"allocation failed: {e!r}")
                stats["failed"] += 1

        # 5. Idle scale-down: whole slices, above the floor only.
        now = time.monotonic()
        for inst in self.im.all(RUNNING):
            stype = self.slice_types[inst.node_type]
            if self._live_counts().get(inst.node_type, 0) \
                    <= stype.min_instances:
                inst.idle_since = None
                continue
            if self._instance_idle(inst):
                if inst.idle_since is None:
                    inst.idle_since = now
                elif now - inst.idle_since > self.idle_timeout_s:
                    self._terminate_instance(inst)
                    stats["terminated"] += 1
            else:
                inst.idle_since = None
        self.im.prune_terminated()
        return stats

    @staticmethod
    def _consume(capacity: List[Dict[str, float]],
                 demand: Dict[str, float]) -> bool:
        for a in capacity:
            if _fits(demand, a):
                _subtract(a, demand)
                return True
        return False

    def _instance_idle(self, inst: Instance) -> bool:
        for nid in inst.node_ids:
            s = self._snapshots.get(nid)
            if s is None:
                return False  # no fresh view: never scale down blind
            if s["pending_tasks"] or \
                    s["available_resources"] != s["total_resources"]:
                return False
        return True

    def _fail_instance(self, inst: Instance, error: str):
        try:
            self._provider.terminate(inst)
        except Exception:
            pass
        for nid in inst.node_ids:
            try:
                self._gcs.mark_node_dead(nid)
            except Exception:
                pass
        inst.retries += 1
        if inst.retries <= self.MAX_ALLOC_RETRIES:
            inst.node_ids = []
            inst.transition(QUEUED, error)  # converge again next tick
        else:
            inst.transition(ALLOCATION_FAILED, error)

    drain_grace_s: float = 2.0

    def _terminate_instance(self, inst: Instance):
        inst.transition(TERMINATING)
        # graceful drain first (syncer COMMANDS channel): the nodes stop
        # advertising capacity and spill forwardable pending work before
        # the processes die
        broadcast = getattr(self._gcs, "broadcast_command", None)
        if broadcast is not None and inst.node_ids:
            any_drained = False
            for nid in inst.node_ids:
                try:
                    broadcast({"type": "drain", "node_id": nid})
                    any_drained = True
                except Exception:
                    continue  # per-node best effort: drain the rest
            if any_drained and self.drain_grace_s > 0:
                time.sleep(self.drain_grace_s)
        try:
            self._provider.terminate(inst)
        except Exception:
            pass
        for nid in inst.node_ids:
            try:
                self._gcs.mark_node_dead(nid)
            except Exception:
                pass
        inst.transition(TERMINATED)

    def _live_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for inst in self.im.all(QUEUED, REQUESTED, ALLOCATED, RUNNING):
            counts[inst.node_type] = counts.get(inst.node_type, 0) + 1
        return counts

    # -- background loop ----------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="autoscaler-v2", daemon=True)
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.reconcile()
            except Exception:
                pass  # transient RPC failures must not kill the reconciler

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._provider.shutdown()
