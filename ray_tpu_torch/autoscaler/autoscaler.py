"""Resource-demand autoscaler: bin-pack pending work onto node types.

Counterpart of ``ray_tpu/autoscaler/autoscaler.py`` (Ray's
python/ray/autoscaler/_private/autoscaler.py:172 StandardAutoscaler and
resource_demand_scheduler.py): each tick gathers the cluster's unmet
resource demand (per-pending-task asks from every node's scheduler
snapshot), first-fit packs it onto the nodes' current availability,
bin-packs the remainder onto hypothetical new nodes of the configured types
(respecting per-type max_workers), launches the difference through the
NodeProvider, and terminates provider nodes that have sat idle past
idle_timeout_s.  A node type is a whole machine shape (e.g. ``{"CPU": 8,
"GPU": 1}``), so a ``num_gpus=1`` task or actor queued on a head without
cards brings up one node that has one.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch.autoscaler.node_provider import NodeProvider


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    idle_timeout_s: float = 30.0
    interval_s: float = 1.0
    # at most this many simultaneous launches per tick (Ray's
    # upscaling_speed bounds launch bursts)
    max_launch_batch: int = 8


def _fits(demand: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _subtract(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class StandardAutoscaler:
    def __init__(self, gcs, provider: NodeProvider,
                 config: AutoscalerConfig):
        self._gcs = gcs
        self._provider = provider
        self.config = config
        self._stop = threading.Event()
        # provider node_id -> (node_type, launch_ts)
        self._launched: Dict[bytes, tuple[str, float]] = {}
        self._idle_since: Dict[bytes, float] = {}
        self._thread: Optional[threading.Thread] = None

    # -- one reconciliation tick (public for deterministic tests) ---------
    def update(self) -> dict:
        nodes = [n for n in self._gcs.list_nodes() if n.alive]
        snapshots = {}
        for n in nodes:
            try:
                snapshots[n.node_id] = self._node_rpc(
                    n.sched_socket, "cluster_state")
            except Exception:
                continue  # node mid-death; next tick sees the GCS update

        # 1. Unmet demand after first-fit onto current availability.
        avail = {nid: dict(s["available_resources"])
                 for nid, s in snapshots.items()}
        unmet: List[Dict[str, float]] = []
        for s in snapshots.values():
            for demand in s.get("pending_demand", []):
                if not demand:
                    continue
                for a in avail.values():
                    if _fits(demand, a):
                        _subtract(a, demand)
                        break
                else:
                    unmet.append(demand)

        # 2. Pack the remainder onto hypothetical new nodes.
        counts = self._type_counts()
        to_launch: List[str] = []
        virtual: List[tuple[str, Dict[str, float]]] = []
        for demand in unmet:
            for _, a in virtual:
                if _fits(demand, a):
                    _subtract(a, demand)
                    break
            else:
                t = self._pick_type(demand, counts)
                if t is not None:
                    a = dict(self.config.node_types[t].resources)
                    _subtract(a, demand)
                    virtual.append((t, a))
                    counts[t] = counts.get(t, 0) + 1
                    to_launch.append(t)

        # 3. min_workers floors.
        for tname, tcfg in self.config.node_types.items():
            deficit = tcfg.min_workers - counts.get(tname, 0)
            for _ in range(max(0, deficit)):
                counts[tname] = counts.get(tname, 0) + 1
                to_launch.append(tname)

        launched = 0
        for tname in to_launch[: self.config.max_launch_batch]:
            nid = os.urandom(16)
            self._launched[nid] = (tname, time.monotonic())
            self._provider.create_node(
                tname, self.config.node_types[tname].resources, nid)
            launched += 1

        # 4. Idle terminations (only provider-launched, above the floor).
        terminated = 0
        now = time.monotonic()
        for nid, (tname, launch_ts) in list(self._launched.items()):
            s = snapshots.get(nid)
            if s is None:
                if now - launch_ts > 120:  # never joined: reclaim
                    self._terminate(nid)
                    terminated += 1
                continue
            idle = (s["pending_tasks"] == 0
                    and s["available_resources"] == s["total_resources"])
            if not idle:
                self._idle_since.pop(nid, None)
                continue
            first = self._idle_since.setdefault(nid, now)
            above_floor = (self._count_type(tname) >
                           self.config.node_types[tname].min_workers)
            if now - first > self.config.idle_timeout_s and above_floor:
                self._terminate(nid)
                terminated += 1
        return {"launched": launched, "terminated": terminated,
                "unmet_demand": len(unmet)}

    def _terminate(self, nid: bytes):
        self._launched.pop(nid, None)
        self._idle_since.pop(nid, None)
        self._provider.terminate_node(nid)
        try:
            self._gcs.mark_node_dead(nid)
        except Exception:
            pass

    def _type_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for tname, _ in self._launched.values():
            counts[tname] = counts.get(tname, 0) + 1
        return counts

    def _count_type(self, tname: str) -> int:
        return self._type_counts().get(tname, 0)

    def _pick_type(self, demand: Dict[str, float],
                   counts: Dict[str, int]) -> Optional[str]:
        """Smallest node type that fits the demand and is under its max.

        Node types must declare their FULL resource shape (including CPU):
        launched nodes advertise exactly the declared resources, so the
        plan here matches what joins (provider passes --resources).
        """
        best, best_size = None, None
        for tname, tcfg in self.config.node_types.items():
            if counts.get(tname, 0) >= tcfg.max_workers:
                continue
            if not _fits(demand, dict(tcfg.resources)):
                continue
            size = sum(tcfg.resources.values())
            if best_size is None or size < best_size:
                best, best_size = tname, size
        return best

    @staticmethod
    def _node_rpc(sock: str, method: str, params: Optional[dict] = None):
        conn = protocol.connect_addr(sock)
        try:
            conn.send({"t": "rpc", "method": method, "params": params or {}})
            resp = conn.recv()
        finally:
            conn.close()
        if resp is None or not resp.get("ok"):
            raise RuntimeError(f"autoscaler rpc {method} failed")
        return resp["result"]

    # -- background monitor (Ray's monitor.py process) ---------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.config.interval_s):
            try:
                self.update()
            except Exception:
                pass  # transient RPC failures must not kill the monitor

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._provider.shutdown()
