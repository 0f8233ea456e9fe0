"""Cluster-level scheduling: peer links, spillback policy, bundle placement.

Counterpart of the reference's cluster scheduling layer
(Ray's src/ray/raylet/scheduling/cluster_task_manager.cc driving
cluster_resource_scheduler.cc:145 GetBestSchedulableNode with the hybrid
policy in policy/hybrid_scheduling_policy.cc, and the PG bundle strategies in
policy/bundle_scheduling_policy.cc).  The local dispatch loop stays in
scheduler.py (the reference's local_task_manager.cc); this module owns the
plumbing that involves OTHER nodes.  The placement POLICY itself
(hybrid_decide / pick_spill_target / node_utilization) lives in
scheduling_policy.py and is re-exported here for existing call sites.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.scheduling_policy import (  # noqa: F401  (re-export)
    feasible,
    hybrid_decide,
    node_utilization,
    peer_could_take,
    pick_spill_target,
)
from ray_tpu_torch._private.task_spec import TaskSpec


class PeerLinks:
    """Cached one-way connections to other nodes' schedulers, plus one-shot
    request/response calls (reference: the per-peer gRPC clients in
    src/ray/rpc/node_manager/)."""

    def __init__(self, node_id: bytes, lookup_node: Callable):
        self._node_id = node_id
        self._lookup_node = lookup_node  # node_id -> NodeInfo | None
        self._peers: dict[bytes, protocol.Connection] = {}
        self._lock = threading.Lock()

    def send(self, node_id: bytes, msg: dict) -> bool:
        """Send a one-way control message to another node's scheduler.

        The TCP connect happens OUTSIDE the links lock and with a short
        timeout: callers hold the scheduler lock (dispatch loop), and a
        peer that just went dark must not stall the whole node for a full
        SYN timeout per pending task."""
        with self._lock:
            conn = self._peers.get(node_id)
        if conn is None:
            node = self._lookup_node(node_id)
            if node is None or not node.alive or not node.sched_socket:
                return False
            try:
                conn = protocol.connect_addr(node.sched_socket, timeout=2.0)
            except (OSError, ConnectionError):
                return False
            with self._lock:
                existing = self._peers.get(node_id)
                if existing is not None:
                    conn.close()  # lost the race; use the cached one
                    conn = existing
                else:
                    self._peers[node_id] = conn
        try:
            conn.send(msg)
            return True
        except OSError:
            with self._lock:
                self._peers.pop(node_id, None)
            return False

    def one_shot_rpc(self, sched_addr: str, method: str, params: dict):
        """Request/response against a peer scheduler over a fresh
        connection (the cached peer conns are one-way fire-and-forget)."""
        if protocol.chaos_should_fail(method, "req"):
            raise ConnectionResetError(
                f"rpc chaos: injected {method} request failure")
        conn = protocol.connect_addr(sched_addr, timeout=5.0)
        try:
            conn.send({"t": "rpc", "method": method, "params": params})
            resp = conn.recv()
            if resp is not None and protocol.chaos_should_fail(
                    method, "resp"):
                raise ConnectionResetError(
                    f"rpc chaos: injected {method} response failure")
        finally:
            conn.close()
        if resp is None or not resp.get("ok"):
            raise RuntimeError(
                f"peer rpc {method} failed: "
                f"{resp.get('error') if resp else 'connection closed'}")
        return resp["result"]

    def drop(self, node_id: bytes):
        with self._lock:
            self._peers.pop(node_id, None)


def assign_bundles(
    avail: dict[bytes, dict],
    bundles: list[dict],
    strategy: str,
) -> Optional[list[bytes]]:
    """Pick a node per placement-group bundle from a cluster availability
    view; None = infeasible (reference: bundle_scheduling_policy.cc)."""

    def fits(node_avail: dict, b: dict) -> bool:
        return all(node_avail.get(k, 0) >= v for k, v in b.items())

    def take(node_avail: dict, b: dict):
        for k, v in b.items():
            node_avail[k] = node_avail.get(k, 0) - v

    order = sorted(avail, key=lambda n: -avail[n].get("CPU", 0))
    assignment: list[Optional[bytes]] = [None] * len(bundles)
    if strategy in ("STRICT_PACK",):
        for nid in order:
            trial = dict(avail[nid])
            good = True
            for b in bundles:
                if not fits(trial, b):
                    good = False
                    break
                take(trial, b)
            if good:
                return [nid] * len(bundles)
        return None
    if strategy in ("STRICT_SPREAD",):
        used: set[bytes] = set()
        for i, b in enumerate(bundles):
            placed = False
            for nid in order:
                if nid in used or not fits(avail[nid], b):
                    continue
                take(avail[nid], b)
                used.add(nid)
                assignment[i] = nid
                placed = True
                break
            if not placed:
                return None
        return assignment  # type: ignore[return-value]
    # PACK: prefer fewest nodes (first-fit over pack order);
    # SPREAD: best-effort round-robin over distinct nodes
    rr = 0
    for i, b in enumerate(bundles):
        placed = False
        tries = (order if strategy == "PACK"
                 else order[rr % len(order):] + order[:rr % len(order)])
        for nid in tries:
            if fits(avail[nid], b):
                take(avail[nid], b)
                assignment[i] = nid
                placed = True
                break
        if not placed:
            return None
        rr += 1
    return assignment  # type: ignore[return-value]
