"""Scheduling policy: hybrid top-k spillback + shape-indexed pending queues.

Counterpart of the reference's scheduling policy layer
(Ray's src/ray/raylet/scheduling/policy/
hybrid_scheduling_policy.cc): placement is decided AT QUEUE TIME, not by a
periodic balancer.  The hybrid policy prefers the local node while its
utilization stays under a threshold (RTPU_SPILL_THRESHOLD, reference
default 0.5), then ranks feasible peers and picks deterministically among
the top-k least-utilized (RTPU_SPILL_TOP_K) so concurrent submitters
spread instead of dogpiling one node.

Everything here is pure policy over a cached cluster view (NodeInfo dicts
refreshed by the scheduler's heartbeat thread) — no sockets, no locks —
so it is shared by the Python dispatch lane, the native-backlog bridge,
and the tests, and the 0.25s heartbeat balancer shrinks to a slow-path
rebalancer for stale-view mistakes (scheduler._balance_native_backlog).

The module also owns PendingQueues: the node's pending-task store, with
plain tasks bucketed by resource shape so the dispatch loop checks
feasibility once per SHAPE instead of once per TASK — the structural
requirement for holding submit/dispatch rates past 100k queued tasks.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

from ray_tpu_torch._private import flags as flags_mod
from ray_tpu_torch._private.task_spec import TASK, TaskSpec


def feasible(capacity: dict, res: dict) -> bool:
    """Can a node with this capacity map EVER hold this resource ask?"""
    return all(capacity.get(k, 0) >= v for k, v in res.items())


def node_utilization(available: dict, total: dict, queued: int = 0) -> float:
    """Utilization score of one node: max over resources of used/total
    (reference: NodeScorer in scheduling_policy — the most-constrained
    resource defines the node's load).  A queued backlog means the node is
    past saturation: backlogged nodes score in (1, 2], ordered by backlog
    depth relative to their CPU width, so ranking prefers merely-busy
    nodes over backlogged ones."""
    util = 0.0
    for k, tot in total.items():
        if tot <= 0:
            continue
        used = tot - available.get(k, 0.0)
        if used > 0:
            u = used / tot
            if u > util:
                util = u
    if queued > 0:
        width = total.get("CPU", 0.0) or 1.0
        util = max(util, 1.0 + min(1.0, queued / width))
    return util


def hybrid_decide(
    spec: TaskSpec,
    node_id: bytes,
    total_resources: dict,
    cluster_nodes: dict,
    *,
    local_utilization: float,
    threshold: float = 0.5,
    top_k: int = 4,
) -> Optional[bytes]:
    """The hybrid scheduling decision for one task: None = keep it local,
    else the peer node id to forward to (reference:
    hybrid_scheduling_policy.cc HybridPolicyWithFarthestAggregation).

    Pure: ranks the cached view without mutating it.  Callers that act on
    the answer should follow with commit_spill() so the next decision in
    the same view window sees the debit.

    - Local first: below the utilization threshold a locally-feasible
      task never leaves (zero-cost path for the single-node case).
    - Feasibility: only peers whose TOTALS cover the ask are candidates;
      infeasible-everywhere stays local (the local infeasible/error path
      owns it).
    - Determinism: candidates sort by (utilization, node_id); among the
      top-k the pick is keyed by task_id, so one view + one task always
      produces one answer while a burst of distinct tasks spreads.
    """
    res = spec.resources or {}
    locally_feasible = feasible(total_resources, res)
    if locally_feasible and local_utilization < threshold:
        return None
    if spec.spill_count >= flags_mod.get("RTPU_MAX_SPILLS"):
        return None  # settled: no more hops (prevents ping-pong)
    cands: list[tuple[float, bytes]] = []
    for nid, node in cluster_nodes.items():
        if nid == node_id or not node.alive:
            continue
        if not node.available and node.resources:
            # draining: the node advertises NO availability map at all
            # (a busy node still advertises zeroed keys) — never a
            # target, even for the saturated top-k spread
            continue
        if not feasible(node.resources, res):
            continue
        cands.append((node_utilization(
            node.available, node.resources,
            int(getattr(node, "queued", 0))), nid))
    if not cands:
        return None  # infeasible everywhere: local queue keeps it
    cands.sort()
    if locally_feasible and local_utilization <= cands[0][0]:
        return None  # local is (still) the least-loaded feasible node
    top = cands[:max(1, top_k)]
    if top[0][0] < threshold:
        # an under-threshold node exists: take the least utilized
        # (deterministic — first in (util, node_id) order)
        return top[0][1]
    # every candidate is past the threshold: spread over the top-k,
    # keyed by task id so the choice is stable per task
    key = int.from_bytes(spec.task_id[:8] or b"\0", "little")
    return top[key % len(top)][1]


def commit_spill(spec: TaskSpec, target: bytes, cluster_nodes: dict):
    """Book a spill decision on the cached view: bump the spec's hop
    count and debit the chosen node's advertised availability so the next
    task in the same view window picks a different node instead of
    dogpiling this one; the target's own heartbeat re-syncs truth."""
    spec.spill_count += 1
    node = cluster_nodes.get(target)
    if node is None:
        return
    avail = node.available
    for k, v in (spec.resources or {}).items():
        avail[k] = avail.get(k, 0) - v


def pick_spill_target(
    spec: TaskSpec,
    node_id: bytes,
    total_resources: dict,
    cluster_nodes: dict,
) -> Optional[bytes]:
    """Pick a peer node for a task this node can't run right now
    (reference: hybrid policy spillback,
    policy/hybrid_scheduling_policy.cc — local-first, then best feasible
    remote by available capacity).  This is the dispatch-loop/slow-path
    companion of hybrid_decide: it honors the full strategy surface
    (hard/soft labels, affinity, PG pinning) that the queue-time fast
    path filters out before calling hybrid_decide.  Debits the cached
    view of the chosen node so the next task in the same pass picks a
    different node instead of dogpiling this one."""
    if spec.pg_id is not None or spec.spill_count >= flags_mod.get("RTPU_MAX_SPILLS"):
        return None  # PG bundles are reserved on this node
    if spec.node_affinity == node_id and not spec.affinity_soft:
        return None
    from ray_tpu_torch.util.scheduling_strategies import labels_match

    hard = getattr(spec, "label_selector", None)
    soft = getattr(spec, "label_selector_soft", None)
    res = spec.resources or {}
    locally_feasible = feasible(total_resources, res)
    best, best_score = None, -1.0
    for nid, node in cluster_nodes.items():
        if nid == node_id or not node.alive:
            continue
        if not node.available and node.resources:
            continue  # draining (empty availability map): never a target
        labels = getattr(node, "labels", None)
        if hard and not labels_match(hard, labels):
            continue  # hard label selector excludes this node
        if not feasible(node.resources, res):
            continue  # never feasible there
        has_now = feasible(node.available, res)
        if not has_now and locally_feasible and not hard:
            # feasible here eventually: only spill to nodes with free
            # capacity right now (a hard selector has no "here" option)
            continue
        score = (1000.0 if has_now else 0.0) + sum(
            node.available.get(k, 0) for k in ("CPU", "GPU"))
        if soft and labels_match(soft, labels):
            score += 10000.0  # soft label preference dominates load
        if score > best_score:
            best, best_score = nid, score
    if best is not None:
        commit_spill(spec, best, cluster_nodes)
    return best


def peer_could_take(
    spec: TaskSpec,
    node_id: bytes,
    cluster_nodes: dict,
) -> bool:
    """Is there ANY alive, non-draining peer whose TOTALS cover the ask?
    A draining node uses this to choose between holding a movable task
    until remote capacity frees up (the reference raylet rejects new
    leases while draining) and starting it locally as a true last
    resort — when no peer could ever run it, waiting would strand it."""
    res = spec.resources or {}
    for nid, node in cluster_nodes.items():
        if nid == node_id or not node.alive:
            continue
        if not node.available and node.resources:
            continue  # that peer is draining too
        if feasible(node.resources, res):
            return True
    return False


# ---------------------------------------------------------------------------
# Pending-queue structure
# ---------------------------------------------------------------------------

def is_routed(spec: TaskSpec) -> bool:
    """Does this spec need per-spec routing policy (actor placement, PG
    bundle lookup, label/affinity matching)?  Routed specs live on a
    scan deque like before; everything else — plain tasks whose
    schedulability depends only on their resource ask — buckets by
    shape."""
    return (spec.kind != TASK
            or spec.pg_id is not None
            or spec.node_affinity is not None
            or bool(spec.label_selector))


def shape_key(spec: TaskSpec) -> tuple:
    return tuple(sorted(
        (k, float(v)) for k, v in (spec.resources or {}).items()))


class PendingQueues:
    """The node scheduler's pending-task store (reference: the scheduling
    class queues in cluster_task_manager.h, keyed by SchedulingClass —
    one entry per distinct resource shape).

    Two lanes:

    - ``routed``: specs whose placement needs per-spec policy (actor
      methods, PG bundles, labels, affinity).  Small; the dispatch loop
      scans it like the old single deque.
    - shape buckets: plain tasks keyed by their resource ask.  Tasks in
      one bucket are interchangeable for feasibility, so the dispatch
      loop decides once per SHAPE and stops at the first blocked head
      instead of visiting every queued spec — O(#shapes), not O(#tasks),
      per wakeup with a deep backlog.

    FIFO order is preserved within a lane/bucket; the deque surface the
    scheduler used (append / appendleft / remove / in / len / iter) is
    kept so call sites outside the dispatch loop are unchanged.
    """

    __slots__ = ("routed", "_shapes")

    def __init__(self):
        self.routed: deque[TaskSpec] = deque()
        self._shapes: dict[tuple, deque] = {}

    def append(self, spec: TaskSpec):
        if is_routed(spec):
            self.routed.append(spec)
        else:
            q = self._shapes.get(key := shape_key(spec))
            if q is None:
                q = self._shapes[key] = deque()
            q.append(spec)

    def appendleft(self, spec: TaskSpec):
        if is_routed(spec):
            self.routed.appendleft(spec)
        else:
            q = self._shapes.get(key := shape_key(spec))
            if q is None:
                q = self._shapes[key] = deque()
            q.appendleft(spec)

    def remove(self, spec: TaskSpec):
        if is_routed(spec):
            self.routed.remove(spec)
            return
        q = self._shapes.get(shape_key(spec))
        if q is None:
            raise ValueError("spec not pending")
        q.remove(spec)
        if not q:
            del self._shapes[shape_key(spec)]

    def __contains__(self, spec: TaskSpec) -> bool:
        if is_routed(spec):
            return spec in self.routed
        q = self._shapes.get(shape_key(spec))
        return q is not None and spec in q

    def __len__(self) -> int:
        return len(self.routed) + sum(
            len(q) for q in self._shapes.values())

    def __iter__(self) -> Iterator[TaskSpec]:
        yield from self.routed
        for q in self._shapes.values():
            yield from q

    def head(self, n: int) -> list[TaskSpec]:
        """First n specs across lanes (state-snapshot demand signal) —
        stops early instead of materializing a 1M-entry backlog."""
        out: list[TaskSpec] = []
        for spec in self:
            if len(out) >= n:
                break
            out.append(spec)
        return out

    def shape_buckets(self) -> list[tuple[tuple, deque]]:
        """Snapshot of (shape, bucket) pairs for the dispatch loop."""
        return list(self._shapes.items())

    def prune_empty(self):
        for key in [k for k, q in self._shapes.items() if not q]:
            del self._shapes[key]
