"""Prefix-aware router: KV-locality routing for LLM deployments.

Counterpart of ``ray_tpu/serve/request_router/prefix_aware.py``.
Shared-prompt traffic only hits warm KV pages if the router keeps sending
a given prefix to the replica whose engine already holds its pages.  The
router keeps an approximate char-block prefix tree mapping prompt
prefixes to the replicas recently served with them; a request first
tries its deepest match, escapes to pow-2 when that replica is overloaded
past ``RTPU_ROUTER_IMBALANCE``, and records wherever it actually lands.

Two locality signals, strongest first:

1. digest hits: the replica-stats plane carries each engine's
   resident-prefix digests (``stats()["prefix_digests"]``); a hint that
   IS such a digest routes straight to the replica holding those pages;
2. the prefix tree: approximate (per process, char-block keyed,
   LRU-evicted at ``RTPU_ROUTER_PREFIX_CAP`` nodes), but cheap and
   hint-format agnostic.
"""

from __future__ import annotations

import os
import random
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.serve.request_router.base import RequestRouter

# tree depth cap: prefixes longer than this many blocks share the deepest
# node; locality beyond a few KB of prompt is decided by the engine's own
# page cache, not the router
_MAX_DEPTH = 8


class PrefixTree:
    """Approximate prefix -> replica map, char-block keyed.

    A node is the exact prefix string at each multiple of ``block`` chars
    (depth capped); its value maps replica id -> last-used timestamp.
    One global LRU over nodes, capped at ``cap``: eviction drops the
    coldest PREFIX, not the coldest replica, as the engine's page cache
    evicts whole blocks.
    """

    def __init__(self, block: Optional[int] = None,
                 cap: Optional[int] = None):
        self.block = block if block is not None else int(
            os.environ.get("RTPU_ROUTER_PREFIX_BLOCK", "32"))
        self.cap = cap if cap is not None else int(
            os.environ.get("RTPU_ROUTER_PREFIX_CAP", "4096"))
        self._nodes: "OrderedDict[str, Dict[bytes, float]]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _depths(self, hint: str) -> int:
        return min(_MAX_DEPTH, max(1, -(-len(hint) // self.block)))

    def insert(self, hint: str, rid: bytes) -> None:
        if not hint:
            return
        now = time.monotonic()
        for d in range(1, self._depths(hint) + 1):
            key = hint[:d * self.block]
            node = self._nodes.get(key)
            if node is None:
                node = self._nodes[key] = {}
            node[rid] = now
            self._nodes.move_to_end(key)
        while len(self._nodes) > self.cap:
            self._nodes.popitem(last=False)
            self.evictions += 1

    def match(self, hint: str,
              live: Set[bytes]) -> Tuple[Optional[bytes], int]:
        """Deepest node matching the hint with a live replica; returns
        (replica id most recently used there, depth) or (None, 0)."""
        if not hint:
            return None, 0
        best: Optional[bytes] = None
        best_depth = 0
        for d in range(1, self._depths(hint) + 1):
            key = hint[:d * self.block]
            node = self._nodes.get(key)
            if node is None:
                break
            self._nodes.move_to_end(key)
            alive = [(ts, rid) for rid, ts in node.items() if rid in live]
            if alive:
                best = max(alive)[1]
                best_depth = d
        return best, best_depth

    def forget(self, rid: bytes) -> None:
        """Drop a departed replica from every node."""
        for node in self._nodes.values():
            node.pop(rid, None)

    def count_for(self, rid: bytes) -> int:
        """Tree nodes homed on `rid`: a proxy for how much resident
        prefix working set has been assigned to that replica."""
        return sum(1 for node in self._nodes.values() if rid in node)


class PrefixAwareRouter(RequestRouter):
    policy = "prefix_aware"

    def __init__(self, app_name: str, deployment_name: str):
        super().__init__(app_name, deployment_name)
        self.tree = PrefixTree()
        self.imbalance = float(
            os.environ.get("RTPU_ROUTER_IMBALANCE", "4"))

    def update_replicas(self, replicas: List) -> None:
        with self._lock:
            gone = ({r.actor_id for r in self._replicas}
                    - {r.actor_id for r in replicas})
        super().update_replicas(replicas)
        for rid in gone:
            self.tree.forget(rid)

    def purge_dead(self, rids: List[bytes]) -> None:
        """Replica death: beyond the base purge (stats + in-flight), drop
        the corpse's prefix-tree homes so no hint re-homes onto it."""
        super().purge_dead(rids)
        for rid in rids or ():
            self.tree.forget(rid)

    def _overloaded(self, rid: bytes, reps: List) -> Optional[str]:
        """None when `rid` is an acceptable affinity home, else why not.

        "stale": rid's stats sample has aged out (RTPU_ROUTER_STALE_S)
        while some OTHER replica reports fresh ones: a silently deep
        queue counts as loaded, because load() falls back to this
        process's own in-flight count.  When NO replica has fresh stats
        the gate stays open: local counts are the only signal anywhere
        and they are already in load().

        "imbalanced": the home is loaded more than RTPU_ROUTER_IMBALANCE
        past the least-loaded replica.  The shed is load-only (see
        choose()): it spills the REQUEST without migrating the prefix
        home, so a transient queue spike costs one cold prefill instead
        of rebuilding the family's pages on the spill replica.
        """
        now = time.monotonic()
        with self._lock:
            st = self._stats.get(rid)
            fresh_elsewhere = any(
                r.actor_id != rid
                and (s := self._stats.get(r.actor_id)) is not None
                and now - s.ts <= self._stale_s
                for r in reps)
        if fresh_elsewhere and (st is None or now - st.ts > self._stale_s):
            return "stale"
        lo = min(self.load(r.actor_id) for r in reps)
        if self.load(rid) > lo + self.imbalance:
            return "imbalanced"
        return None

    def choose(self, hint: Optional[str] = None):
        reps = self._require_replicas()
        if len(reps) == 1:
            if hint:
                self.tree.insert(hint, reps[0].actor_id)
            self._record("single")
            return reps[0]
        by_id = {r.actor_id: r for r in reps}
        outcome = "no_hint"
        if hint:
            # 1. residency digests from the stats plane (P/D handoff: the
            #    hint is the prefill's block digest; route decode to pages)
            for r in reps:
                st = self.stats_for(r.actor_id)
                if st is not None and hint in st.digests:
                    if self._overloaded(r.actor_id, reps) is None:
                        self.tree.insert(hint, r.actor_id)
                        self._record("digest_hit", reps)
                        return r
                    break  # its holder is hot; fall through to the tree
            # 2. the approximate prefix tree
            rid, depth = self.tree.match(hint, set(by_id))
            if rid is not None:
                reason = self._overloaded(rid, reps)
                if reason is None:
                    self.tree.insert(hint, rid)
                    self._record("prefix_hit", reps)
                    return by_id[rid]
                outcome = f"fallback_{reason}"
            else:
                outcome = "prefix_miss"
        # pow-2 fallback; remember where the prefix landed so the NEXT
        # request sharing it follows (this is how homes form), EXCEPT on
        # an imbalance shed: a transient queue spike spills requests to
        # the other replica but must not migrate the prefix home, or the
        # family's pages are rebuilt on the spill replica and evict part
        # of its resident set.  ("stale" still re-homes: a queue we can't
        # observe may be arbitrarily deep.)
        a, b = random.sample(reps, 2)
        pick = a if self.load(a.actor_id) <= self.load(b.actor_id) else b
        if outcome == "prefix_miss":
            # an UNHOMED prefix is new working set, not just one request:
            # place it on the replica with the smallest homed-prefix
            # footprint (tree-node count), load-tiebroken.  First-touch
            # pow-2 homing splits prefix families ~binomially, and the
            # heavy half thrashes its page pool.
            pick = min(reps, key=lambda r: (
                self.tree.count_for(r.actor_id), self.load(r.actor_id)))
        if hint and outcome != "fallback_imbalanced":
            self.tree.insert(hint, pick.actor_id)
        self._record(outcome, reps)
        return pick

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["prefix_tree"] = {"nodes": len(self.tree),
                              "cap": self.tree.cap,
                              "block": self.tree.block,
                              "evictions": self.tree.evictions}
        return out
