"""The port's request routers against the JAX package's.

Every scenario of ``tests/test_request_router.py``'s unit tests runs
through both packages' routers with ``random.seed`` set alike; each
returns what it observed (choices, decisions, tree matches, loads,
snapshots) and the two records must be equal.  The scenarios also assert
the behaviour they are named for, on both sides.  The routers' decisions
counter is read from each package's metrics registry and must grow
alike.
"""

import random
import types

import pytest

import ray_tpu.serve.request_router as jrr
import ray_tpu.util.metrics as jmetrics
import ray_tpu_torch.serve.request_router as trr
import ray_tpu_torch.util.metrics as tmetrics
from ray_tpu.serve.request_router import base as jbase
from ray_tpu_torch.serve.request_router import base as tbase

PACKAGES = {
    "jax": types.SimpleNamespace(
        Pow2Router=jrr.Pow2Router, PrefixAwareRouter=jrr.PrefixAwareRouter,
        PrefixTree=jrr.PrefixTree, get_router=jrr.get_router,
        registry=jbase._REGISTRY, metrics=jmetrics),
    "torch": types.SimpleNamespace(
        Pow2Router=trr.Pow2Router, PrefixAwareRouter=trr.PrefixAwareRouter,
        PrefixTree=trr.PrefixTree, get_router=trr.get_router,
        registry=tbase._REGISTRY, metrics=tmetrics),
}
# the decisions family, named as the port names it (prefix + suffix)
DECISIONS = tbase._FAMILY_PREFIX + "router_decisions_total"


class FakeReplica:
    def __init__(self, rid: bytes):
        self.actor_id = rid


def _pair():
    return FakeReplica(b"r1"), FakeReplica(b"r2")


def _aware(ns, reps):
    router = ns.PrefixAwareRouter("app", "d")
    router.update_replicas(reps)
    return router


def pow2_prefers_shorter_queue(ns):
    random.seed(0)
    router = ns.Pow2Router("app", "d")
    r1, r2 = _pair()
    router.update_replicas([r1, r2])
    for _ in range(3):
        router.on_send(r1.actor_id)
    picks = [router.choose().actor_id for _ in range(20)]
    assert picks == [b"r2"] * 20
    return picks, router.snapshot()


def ties_follow_the_sample(ns):
    """Equal loads: both policies take the first of the two sampled
    replicas (pow-2, and prefix-aware's fallback for a request with no
    hint), so the picks are the draws of ``random.sample``."""
    picks = []
    for cls in (ns.Pow2Router, ns.PrefixAwareRouter):
        random.seed(8)
        router = cls("app", "d")
        router.update_replicas(list(_pair()))
        picks.append([router.choose().actor_id for _ in range(20)])
        random.seed(8)
        want = [random.sample([b"r1", b"r2"], 2)[0] for _ in range(20)]
        assert picks[-1] == want
    return picks


def pow2_single_replica(ns):
    router = ns.Pow2Router("app", "d")
    r1 = FakeReplica(b"r1")
    router.update_replicas([r1])
    assert router.choose() is r1
    assert router._decisions["single"] == 1
    return router.snapshot()


def raises_without_replicas(ns):
    router = ns.Pow2Router("app", "d")
    with pytest.raises(RuntimeError, match="no running replicas") as err:
        router.choose()
    return str(err.value)


def tree_insert_and_deepest_match(ns):
    tree = ns.PrefixTree(block=4, cap=64)
    tree.insert("aaaabbbbcccc", b"r1")
    tree.insert("aaaabbbb", b"r2")
    live = {b"r1", b"r2"}
    out = [tree.match("aaaabbbbcccc", live), tree.match("aaaabbbb", live),
           tree.match("zzzz", live), tree.match("aaaabbbbcccc", {b"r2"})]
    assert out == [(b"r1", 3), (b"r2", 2), (None, 0), (b"r2", 2)]
    return out, len(tree)


def tree_lru_eviction(ns):
    tree = ns.PrefixTree(block=4, cap=3)
    tree.insert("aaaabbbbcccc", b"r1")
    sizes = [len(tree)]
    tree.insert("zzzz", b"r2")  # evicts the coldest node ("aaaa")
    sizes.append(len(tree))
    out = [tree.evictions, tree.match("aaaabbbbcccc", {b"r1", b"r2"}),
           tree.match("zzzz", {b"r2"})]
    tree.insert("aaaabbbbcccc", b"r1")
    out += [len(tree), tree.match("aaaabbbbcccc", {b"r1"}),
            tree.match("zzzz", {b"r2"}), tree.evictions]
    assert sizes == [3, 3]
    assert out[:3] == [1, (None, 0), (b"r2", 1)]
    assert out[4:6] == [(b"r1", 3), (None, 0)]
    return sizes, out


def tree_forget_replica(ns):
    tree = ns.PrefixTree(block=4, cap=16)
    tree.insert("aaaa", b"r1")
    tree.forget(b"r1")
    assert tree.match("aaaa", {b"r1"}) == (None, 0)
    return len(tree), tree.count_for(b"r1")


def prefix_affinity_sticks(ns):
    random.seed(1)
    router = _aware(ns, list(_pair()))
    hint = "system-prompt-alpha:" + "x" * 64
    picks = [router.choose(hint).actor_id for _ in range(21)]
    assert picks == picks[:1] * 21
    assert router._decisions["prefix_hit"] >= 20
    return picks, router.snapshot()


def imbalance_falls_back_to_pow2(ns):
    random.seed(2)
    r1, r2 = _pair()
    router = _aware(ns, [r1, r2])
    router.imbalance = 4.0
    hint = "shared-prefix:" + "y" * 64
    home = router.choose(hint)
    other = r2 if home is r1 else r1
    for _ in range(6):
        router.on_send(home.actor_id)
    shed = router.choose(hint)
    assert shed is other
    assert router._decisions["fallback_imbalanced"] >= 1
    for _ in range(6):
        router.on_done(home.actor_id)
    back = router.choose(hint)
    assert back is home  # the shed did not migrate the prefix home
    return [home.actor_id, shed.actor_id, back.actor_id], router.snapshot()


def new_prefixes_home_to_smallest_footprint(ns):
    random.seed(4)
    router = _aware(ns, list(_pair()))
    picks = [router.choose(f"family-{i:02d}:" + "z" * 48).actor_id
             for i in range(10)]
    assert picks.count(b"r1") == picks.count(b"r2") == 5
    return picks, router.snapshot()


def digest_hit_routes_to_page_holder(ns):
    random.seed(3)
    r1, r2 = _pair()
    router = _aware(ns, [r1, r2])
    digest = "deadbeefcafef00d"
    router.update_stats({r2.actor_id: {
        "queue_len": 0, "engine": {"prefix_digests": [digest]}}})
    picks = [router.choose(digest).actor_id for _ in range(5)]
    assert picks == [b"r2"] * 5
    assert router._decisions["digest_hit"] == 5
    return picks, router.snapshot()


def departed_replica_forgotten(ns):
    random.seed(4)
    r1, r2 = _pair()
    router = _aware(ns, [r1, r2])
    hint = "sticky:" + "z" * 64
    home = router.choose(hint)
    survivor = r2 if home is r1 else r1
    router.update_replicas([survivor])
    assert router.choose(hint) is survivor
    return home.actor_id, router.snapshot()


def purge_dead_evicts_stats_tree_and_routing(ns):
    random.seed(5)
    r1, r2 = _pair()
    router = _aware(ns, [r1, r2])
    digest = "feedfacecafebeef"
    hint = "doomed:" + "q" * 64
    router.update_stats({r1.actor_id: {
        "queue_len": 0, "engine": {"prefix_digests": [digest]}}})
    router.tree.insert(hint, r1.actor_id)
    before = [router.choose(digest).actor_id, router.choose(hint).actor_id]
    assert before == [b"r1", b"r1"]
    router.purge_dead([r1.actor_id])
    assert router.stats_for(r1.actor_id) is None
    assert router.tree.count_for(r1.actor_id) == 0
    after = [router.choose(h).actor_id for h in (digest, hint, None)]
    assert after == [b"r2"] * 3
    assert r1.actor_id not in router._inflight
    return before, after, router.snapshot()


def stale_stats_ignored(ns):
    router = ns.Pow2Router("app", "d")
    r1 = FakeReplica(b"r1")
    router.update_replicas([r1])
    router.update_stats({r1.actor_id: {"queue_len": 50, "age_s": 0.0}})
    fresh = router.load(r1.actor_id)
    router.update_stats({r1.actor_id: {"queue_len": 50, "age_s": 999.0}})
    stale = (router.stats_for(r1.actor_id), router.load(r1.actor_id))
    assert (fresh, stale) == (50, (None, 0))
    return fresh, stale


def load_is_max_of_local_and_reported(ns):
    router = ns.Pow2Router("app", "d")
    r1 = FakeReplica(b"r1")
    router.update_replicas([r1])
    router.update_stats({r1.actor_id: {"queue_len": 2, "age_s": 0.0}})
    for _ in range(5):
        router.on_send(r1.actor_id)
    loads = [router.load(r1.actor_id)]
    for _ in range(4):
        router.on_done(r1.actor_id)
    loads.append(router.load(r1.actor_id))
    assert loads == [5, 2]
    return loads


def stale_home_stats_count_as_loaded(ns):
    random.seed(6)
    r1, r2 = _pair()
    router = _aware(ns, [r1, r2])
    hint = "stale-gate:" + "s" * 64
    home = router.choose(hint)
    other = r2 if home is r1 else r1
    router.update_stats({
        home.actor_id: {"queue_len": 0, "age_s": 0.0},
        other.actor_id: {"queue_len": 0, "age_s": 0.0}})
    out = [router.choose(hint).actor_id,
           router._overloaded(home.actor_id, [r1, r2])]
    router.update_stats({
        home.actor_id: {"queue_len": 0, "age_s": 999.0},
        other.actor_id: {"queue_len": 0, "age_s": 0.0}})
    out.append(router._overloaded(home.actor_id, [r1, r2]))
    router.on_send(home.actor_id)
    out.append(router.choose(hint).actor_id)
    assert out == [home.actor_id, None, "stale", other.actor_id]
    assert router._decisions["fallback_stale"] >= 1
    return out, router.snapshot()


def stale_gate_open_without_fresh_stats(ns):
    random.seed(7)
    r1, r2 = _pair()
    router = _aware(ns, [r1, r2])
    hint = "no-stats:" + "n" * 64
    home = router.choose(hint)
    assert router._overloaded(home.actor_id, [r1, r2]) is None
    picks = [router.choose(hint).actor_id for _ in range(10)]
    assert picks == [home.actor_id] * 10
    return picks, router.snapshot()


def registry_shared_across_handles(ns):
    a = ns.get_router("app", "dep", "pow2")
    b = ns.get_router("app", "dep", "pow2")
    assert a is b
    a.on_send(b"r1")
    assert b._inflight[b"r1"] == 1
    assert ns.get_router("app", "other", "pow2") is not a
    return [r.snapshot() for r in ns.registry.values()]


def policy_swap_carries_inflight(ns):
    a = ns.get_router("app", "dep", "pow2")
    a.on_send(b"r1")
    a.update_replicas([FakeReplica(b"r1")])
    b = ns.get_router("app", "dep", "prefix_aware")
    assert b is not a and isinstance(b, ns.PrefixAwareRouter)
    assert b._inflight[b"r1"] == 1
    assert [r.actor_id for r in b.replicas()] == [b"r1"]
    assert ns.get_router("app", "dep", "prefix_aware") is b
    return b.snapshot()


def snapshot_shape(ns):
    random.seed(5)
    router = _aware(ns, list(_pair()))
    router.choose("hinted:" + "w" * 40)
    snap = router.snapshot()
    assert snap["policy"] == "prefix_aware"
    assert snap["replicas"] == 2
    assert sum(snap["decisions"].values()) == 1
    assert snap["prefix_tree"]["nodes"] >= 1
    return snap


SCENARIOS = [
    pow2_prefers_shorter_queue, ties_follow_the_sample, pow2_single_replica,
    raises_without_replicas,
    tree_insert_and_deepest_match, tree_lru_eviction, tree_forget_replica,
    prefix_affinity_sticks, imbalance_falls_back_to_pow2,
    new_prefixes_home_to_smallest_footprint,
    digest_hit_routes_to_page_holder, departed_replica_forgotten,
    purge_dead_evicts_stats_tree_and_routing, stale_stats_ignored,
    load_is_max_of_local_and_reported, stale_home_stats_count_as_loaded,
    stale_gate_open_without_fresh_stats, registry_shared_across_handles,
    policy_swap_carries_inflight, snapshot_shape,
]


def _decisions(ns):
    for snap in ns.metrics.snapshot():
        if snap["name"] == DECISIONS:
            return dict(snap["values"])
    return {}


def _run(ns, scenario):
    ns.registry.clear()
    before = _decisions(ns)
    try:
        record = scenario(ns)
    finally:
        ns.registry.clear()
    after = _decisions(ns)
    grew = {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
    return record, grew


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_routes_as_jax_does(scenario):
    want, want_grew = _run(PACKAGES["jax"], scenario)
    got, got_grew = _run(PACKAGES["torch"], scenario)
    assert got == want
    assert got_grew == want_grew
