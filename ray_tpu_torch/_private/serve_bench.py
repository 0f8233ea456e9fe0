"""Serving load-wall benchmark: prefix-aware vs pow-2 routing.

Counterpart of ``ray_tpu/_private/serve_bench.py``.  A concurrency ladder
of bursty hot-family chat traffic driven through TWO of the port's
``LLMEngine``s behind the port's request-router classes
(``serve/request_router/``): no cluster, no actors, so the numbers isolate
routing policy and engine paging, not RPC overhead.  Traffic shape: 14
prompt families, each a 220-token shared prefix + a unique tail; requests
arrive in bursts of 1-4 from one family; a hot head family that drifts
across the family space over the run draws ~1.5x the average share, the
rest spreads evenly over the remainder.  The 220-token prefix is not
page-aligned: the last 4 shared tokens sit inside a partial block, so
family siblings exercise the copy-on-write boundary page, not just
full-page hits.

The page pool is sized below the COMBINED family set, so the top rung
drives both engines into sustained prefix-cache page eviction: the
serving load wall, where family-aware eviction, COW reuse and hit-aware
admission either convert routing locality into throughput or don't.

Per rung and policy: TTFT p50/p90, request/token throughput, engine
preemptions + page evictions split by class (cold_family vs
hot_root_forced), prefill tokens saved, COW page copies, the aggregate
prefix-cache hit rate and the router's decisions.  The acceptance block
holds the reference's keys: the top rung saw the load wall (page
evictions under both policies), prefix-aware's hit rate above pow-2's,
its req/s >= 1.10x pow-2's with p90 TTFT no worse, and prefill tokens
saved.

The KILL RUNG drills mid-burst replica death: two engines share a KV
tier (``llm/kv_tier.py``, in-process store), one is stopped at ~45%
completion, the router purges it, and in-flight requests fail over to
the survivor.  Run with the tier on and off, it measures requests
completed (all of them, zero errors), extra prefill tokens paid after the
kill, and the time for the survivor's hit rate to recover to 80% of the
pre-kill cluster rate.

Run (from the repo root)::

    python -m ray_tpu_torch._private.serve_bench               # the card
    python -m ray_tpu_torch._private.serve_bench --device cpu \\
        --ladder 4:16,8:32

It prints one JSON line ``{"serve_bench": {...}}`` and exits 1 when the
acceptance block fails.  ``run()`` is the same benchmark for a caller's
model.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import random
import sys
import threading
import time

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.llm.engine import (EngineConfig, LLMEngine, SamplingParams,
                                      _to_device)
from ray_tpu_torch.llm.kv_tier import InProcessStore, KVTier, LocalDirectory
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.request_router import Pow2Router, PrefixAwareRouter

# Geometry is chosen so ROUTING decides residency: a family's shared
# prefix is 27 full pages, so the full 14-family set (378 pages) is far
# past one engine's 259 allocatable pages, but each half (189 pages)
# fits alongside the ~48 transient tail pages of 16 active slots.
# Prefix-aware routing splits families across the two engines and each
# engine's working set fits; pow-2 sprays every family at both engines
# and each holds barely half the set, so it recomputes a long prefix on
# nearly every other request.  A miss prefills the 240-token bucket
# (through the flash kernel) where a hit prefills 16 (the plain paged
# attention): the reference reckons residency worth ~15x a request.  The
# 232-token prompt fills exactly 29 pages.  Decode is short: decode steps
# cost both policies the same, so a long decode phase only dilutes the
# prefill compute that routing locality saves.
_PAGE_SIZE = 8
_NUM_PAGES = 260
_MAX_SLOTS = 16
_PREFIX_TOKENS = 220  # shared per family; 27 full pages + 4 tokens of a
#                       partial boundary block (the COW case)
_TAIL_TOKENS = 12     # unique per request
_MAX_TOKENS = 1       # short decode: prefill-dominated, like chat TTFT
_FAMILIES = 14
_BUCKETS = (8, 16, 32, 240)  # hit suffix -> 16, miss -> 240; 32 and 8
#                              cover resumes of partially-evicted chains
_MAX_SEQ_LEN = 256

LADDER = ((4, 128), (16, 256), (32, 1024))
_KILL_RUNG = {"concurrency": 8, "requests": 192, "families": 6,
             "kill_frac": 0.45}
# Burst size is 1-4 and per-engine queues run ~16 deep at the top rung,
# so the router's general-purpose default (shed past a load gap of 4)
# misroutes ~20% of traffic onto cold replicas here; a shed is worth a
# whole recomputed prefix, so it must mean a real sustained imbalance.
# The environment still wins, as in the reference.
_BENCH_IMBALANCE = "16"


class _FakeReplica:
    def __init__(self, rid: bytes):
        self.actor_id = rid


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _percentile(xs, frac):
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[int((len(xs) - 1) * frac)] * 1e3, 2)  # ms


def _family_prefix(fam: int):
    base = 1 + (fam * 5) % 90
    p = [base, base + 1, base + 2] * (_PREFIX_TOKENS // 3 + 1)
    return p[:_PREFIX_TOKENS]


def _build_requests(n: int, seed: int, families: int = _FAMILIES):
    """Bursty hot-family traffic: bursts of 1-4 requests from one family;
    ~10% of bursts go to a hot head that drifts across the family space as
    the run progresses, the rest spread evenly over the remaining
    families, so every family stays live and residency is decided by
    WHERE requests land (routing), not by skew alone."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        phase = len(out) / max(n - 1, 1)
        head = int(phase * 4) % families  # the hot family drifts
        if rng.random() < 0.1:
            fam = head
        else:
            fam = (head + 1 + rng.randrange(families - 1)) % families
        prefix = _family_prefix(fam)
        hint = f"family-{fam:02d}:" + "q" * 48
        for _ in range(min(rng.randrange(1, 5), n - len(out))):
            tail = [rng.randrange(1, 127) for _ in range(_TAIL_TOKENS)]
            out.append((hint, prefix + tail))
    return out


def _engine_config():
    return EngineConfig(max_slots=_MAX_SLOTS, num_pages=_NUM_PAGES,
                        page_size=_PAGE_SIZE, max_seq_len=_MAX_SEQ_LEN,
                        prefill_buckets=_BUCKETS)


def _router(cls, app: str, deployment: str):
    router = cls(app, deployment)
    if isinstance(router, PrefixAwareRouter):
        router.imbalance = float(os.environ.get("RTPU_ROUTER_IMBALANCE",
                                                _BENCH_IMBALANCE))
    return router


def _stats_pump(router, engines, dead, done):
    """The controller lane's stand-in: a replica-stats refresh every
    0.2 s."""
    while not done.wait(0.2):
        try:
            router.update_stats({
                rid: {"queue_len": (st := e.stats())["waiting"]
                      + st["active_slots"],
                      "age_s": 0.0, "engine": st}
                for rid, e in engines.items() if rid not in dead})
        except Exception:  # noqa: BLE001 — pump must not die mid-bench
            pass


def _run_cell(model, router_cls, n_requests: int, concurrency: int,
              seed: int, device=None):
    """One (policy, rung) cell: fresh engines + fresh router."""
    state, cfg = model
    engines = {}
    for rid in (b"e1", b"e2"):
        eng = LLMEngine(state, cfg, _engine_config(), device=device)
        eng.start()
        engines[rid] = eng
    router = _router(router_cls, "bench",
                     f"{router_cls.__name__}-c{concurrency}")
    router.update_replicas([_FakeReplica(rid) for rid in engines])
    requests = _build_requests(n_requests, seed)
    random.seed(seed)

    next_i = [0]
    ilock = threading.Lock()
    ttfts, e2es = [], []
    tokens_out = [0]
    rlock = threading.Lock()
    errors = []
    done = threading.Event()

    def worker():
        while True:
            with ilock:
                i = next_i[0]
                if i >= len(requests):
                    return
                next_i[0] += 1
            hint, toks = requests[i]
            rep = router.choose(hint)
            router.on_send(rep.actor_id)
            t0 = time.monotonic()
            try:
                req = engines[rep.actor_id].submit(
                    toks, SamplingParams(max_tokens=_MAX_TOKENS))
                first = None
                n_out = 0
                while True:
                    item = req.out_queue.get(timeout=300)
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    if first is None:
                        first = time.monotonic() - t0
                    n_out += 1
                with rlock:
                    if first is not None:
                        ttfts.append(first)
                    e2es.append(time.monotonic() - t0)
                    tokens_out[0] += n_out
            except Exception as e:  # noqa: BLE001
                with rlock:
                    errors.append(f"{type(e).__name__}: {e}")
            finally:
                router.on_done(rep.actor_id)

    pump = threading.Thread(target=_stats_pump,
                            args=(router, engines, (), done), daemon=True)
    pump.start()
    t_start = time.monotonic()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t_start
    done.set()
    pump.join(timeout=2)

    # a finished request's pages register just after its stream ends:
    # join the schedulers before reading their counters
    for e in engines.values():
        e.stop()
    preempted = evictions = hits = lookups = 0
    saved = cow = ev_cold = ev_forced = 0
    prefill_ms = []
    for e in engines.values():
        st = e.stats()
        preempted += st["preempted"]
        evictions += st["page_evictions"]
        saved += st["prefill_tokens_saved"]
        cow += st["cow_copies"]
        pc = st["prefix_cache"] or {}
        hits += pc.get("hit_tokens", 0)
        lookups += pc.get("lookup_tokens", 0)
        ev_cold += pc.get("evictions_cold_family", 0)
        ev_forced += pc.get("evictions_hot_root_forced", 0)
        prefill_ms.append((st["p50_prefill_ms"], st["p90_prefill_ms"]))
    if errors:
        raise RuntimeError(f"{len(errors)} request(s) failed; first: "
                           f"{errors[0]}")
    decisions = dict(router._decisions)
    return {
        "requests": len(e2es),
        "wall_s": round(wall, 2),
        "req_per_s": round(len(e2es) / wall, 1),
        "tok_per_s": round(tokens_out[0] / wall, 1),
        "ttft_p50_ms": _percentile(ttfts, 0.5),
        "ttft_p90_ms": _percentile(ttfts, 0.9),
        "e2e_p90_ms": _percentile(e2es, 0.9),
        "preempted": preempted,
        "page_evictions": evictions,
        "evictions_cold_family": ev_cold,
        "evictions_hot_root_forced": ev_forced,
        "prefill_tokens_saved": saved,
        "cow_copies": cow,
        "prefix_hit_rate": round(hits / max(lookups, 1), 3),
        "decisions": decisions,
        # each engine's (p50, p90) prefill ms over its last 128 prefills:
        # the two engines share one device stream, so each prefill's
        # host read of its logits also waits for the other's queued work
        "prefill_ms_p50_p90": prefill_ms,
    }


def _run_kill_cell(model, tier_on: bool, n_requests: int, concurrency: int,
                   seed: int, families: int = 6, kill_frac: float = 0.45,
                   device=None):
    """Mid-burst replica-kill cell: two engines behind the prefix-aware
    router; at ``kill_frac`` completion e1 stops, the router purges it,
    and every remaining request lands on the survivor.  The families set
    (6 x 28 pages) fits a LONE engine's pool, so post-kill hit rate is
    decided by how the survivor acquires the dead engine's families:
    pulled from the KV tier (tier_on) or recomputed by cold prefills
    (tier_off)."""
    state, cfg = model
    store, dirx = InProcessStore(), LocalDirectory()
    engines = {}
    for rid in (b"e1", b"e2"):
        tier = KVTier(store, dirx, seal_min_hits=1) if tier_on else None
        eng = LLMEngine(state, cfg, _engine_config(), kv_tier=tier,
                        device=device)
        eng.start()
        engines[rid] = eng
    router = _router(PrefixAwareRouter, "bench",
                     f"kill-tier-{'on' if tier_on else 'off'}")
    router.update_replicas([_FakeReplica(rid) for rid in engines])
    requests = _build_requests(n_requests, seed, families=families)

    dead = set()  # rid; membership checked lock-free (GIL-atomic)
    next_i = [0]
    completed = [0]
    failovers = [0]
    ilock = threading.Lock()
    rlock = threading.Lock()
    errors = []
    done = threading.Event()
    kill_at = int(n_requests * kill_frac)
    t_kill = [None]
    kill_snap = [None]  # survivor's prefix_cache stats at kill time
    pre_rate = [None]
    samples = []  # (t, cluster hit_tokens, cluster lookup_tokens)

    def live_pc():
        h = look = 0
        for rid, e in engines.items():
            if rid in dead:
                continue
            pc = e.stats()["prefix_cache"] or {}
            h += pc.get("hit_tokens", 0)
            look += pc.get("lookup_tokens", 0)
        return h, look

    def sampler():
        while not done.wait(0.05):
            h, look = live_pc()
            with rlock:
                samples.append((time.monotonic(), h, look))

    def killer():
        while not done.is_set():
            with rlock:
                if completed[0] >= kill_at:
                    break
            time.sleep(0.005)
        if done.is_set():
            return  # the run finished before the kill point
        now = time.monotonic()
        with rlock:
            win = [s for s in samples if now - s[0] <= 2.0] or samples[-2:]
        if len(win) >= 2 and win[-1][2] > win[0][2]:
            pre_rate[0] = ((win[-1][1] - win[0][1])
                           / (win[-1][2] - win[0][2]))
        kill_snap[0] = dict(engines[b"e2"].stats()["prefix_cache"] or {})
        # the kill: mark dead FIRST so blocked workers abandon e1's
        # queues at once, then stop it (the flag, then a join: its thread
        # ends after the iteration it is in) and purge it
        dead.add(b"e1")
        t_kill[0] = time.monotonic()
        engines[b"e1"].stop()
        router.purge_dead([b"e1"])
        router.update_replicas([_FakeReplica(b"e2")])

    def worker():
        while True:
            with ilock:
                i = next_i[0]
                if i >= len(requests):
                    return
                next_i[0] += 1
            hint, toks = requests[i]
            deadline = time.monotonic() + 300
            ok = False
            while not ok:
                rep = router.choose(hint)
                if rep.actor_id in dead:  # raced the purge
                    time.sleep(0.01)
                    continue
                router.on_send(rep.actor_id)
                try:
                    req = engines[rep.actor_id].submit(
                        toks, SamplingParams(max_tokens=_MAX_TOKENS))
                    while True:
                        try:
                            item = req.out_queue.get(timeout=0.25)
                        except queue_mod.Empty:
                            if rep.actor_id in dead:
                                # replica died under this request:
                                # abandon and resubmit on a survivor
                                with rlock:
                                    failovers[0] += 1
                                break
                            if time.monotonic() > deadline:
                                raise RuntimeError("request wedged")
                            continue
                        if item is None:
                            ok = True
                            break
                        if isinstance(item, Exception):
                            raise item
                except Exception as e:  # noqa: BLE001
                    with rlock:
                        errors.append(f"{type(e).__name__}: {e}")
                    break
                finally:
                    router.on_done(rep.actor_id)
            if ok:
                with rlock:
                    completed[0] += 1

    aux = [threading.Thread(target=f, daemon=True) for f in (sampler,
                                                             killer)]
    aux.append(threading.Thread(target=_stats_pump,
                                args=(router, engines, dead, done),
                                daemon=True))
    for t in aux:
        t.start()
    t_start = time.monotonic()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t_start
    done.set()
    for t in aux:
        t.join(timeout=2)

    # recovery: first post-kill instant where the survivor's rolling
    # (~0.5 s window) hit rate is back to 80% of the pre-kill cluster rate
    recovery_s = None
    if t_kill[0] is not None and pre_rate[0]:
        post = [s for s in samples if s[0] > t_kill[0]]
        for j in range(1, len(post)):
            t1, h1, l1 = post[j]
            k = j - 1
            while k > 0 and t1 - post[k - 1][0] <= 0.5:
                k -= 1
            t0, h0, l0 = post[k]
            if l1 > l0 and (h1 - h0) / (l1 - l0) >= 0.8 * pre_rate[0]:
                recovery_s = t1 - t_kill[0]
                break

    for e in engines.values():
        e.stop()  # then read: the last registrations and seals land
    surv = engines[b"e2"].stats()
    surv_pc = surv["prefix_cache"] or {}
    extra = None
    if kill_snap[0] is not None:
        d_look = (surv_pc.get("lookup_tokens", 0)
                  - kill_snap[0].get("lookup_tokens", 0))
        d_hit = (surv_pc.get("hit_tokens", 0)
                 - kill_snap[0].get("hit_tokens", 0))
        extra = d_look - d_hit  # tokens the survivor had to prefill cold
    kv = {k: sum(e.stats()[k] for e in engines.values())
          for k in ("kv_seals", "kv_pulls", "kv_pull_pages",
                    "kv_pull_fallbacks")}
    return {
        "tier": "on" if tier_on else "off",
        "requests_completed": completed[0],
        "errors": len(errors),
        "first_error": errors[0] if errors else None,
        "failovers": failovers[0],
        "wall_s": round(wall, 2),
        "kill_at_request": kill_at,
        "pre_kill_hit_rate":
            round(pre_rate[0], 3) if pre_rate[0] else None,
        "recovery_s": round(recovery_s, 2) if recovery_s else None,
        "extra_prefill_tokens_post_kill": extra,
        "survivor_hit_rate": surv_pc.get("hit_rate"),
        **kv,
    }


def _warmup(model, device) -> None:
    """Pay what a first call costs before any timed cell: the kernel
    build at first use, cuBLAS handle creation, the caching allocator's
    first growth, and every prefill path the cells take."""
    state, cfg = model
    sp = SamplingParams(max_tokens=_MAX_TOKENS)
    warm = LLMEngine(state, cfg, _engine_config(), device=device)
    # ids 1-126 like the traffic's (the reference's warmup prefix runs
    # 1-220, past its own model's vocab of 128, which XLA's gather clamps
    # and torch's indexing refuses)
    prefix = [1 + i % 126 for i in range(_PREFIX_TOKENS)]
    try:
        # miss prefill (bucket 240, the flash kernel) + chain insert
        warm.generate(prefix + [99] * _TAIL_TOKENS, sp)
        # COW sibling: full-page hit + boundary copy, 12-token suffix ->
        # the bucket every steady-state family hit lands in (16)
        warm.generate(prefix + [101] * _TAIL_TOKENS, sp)
        # COW hit with a 2-token suffix -> bucket 8 (short resumes)
        warm.generate(prefix + [103] * 2, sp)
        # short matches (partially evicted chains, preemption resumes):
        # the remaining suffix buckets
        warm.generate(prefix[:16] + [105] * 20, sp)   # suffix 20 -> 32
        warm.generate(prefix[:8] + [107] * 226, sp)   # suffix 226 -> 240
    finally:
        warm.stop()
    # KV-tier roundtrip: seal on one engine, pull on a fresh one, so the
    # kill rung's first failover pull pays no first-call cost and does
    # not distort time-to-recovery
    wstore, wdir = InProcessStore(), LocalDirectory()
    warm = LLMEngine(state, cfg, _engine_config(),
                     kv_tier=KVTier(wstore, wdir, seal_min_hits=1),
                     device=device)
    try:
        warm.generate(prefix + [99] * _TAIL_TOKENS, sp)
        warm.generate(prefix + [101] * _TAIL_TOKENS, sp)  # hit -> seal
    finally:
        warm.stop()
    warm = LLMEngine(state, cfg, _engine_config(),
                     kv_tier=KVTier(wstore, wdir, seal_min_hits=1),
                     device=device)
    try:
        warm.generate(prefix + [103] * _TAIL_TOKENS, sp)  # admission pull
    finally:
        warm.stop()
    if warm.stats()["kv_pulls"] < 1:
        _log("warmup: WARNING tier pull did not trigger")


def run(model, ladder=LADDER, seed: int = 7, device=None) -> dict:
    """The whole benchmark for ``model`` = ``(state, cfg)`` (a Llama
    parameter tree and its ``LlamaConfig``): the warmup, each
    ``(concurrency, requests)`` rung of ``ladder`` under both policies,
    then the kill rung with the tier off and on.  Returns the results
    dict; ``results["acceptance"]`` holds the reference's checks as
    computed here.  Runs on CUDA unless ``device="cpu"``."""
    device = resolve_device(device)
    state, cfg = model
    # cast once: every engine of the run then shares the same weights
    model = (llama.cast_weights(_to_device(state, device), cfg), cfg)
    _log("warmup: every prefill path, then a KV-tier roundtrip")
    _warmup(model, device)

    rows = []
    for concurrency, n_requests in ladder:
        row = {"concurrency": concurrency, "requests": n_requests}
        for name, cls in (("pow2", Pow2Router),
                          ("prefix_aware", PrefixAwareRouter)):
            _log(f"running: c={concurrency} n={n_requests} policy={name}")
            row[name] = cell = _run_cell(model, cls, n_requests,
                                         concurrency, seed, device)
            _log(f"  {name:13s} {cell['req_per_s']:7.1f} req/s  "
                 f"ttft p50 {cell['ttft_p50_ms']}ms "
                 f"p90 {cell['ttft_p90_ms']}ms  "
                 f"hit {cell['prefix_hit_rate']:.1%}  "
                 f"saved {cell['prefill_tokens_saved']}  "
                 f"cow {cell['cow_copies']}  "
                 f"preempt {cell['preempted']}  "
                 f"evict {cell['page_evictions']}")
        rows.append(row)

    kill = dict(_KILL_RUNG)
    for name, flag in (("tier_off", False), ("tier_on", True)):
        _log(f"running: kill rung {name}")
        kill[name] = cell = _run_kill_cell(
            model, flag, kill["requests"], kill["concurrency"], seed,
            families=kill["families"], kill_frac=kill["kill_frac"],
            device=device)
        _log(f"  {name:9s} completed {cell['requests_completed']}"
             f"/{kill['requests']}  errors {cell['errors']}  "
             f"failovers {cell['failovers']}  "
             f"recovery {cell['recovery_s']}s  "
             f"extra prefill {cell['extra_prefill_tokens_post_kill']} tok  "
             f"pulls {cell['kv_pulls']}")

    top = rows[-1]
    return {
        "engines": 2,
        "max_slots": _MAX_SLOTS,
        "num_pages": _NUM_PAGES,
        "page_size": _PAGE_SIZE,
        "prompt_tokens": _PREFIX_TOKENS + _TAIL_TOKENS,
        "max_tokens": _MAX_TOKENS,
        "families": _FAMILIES,
        "device": str(device),
        "ladder": rows,
        "kill_rung": kill,
        "acceptance": {
            "top_rung_requests": top["requests"],
            "nonzero_page_evictions":
                top["prefix_aware"]["page_evictions"] > 0
                and top["pow2"]["page_evictions"] > 0,
            "prefix_aware_beats_pow2":
                top["prefix_aware"]["prefix_hit_rate"]
                > top["pow2"]["prefix_hit_rate"],
            # locality must convert into throughput, not just hit rate:
            # >=10% more req/s with tail TTFT no worse
            "prefix_aware_beats_pow2_req_s":
                top["prefix_aware"]["req_per_s"]
                >= 1.10 * top["pow2"]["req_per_s"],
            "prefix_aware_ttft_p90_no_worse":
                top["prefix_aware"]["ttft_p90_ms"]
                <= top["pow2"]["ttft_p90_ms"],
            "prefill_tokens_saved_positive":
                top["prefix_aware"]["prefill_tokens_saved"] > 0,
            # kill rung: a mid-burst replica kill never errors or wedges
            # a request, the tier-on cell recovers 80% of the pre-kill
            # hit rate within 5 s by PULLING spines, and failed-over
            # traffic pays fewer extra prefill tokens than tier-off
            "kill_zero_errors_or_wedges": all(
                kill[c]["errors"] == 0
                and kill[c]["requests_completed"] == kill["requests"]
                for c in ("tier_on", "tier_off")),
            "kill_recovery_within_5s":
                kill["tier_on"]["recovery_s"] is not None
                and kill["tier_on"]["recovery_s"] <= 5.0,
            "kill_tier_pays_fewer_extra_prefill_tokens":
                kill["tier_on"]["extra_prefill_tokens_post_kill"]
                is not None
                and kill["tier_off"]["extra_prefill_tokens_post_kill"]
                is not None
                and kill["tier_on"]["extra_prefill_tokens_post_kill"]
                < kill["tier_off"]["extra_prefill_tokens_post_kill"],
            "kill_kv_pulls_positive": kill["tier_on"]["kv_pulls"] > 0,
        },
    }


def reference_model(device=None):
    """The reference benchmark's model: big enough that a 240-token miss
    prefill costs real compute against a 16-token hit suffix (on a toy
    model per-call overhead dominates)."""
    device = resolve_device(device)
    cfg = llama.LlamaConfig(
        vocab_size=128, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
        d_ff=2048, max_seq_len=256, dtype="float32", remat=False)
    state = llama.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    return state, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ladder",
                    default=",".join(f"{c}:{n}" for c, n in LADDER),
                    help="comma list of concurrency:requests rungs")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless 'cpu'")
    args = ap.parse_args(argv)

    ladder = tuple((int(c), int(n)) for c, n in
                   (rung.split(":") for rung in args.ladder.split(",")))
    results = run(reference_model(args.device), ladder, args.seed,
                  args.device)
    print(json.dumps({"serve_bench": results}))
    if not all(bool(v) for k, v in results["acceptance"].items()
               if k != "top_rung_requests"):
        _log(f"ACCEPTANCE FAILED: {results['acceptance']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
