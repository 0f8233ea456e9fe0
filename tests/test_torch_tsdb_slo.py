"""The port's ring TSDB and SLO engine (``ray_tpu_torch/_private/tsdb.py``,
``slo.py``) held to the JAX package's on the same inputs.

Seeded numpy streams of ``metrics_snapshot`` documents (gauges with tags,
counters that reset, histograms with exemplars, the runtime's store
counters across an incarnation bump, two sources) go into one TSDB of each
package; every windowed read (rates, quantiles, gauge aggregates, exemplars,
raw points, the overview, ``stats()``) must be equal.  The same arithmetic
runs in both, so floats are compared exactly.  The rule grammar, the env
overlay, the burn math, the fire / clear sequence of both engines over the
same ticks, ``attribute_burn`` on the same spans and ``status_metrics`` are
compared the same way.
"""

import numpy as np
import pytest

from ray_tpu._private import slo as jslo
from ray_tpu._private import tsdb as jtsdb
from ray_tpu_torch._private import slo as tslo
from ray_tpu_torch._private import tsdb as ttsdb

BOUNDS = (0.01, 0.1, 1.0)
NODE = b"\x07" * 8


def _stream(seed: int, n: int = 60):
    """``n`` snapshot documents at 1 s apart: a tagged gauge, a counter
    that resets once, a histogram with exemplars, and the runtime's store
    counter with a daemon restart, from two sources."""
    rng = np.random.default_rng(seed)
    reset_at = int(rng.integers(n // 4, 3 * n // 4))
    restart_at = int(rng.integers(n // 4, 3 * n // 4))
    c = {"w1": 0.0, "w2": 0.0}
    h = {"w1": [0.0] * (len(BOUNDS) + 2), "w2": [0.0] * (len(BOUNDS) + 2)}
    evictions, gen = 0.0, 0
    docs = []
    for i in range(n):
        app, sources = [], []
        for src in ("w1", "w2"):
            c[src] = (float(rng.integers(0, 3)) if (i == reset_at
                                                    and src == "w1")
                      else c[src] + float(rng.integers(0, 10)))
            k = int(rng.integers(0, 4))
            exemplars = {}
            for _ in range(k):
                lat = float(rng.exponential(0.2))
                b = int(np.searchsorted(BOUNDS, lat))
                h[src][b] += 1.0
                h[src][-1] += lat
                exemplars[b] = f"{seed:02d}{i:04d}{b}{src}"
            hist = {"name": "h_s", "kind": "histogram", "tag_keys": (),
                    "boundaries": BOUNDS, "hist": {(): list(h[src])}}
            if exemplars:
                hist["exemplars"] = {(): exemplars}
            app.append([
                {"name": "g", "kind": "gauge", "tag_keys": ("route",),
                 "values": {("/a",): float(rng.normal()),
                            ("/b",): float(rng.uniform(0, 5))}},
                {"name": "c_total", "kind": "counter", "tag_keys": (),
                 "values": {(): c[src]}},
                hist])
            sources.append(src)
        if i == restart_at:
            evictions, gen = float(rng.integers(0, 3)), gen + 1
        else:
            evictions += float(rng.integers(0, 5))
        runtime = {"node_id": NODE, "workers": float(rng.integers(1, 9)),
                   "store_evictions_total": evictions,
                   "store_incarnation": gen,
                   "resources": {"CPU": 4.0},
                   "available": {"CPU": float(rng.integers(0, 5))}}
        docs.append(({"runtime": runtime, "app": app,
                      "app_sources": sources}, float(i)))
    return docs


def _fill(mod, docs, **kw):
    db = mod.TSDB(**kw)
    for snap, ts in docs:
        db.ingest(snap, ts)
    return db


def _reads(db, now: float) -> dict:
    out = {"families": db.families(), "stats": db.stats()}
    for w in (3.0, 10.0, 30.0, 1e9):
        out[("overview", w)] = db.overview(w, now)
        for fam in ("g", "c_total", "h_s", "node_workers",
                    "node_store_evictions_total", "node_resource_available",
                    "absent"):
            out[("query", fam, w)] = db.query(fam, w, now)
            out[("rate", fam, w)] = db.rate(fam, w, now)
            out[("rate_by", fam, w)] = db.rate_by(fam, w, now)
        for q in (0.5, 0.9, 0.99):
            out[("quantile", q, w)] = db.quantile("h_s", q, w, now)
            out[("exemplar", q, w)] = db.exemplar("h_s", q, w, now)
        for fn in ("mean", "max", "min", "latest"):
            out[("gauge", fn, w)] = db.gauge_agg("g", w, fn, now)
            out[("gauge_rt", fn, w)] = db.gauge_agg("node_workers", w, fn,
                                                    now)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_reads_equal_jax(seed):
    docs = _stream(seed)
    for now in (20.0, 45.5, 59.0):
        want = _reads(_fill(jtsdb, docs[:int(now) + 1]), now)
        got = _reads(_fill(ttsdb, docs[:int(now) + 1]), now)
        assert got == want


@pytest.mark.parametrize("cap", [(4, 2048), (64, 5), (8, 9)])
def test_ring_and_lru_eviction_equal_jax(cap):
    """A short ring per series, and a series cap below the stream's series
    count (the least recently updated series go first)."""
    points, series = cap
    docs = _stream(3, n=40)
    want = _fill(jtsdb, docs, points_per_series=points, max_series=series)
    got = _fill(ttsdb, docs, points_per_series=points, max_series=series)
    assert got.stats() == want.stats()
    assert got.families() == want.families()
    for fam in ("g", "c_total", "h_s", "node_workers",
                "node_store_evictions_total"):
        assert got.query(fam, 1e9, 40.0) == want.query(fam, 1e9, 40.0)
    assert got.stats()["points"] <= got.stats()["cap_points"]


def test_counter_resets_and_generation_bumps_equal_jax():
    """A same-source drop is a reset (never a negative rate); a store
    counter's drop across an incarnation bump counts the fresh
    increments; a decrease within one incarnation adds nothing."""
    runs = [[(0, 100.0, 0), (1, 110.0, 0), (2, 3.0, 1), (3, 9.0, 1)],
            [(0, 50.0, 7), (1, 40.0, 7), (2, 45.0, 7)]]
    for run in runs:
        dbs = []
        for mod in (jtsdb, ttsdb):
            db = mod.TSDB()
            for ts, v, gen in run:
                db.ingest({"runtime": {"node_id": NODE,
                                       "store_evictions_total": v,
                                       "store_incarnation": gen}},
                          float(ts))
            dbs.append(db)
        want, got = dbs
        fam = "node_store_evictions_total"
        assert got.query(fam, 1e9, 9.0) == want.query(fam, 1e9, 9.0)
        assert got.rate(fam, 3.0, 3.0) == want.rate(fam, 3.0, 3.0)
    resets = [(0, 100.0), (1, 110.0), (2, 5.0), (3, 15.0)]
    dbs = []
    for mod in (jtsdb, ttsdb):
        db = mod.TSDB()
        for ts, v in resets:
            db.ingest({"runtime": {"node_id": NODE}, "app_sources": ["w"],
                       "app": [[{"name": "c_total", "kind": "counter",
                                 "tag_keys": (), "values": {(): v}}]]},
                      float(ts))
        dbs.append(db)
    assert dbs[1].query("c_total", 1e9, 10.0) == \
        dbs[0].query("c_total", 1e9, 10.0)
    vals = [p[1] for p in dbs[1].query("c_total", 1e9, 10.0)[0]["points"]]
    assert vals == sorted(vals) and dbs[1].rate("c_total", 4.0, 3.0) >= 0


RULES = [
    "err: rate(errs_total, 1m) / rate(reqs_total, 1m) < 0.01",
    "lat: p99.9(lat_s, 30s) < 2",
    "up: some_gauge > 0.5",
    "q: mean(g, 10s) < 1.0",
    "hi: max(node_workers, 2m) <= 8",
    "ttft: p90(h_s, 15s) < 0.0001",
    "goodput: mean(train_goodput_fraction, 5m) > 0.5",
    "not a rule at all",
    "bad: p50(x) <",
    "x: rate(c_total, 5q) < 1",
]


@pytest.mark.parametrize("text", RULES)
def test_rule_grammar_equal_jax(text):
    def parse(mod):
        try:
            r = mod.Rule(text)
        except mod.RuleError as e:
            return ("error", type(e).__name__)
        return (r.name, r.text, r.window_s, r.families(), r.op, r.threshold,
                r.num.func, r.num.family, r.num.window_s,
                None if r.den is None else (r.den.func, r.den.family,
                                            r.den.window_s),
                mod.SLOEngine.describe_expr(r))

    assert parse(tslo) == parse(jslo)


def test_rule_env_overlay_equal_jax(monkeypatch):
    monkeypatch.setenv(
        "RTPU_SLO_RULES",
        "llm_ttft_p90: p90(llm_ttft_s, 1m) < 9.9; broken rule;"
        "extra: mean(train_goodput_fraction, 1m) > 0.5\n"
        "lat: p99(lat_s, 30s) < 2")

    def rules(mod):
        return [(r.name, r.text, r.threshold, r.window_s)
                for r in mod.load_rules()]

    assert rules(tslo) == rules(jslo)
    assert len(rules(tslo)) == len(tslo.DEFAULT_RULES) + 2
    assert [r.text for r in tslo.parse_rules(
        "a: mean(g, 1m) < 1; b: rate(c_total, 5s) > 2")] == \
        [r.text for r in jslo.parse_rules(
            "a: mean(g, 1m) < 1; b: rate(c_total, 5s) > 2")]
    assert [r.text for r in map(tslo.Rule, tslo.DEFAULT_RULES)] == \
        [r.text for r in map(jslo.Rule, jslo.DEFAULT_RULES)]


def test_burn_math_equal_jax():
    values = [None, 0.0, 0.45, 1.0, 2.0, 4.0, 1e-9, -1.0]
    for text in ("r: mean(g, 1m) < 2.0", "r: mean(g, 1m) > 0.9",
                 "r: mean(g, 1m) <= 0.5", "r: mean(g, 1m) >= 3"):
        want = [jslo.Rule(text).burn(v) for v in values]
        assert [tslo.Rule(text).burn(v) for v in values] == want


@pytest.mark.parametrize("seed", [4, 5])
def test_engine_fire_and_clear_sequence_equal_jax(seed):
    """Both engines tick over the same growing TSDBs: the same
    transitions at the same ticks, and the same status after each."""
    docs = _stream(seed, n=80)
    # a breach stretch: the gauge's /a series jumps for 15 samples
    lo = int(np.random.default_rng(seed).integers(20, 40))
    for snap, ts in docs[lo:lo + 15]:
        for app in snap["app"]:
            app[0]["values"][("/a",)] += 10.0
    rules = ["q: mean(g, 10s) < 1.5", "ttft: p90(h_s, 15s) < 0.3",
             "r: rate(c_total, 10s) < 9", "w: mean(node_workers, 5s) < 7"]
    seqs = []
    for tmod, smod in ((jtsdb, jslo), (ttsdb, tslo)):
        db = tmod.TSDB()
        eng = smod.SLOEngine([smod.Rule(r) for r in rules], sample_s=1.0,
                             clear_ticks=3)
        seq = []
        for snap, ts in docs:
            db.ingest(snap, ts)
            seq.append((eng.tick(db, now=ts), eng.status(),
                        smod.status_metrics(eng.status())))
        seqs.append(seq)
    want, got = seqs
    assert got == want
    kinds = [t["kind"] for tr, _, _ in got for t in tr]
    assert "slo.fire" in kinds and "slo.clear" in kinds


def _spans(seed: int):
    rng = np.random.default_rng(seed)
    names = ["llm.queue", "llm.kv_pull", "llm.prefill", "llm.decode",
             "llm.request", "serve.route", "llm.resume"]
    out = []
    for i in range(int(rng.integers(5, 40))):
        t0 = float(rng.uniform(0, 100))
        span = {"name": names[int(rng.integers(len(names)))],
                "trace_id": (f"t{int(rng.integers(0, 6))}"
                             if rng.uniform() < 0.9 else None),
                "start_ts": t0, "end_ts": t0 + float(rng.exponential(0.1))}
        if rng.uniform() < 0.5:
            span["run_s"] = float(rng.exponential(0.05))
        out.append(span)
    return out


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_attribute_burn_equal_jax(seed):
    spans = _spans(seed)
    assert tslo.attribute_burn(spans) == jslo.attribute_burn(spans)
    assert tslo.attribute_burn([]) is None is jslo.attribute_burn([])


def test_status_metrics_equal_jax():
    status = []
    for tmod, smod in ((jtsdb, jslo), (ttsdb, tslo)):
        eng = smod.SLOEngine([smod.Rule("q: mean(g, 10s) < 1.0"),
                              smod.Rule("r: mean(g, 10s) > 2.0")],
                             sample_s=1.0)
        db = tmod.TSDB()
        db.ingest({"runtime": {"node_id": NODE}, "app_sources": ["w"],
                   "app": [[{"name": "g", "kind": "gauge", "tag_keys": (),
                             "values": {(): 5.0}}]]}, 0.0)
        eng.tick(db, now=0.0)
        eng.note_attribution("q", {"phases": {}, "verdict": "x",
                                   "exemplar_trace_ids": ["t"], "traces": 1})
        status.append((eng.status(), smod.status_metrics(eng.status())))
    assert status[1] == status[0]
    fams = {m["name"]: m for m in status[1][1]}
    assert set(fams) == {"slo_burn_rate", "slo_healthy"}


def test_global_plane_registry():
    plane, before = object(), ttsdb.global_plane()
    ttsdb.set_global_plane(plane)
    try:
        assert ttsdb.global_plane() is plane
        assert jtsdb.global_plane() is not plane  # one registry a package
    finally:
        ttsdb.set_global_plane(before)
