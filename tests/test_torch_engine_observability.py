"""The port engine's metrics, spans and events against the JAX engine's.

The same scenarios run on both engines over the same tiny f32 model, each
request submitted under a serving root span.  Every counter family of the
engine must move by the same amount (per tag), every histogram family must
gain the same number of observations, and the traced requests must give
the same set of (span name, parent span name) edges.  The pressure
scenario (a 15-page pool for four 52-token sequences) must emit an
``llm.preempt`` event per preemption and ``llm.resume`` per resumed
prefill, as the JAX engine does.  Admission there is plain FIFO
(``RTPU_ADMIT_AGE_CAP_S=0``), so both engines schedule alike.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import engine as jengine
from ray_tpu.llm import kv_tier as jkt
from ray_tpu.models import llama as jllama
from ray_tpu.util import events as jevents
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import kv_tier as tkt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing

PACKAGES = {"jax": (jengine, jkt, jtracing, jmetrics),
            "torch": (tengine, tkt, ttracing, tmetrics)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU models: one intra-op thread each, so the test workers do
    not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, dtype="float32", remat=False)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = jllama.init(jcfg, jax.random.PRNGKey(0))
    state = convert.llama_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, state


def _engine(pkg, model, num_pages, tier=None):
    jcfg, tcfg, params, state = model
    mod = PACKAGES[pkg][0]
    ecfg = mod.EngineConfig(max_slots=4, num_pages=num_pages, page_size=8,
                            max_seq_len=256, prefill_buckets=(16, 32, 64))
    if pkg == "torch":
        return tengine.LLMEngine(state, tcfg, ecfg, kv_tier=tier,
                                 device="cpu")
    return jengine.LLMEngine(params, jcfg, ecfg, kv_tier=tier)


def _drain(req):
    toks = []
    while True:
        item = req.out_queue.get(timeout=120)
        if item is None:
            return toks
        if isinstance(item, Exception):
            raise item
        toks.append(item)


def _tiered(pkg, model):
    """Prefix hit, COW, a sampled request and a seal on engine 1; a tier
    pull, a P/D prefill + injected decode on engine 2; a torn blob's
    fallback on engine 3."""
    mod, kt, tracing, _ = PACKAGES[pkg]
    rng = np.random.default_rng(0)
    a = [int(t) for t in rng.integers(1, 128, 30)]
    b = a[:20] + [int(t) for t in rng.integers(1, 128, 9)]
    c = [int(t) for t in rng.integers(1, 128, 21)]
    d = [int(t) for t in rng.integers(1, 128, 26)]
    sp = mod.SamplingParams(max_tokens=10)
    store, directory = kt.InProcessStore(), kt.LocalDirectory()

    def tier():
        return kt.KVTier(store, directory, seal_min_hits=1)

    out = []
    e1 = _engine(pkg, model, 64, tier())
    try:
        with tracing.serving_span("client"):
            out += [e1.generate(a, sp), e1.generate(b, sp),
                    e1.generate(c, mod.SamplingParams(
                        max_tokens=10, temperature=0.8, seed=3)),
                    e1.generate(a, sp)]
    finally:
        e1.stop()
    e2 = _engine(pkg, model, 64, tier())
    try:
        with tracing.serving_span("client"):
            out.append(e2.generate(a, sp))
            first, kv_k, kv_v, _ = e2.prefill_extract(d, sp)
            out.append([first] + _drain(e2.submit_with_kv(
                d, first, kv_k, kv_v, sp)))
    finally:
        e2.stop()
    with store._lock:  # tear every sealed blob in half
        for oid in list(store._objs):
            store._objs[oid] = store._objs[oid][:len(store._objs[oid]) // 2]
    e3 = _engine(pkg, model, 64, tier())
    try:
        with tracing.serving_span("client"):
            out.append(e3.generate(a, sp))
    finally:
        e3.stop()
    return out


def _pressure(pkg, model):
    """Four requests that together need 28 pages of a 15-page pool."""
    mod, _, tracing, _ = PACKAGES[pkg]
    engine = _engine(pkg, model, 16)
    rng = np.random.default_rng(1)
    with tracing.serving_span("client"):
        reqs = [engine.submit([int(t) for t in rng.integers(1, 128, 12)],
                              mod.SamplingParams(max_tokens=40))
                for _ in range(4)]
    engine.start()
    try:
        return [_drain(r) for r in reqs]
    finally:
        engine.stop()


def _families(pkg):
    return {m._name: (m._kind, m._tag_keys)
            for m in PACKAGES[pkg][0]._engine_metrics().values()}


def _readings(pkg):
    """{family: {tag tuple: count}} of the engine's counters (their
    values) and histograms (their observation counts)."""
    fams = _families(pkg)
    out = {}
    for snap in PACKAGES[pkg][3].snapshot():
        kind = fams.get(snap["name"], (None,))[0]
        if kind == "counter":
            out[snap["name"]] = dict(snap["values"])
        elif kind == "histogram":
            out[snap["name"]] = {k: sum(v[:-1])
                                 for k, v in snap["hist"].items()}
    return out


def _delta(before, after):
    return {name: {k: v - before.get(name, {}).get(k, 0)
                   for k, v in series.items()
                   if v != before.get(name, {}).get(k, 0)}
            for name, series in after.items()}


def _edges(recs):
    by_id = {r["span_id"]: r["name"] for r in recs}
    return {(r["name"], by_id.get(r.get("parent_id"))) for r in recs}


def test_engines_register_the_same_families():
    assert _families("torch") == _families("jax")
    assert len(_families("torch")) == 25


@pytest.mark.parametrize("scenario", [_tiered, _pressure])
def test_metrics_spans_events_match_jax(model, monkeypatch, scenario):
    monkeypatch.setenv("RTPU_ADMIT_AGE_CAP_S", "0")
    recs, jev = [], []
    orig = jtracing._record
    monkeypatch.setattr(jtracing, "_record",
                        lambda rec: (recs.append(rec), orig(rec))[1])
    monkeypatch.setattr(jevents, "emit",
                        lambda kind, **kw: jev.append(dict(kw, kind=kind)))
    jengine._engine_metrics()
    tengine._engine_metrics()
    runs = {}
    for pkg in ("jax", "torch"):
        if pkg == "torch":
            ttracing.take_spans()
            tevents.take_buffered()
        before = _readings(pkg)
        out = scenario(pkg, model)  # stops (joins) its engines
        runs[pkg] = (out, _delta(before, _readings(pkg)))
    trecs, tev = ttracing.take_spans(), tevents.take_buffered()

    assert runs["torch"][0] == runs["jax"][0]  # token streams exact
    got, want = runs["torch"][1], runs["jax"][1]
    assert got == want
    assert _edges(trecs) == _edges(recs)
    edges = _edges(trecs)
    assert {("client", None), ("llm.request", "client"),
            ("llm.queue", "llm.request"), ("llm.prefill", "llm.request"),
            ("llm.decode", "llm.request")} <= edges
    kinds = sorted(e["kind"] for e in tev)
    assert kinds == sorted(e["kind"] for e in jev)
    # every event carries its request's identity and trace
    assert all(e["trace_id"] and e["data"]["request_id"] for e in tev)
    n_pre = sum(want.get(n, {}).get((), 0) for n, (kind, _)
                in _families("torch").items()
                if n.endswith("preempted_total"))
    if scenario is _pressure:
        assert n_pre > 0 and ("llm.preempt", "llm.request") in edges
        assert kinds.count("llm.preempt") == n_pre
        assert kinds.count("llm.resume") == n_pre
    else:
        assert ("llm.kv_pull", "llm.request") in edges
        assert {"kv.pull", "kv.pull_fallback"} <= set(kinds)
        fall = [e for e in tev if e["kind"] == "kv.pull_fallback"]
        assert fall[0]["data"]["reason"] == "truncated"
        assert fall[0]["severity"] == "warning"


# ------------------------------------------- the util modules themselves


def test_metric_tags_and_exemplars_match_jax():
    snaps = []
    for metrics, tracing in ((jmetrics, jtracing), (tmetrics, ttracing)):
        c = metrics.Counter("t_port_parity_total", "test", tag_keys=("k",))
        c.set_default_tags({"k": "a"})
        c.inc()
        c.inc(2.5, tags={"k": "b"})
        with pytest.raises(ValueError):
            c.inc(tags={"other": "x"})
        with pytest.raises(ValueError):
            c.inc(-1)
        h = metrics.Histogram("t_port_parity_s", "test",
                              boundaries=(0.01, 0.1))
        with tracing.use_context(("trace-x", None)):
            h.observe(0.05)  # ambient exemplar pickup
        h.observe(5.0, exemplar="trace-y")
        snaps.append([s for s in metrics.snapshot()
                      if s["name"].startswith("t_port_parity")][-2:])
    assert snaps[1] == snaps[0]
    assert snaps[1][1]["exemplars"] == {(): {1: "trace-x", 2: "trace-y"}}


def test_events_coalesce_and_ring_cap():
    tevents.take_buffered()
    first = tevents.emit("t.hot", message="m", coalesce_s=60.0)
    again = tevents.emit("t.hot", message="m", coalesce_s=60.0)
    assert again is first and first["data"]["count"] == 2
    with ttracing.use_context(("trace-z", "span")):
        rec = tevents.emit("t.traced", data={"a": 1})
    assert rec["trace_id"] == "trace-z"
    for i in range(600):
        tevents.emit("t.flood", data={"i": i})
    got = tevents.take_buffered()
    assert len(got) == 512 and got[-1]["data"]["i"] == 599
    assert all("_buffered" not in r for r in got)
    assert tevents.take_buffered() == []


def test_serving_span_sampling_and_trace_assembly(monkeypatch):
    monkeypatch.setenv("RTPU_TRACE_SAMPLE", "0")
    with ttracing.serving_span("openai.request") as span:
        assert span is None and ttracing.current_context() is None
    monkeypatch.setenv("RTPU_TRACE_SAMPLE", "1.0")
    ttracing.take_spans()
    with ttracing.serving_span("root", path="/x") as root:
        with ttracing.trace_span("child") as child:
            assert child.trace_id == root.trace_id
            ttracing.record_span(root.trace_id, "engine.phase", 1.0, 2.0,
                                 parent_id=child.span_id)
    assert ttracing.current_context() is None
    spans = ttracing.take_spans()
    assert [s["name"] for s in spans] == ["engine.phase", "child", "root"]
    assert ttracing.take_spans() == []
    # the pure assembly and chrome export agree with the JAX package's
    for s in spans:
        s["node"] = "n1" if s["name"] != "engine.phase" else "n2"
    want = jtracing.assemble_trace(root.trace_id, spans)
    got = ttracing.assemble_trace(root.trace_id, spans)
    assert got == want and len(got["tree"]) == 1
    assert ttracing.trace_to_chrome_events(spans) == \
        jtracing.trace_to_chrome_events(spans)
