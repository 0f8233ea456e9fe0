"""The port's prefill/decode disaggregation against the JAX package's.

Same tiny f32 model on both sides (``convert.llama_params_from_jax``).
``prefill_extract`` gives the same first token and KV within 1e-5 (f32,
two implementations of the same forward); ``submit_with_kv`` streams the
same tokens as the JAX engine, from the port's own KV and from the JAX
engine's; ``PDRouter`` over an in-process handle answers with the same
text and usage as the JAX ``PDRouter``, on the host relay and on the KV
tier handoff, and links its spans into one tree the same way.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import engine as jengine
from ray_tpu.llm import kv_tier as jkt
from ray_tpu.llm import pd_disagg as jpd
from ray_tpu.llm import server as jserver
from ray_tpu.models import llama as jllama
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import kv_tier as tkt
from ray_tpu_torch.llm import pd_disagg as tpd
from ray_tpu_torch.llm import server as tserver
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util import tracing as ttracing

KV_TOL = 1e-5  # f32 KV from two implementations of the same forward


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


def _ecfg(mod):
    return mod.EngineConfig(max_slots=4, num_pages=64, page_size=8,
                            max_seq_len=256, prefill_buckets=(16, 32, 64, 128))


def _engine(pkg, model):
    jcfg, tcfg, params, state = model
    if pkg == "torch":
        return tengine.LLMEngine(state, tcfg, _ecfg(tengine), device="cpu")
    return jengine.LLMEngine(params, jcfg, _ecfg(jengine))


class _Handle:
    """In-process stand-in for a serve deployment handle: ``.options(
    routing_hint=...).<method>.remote(...).result(timeout_s=...)`` calls
    the target directly and keeps every (method, result)."""

    def __init__(self, target):
        self.target, self.calls, self.hints = target, [], []

    def options(self, routing_hint=None):
        self.hints.append(routing_hint)
        return self

    def __getattr__(self, method):
        fn, calls = getattr(self.target, method), self.calls

        def remote(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((method, out))
            return types.SimpleNamespace(result=lambda timeout_s=None: out)

        return types.SimpleNamespace(remote=remote)


def _drain(req):
    toks = []
    while True:
        item = req.out_queue.get(timeout=120)
        if item is None:
            return toks
        if isinstance(item, Exception):
            raise item
        toks.append(item)


PROMPT = [1, 17, 42, 99, 5, 23, 77, 8, 64, 3, 90, 12, 31, 55, 2, 70, 101,
          6, 44, 27]


def test_prefill_extract_matches_jax(model):
    outs = {}
    for pkg, mod in (("jax", jengine), ("torch", tengine)):
        e = _engine(pkg, model)
        try:
            outs[pkg] = e.prefill_extract(list(PROMPT),
                                          mod.SamplingParams(max_tokens=8))
        finally:
            e.stop()
    (jf, jk, jv, jn), (tf, tk, tv, tn) = outs["jax"], outs["torch"]
    assert tf == jf and tn == jn == len(PROMPT)
    assert isinstance(tk, torch.Tensor) and tk.device.type == "cpu"
    assert tuple(tk.shape) == jk.shape == (2, 3, 8, 2, 16)

    def real(kv):  # the prompt's positions; the last page's padded slots
        # hold what padded rows wrote, which decode overwrites unread
        return np.asarray(kv).reshape(2, 24, 2, 16)[:, :len(PROMPT)]

    np.testing.assert_allclose(real(tk), real(jk), rtol=0, atol=KV_TOL)
    np.testing.assert_allclose(real(tv), real(jv), rtol=0, atol=KV_TOL)


def test_submit_with_kv_stream_matches_jax(model):
    jsp = jengine.SamplingParams(max_tokens=12)
    tsp = tengine.SamplingParams(max_tokens=12)
    single = _engine("jax", model)
    engines = [single]
    try:
        expected = single.generate(list(PROMPT), jsp)
        jpre, jdec = _engine("jax", model), _engine("jax", model)
        tpre, tdec = _engine("torch", model), _engine("torch", model)
        engines += [jpre, jdec, tpre, tdec]
        jfirst, jk, jv, _ = jpre.prefill_extract(list(PROMPT), jsp)
        tfirst, tk, tv, _ = tpre.prefill_extract(list(PROMPT), tsp)
        want = [jfirst] + _drain(jdec.submit_with_kv(
            list(PROMPT), jfirst, jk, jv, jsp))
        got = [tfirst] + _drain(tdec.submit_with_kv(
            list(PROMPT), tfirst, tk, tv, tsp))
        # the port's decode engine also continues from the JAX engine's KV
        cross = [jfirst] + _drain(tdec.submit_with_kv(
            list(PROMPT), jfirst, jk, jv, tsp))
        st = tdec.stats()
    finally:
        for e in engines:
            e.stop()
    assert want == expected
    assert got == expected and cross == expected
    assert st["prefills"] == 0  # no prefill compute on the decode side
    assert st["tokens_generated"] == 2 * len(expected)


def _pd(pkg, model, tiered):
    """Two requests through PDRouter: a completion and a chat.  Returns
    the responses, the decode server's stats and the P/D span edges."""
    jcfg, tcfg, params, state = model
    if pkg == "torch":
        kt, pd, srv = tkt, tpd, tserver
        cfg = srv.LLMConfig(model_id="tiny-pd",
                            model_loader=lambda: (state, tcfg),
                            engine_config=_ecfg(tengine), device="cpu",
                            default_max_tokens=8)
    else:
        kt, pd, srv = jkt, jpd, jserver
        cfg = srv.LLMConfig(model_id="tiny-pd",
                            model_loader=lambda: (params, jcfg),
                            engine_config=_ecfg(jengine),
                            default_max_tokens=8)
    kt.set_default_tier(kt.KVTier(kt.InProcessStore(), kt.LocalDirectory())
                        if tiered else None)
    try:
        pre, dec = pd.PrefillServer(cfg), pd.DecodeServer(cfg)
    finally:
        kt.set_default_tier(None)
    router = pd.PDRouter(_Handle(pre), _Handle(dec), "tiny-pd", 8)
    try:
        out = [router.handle_http({"path": "/v1/models"}),
               router.handle_http({"path": "/v1/completions", "body": {
                   "prompt": "the quick brown fox jumps over",
                   "max_tokens": 6}}),
               router.handle_http({"path": "/v1/chat/completions", "body": {
                   "messages": [{"role": "user", "content": "hi there"}]}}),
               router.handle_http({"path": "/v1/embeddings"})]
    finally:
        pre._engine.stop()
        dec._engine.stop()
    return out, dec._engine.stats()


def _edges(recs):
    by_id = {r["span_id"]: r["name"] for r in recs}
    return {(r["name"], by_id.get(r.get("parent_id"))) for r in recs}


@pytest.mark.parametrize("tiered", [False, True], ids=["host", "tier"])
def test_pd_router_matches_jax(model, monkeypatch, tiered):
    # the JAX package's process default: explicitly installed, never
    # derived from a runtime worker
    monkeypatch.setattr(jkt, "_default_set", True)
    monkeypatch.setattr(jkt, "_default_tier", None)
    jrecs = []
    orig = jtracing._record
    monkeypatch.setattr(jtracing, "_record",
                        lambda rec: (jrecs.append(rec), orig(rec))[1])
    want, jstats = _pd("jax", model, tiered)
    ttracing.take_spans()
    got, tstats = _pd("torch", model, tiered)
    trecs = ttracing.take_spans()

    def strip(resp):
        return {k: v for k, v in resp.items() if k not in ("id", "created")}

    assert [strip(r) for r in got] == [strip(r) for r in want]
    assert got[1]["usage"]["completion_tokens"] == 6
    assert got[2]["usage"]["completion_tokens"] == 8
    assert tstats["tokens_generated"] == jstats["tokens_generated"]
    if tiered:
        # every decode pulls the spine its prefill sealed (the JAX engine
        # hands the result back before sealing, so its decode may miss)
        assert tstats["kv_pulls"] == 2 and tstats["kv_pull_fallbacks"] == 0
        assert tstats["prefills"] == 2
    else:
        assert tstats["prefills"] == 0 == jstats["prefills"]
    edges = _edges(trecs)
    assert edges == _edges(jrecs)
    assert {("pd.request", None), ("pd.prefill", "pd.request"),
            ("pd.decode", "pd.prefill"), ("llm.request", "pd.prefill"),
            ("llm.request", "pd.decode")} <= edges


def test_prefill_extract_seals_before_it_returns(model):
    """The P/D tier handoff: when ``prefill_extract`` returns, the spine
    is already sealed and published, so the decode engine's first lookup
    finds it."""
    tier = tkt.KVTier(tkt.InProcessStore(), tkt.LocalDirectory())
    jcfg, tcfg, params, state = model
    e = tengine.LLMEngine(state, tcfg, _ecfg(tengine), kv_tier=tier,
                          device="cpu")
    try:
        for i in range(5):
            prompt = [1 + i] + PROMPT[1:]
            e.prefill_extract(prompt, tengine.SamplingParams(max_tokens=4))
            root = e.prefix_cache.root_digest_for(prompt, 8)
            assert tier.lookup(root) is not None, i
    finally:
        e.stop()
    assert e.stats()["kv_seals"] == 5
