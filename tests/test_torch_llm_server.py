"""The port's OpenAI server against the JAX package's.

One ``LLMServer`` per package over the same tiny f32 model; both get the
same bodies in the same order, so their prefix caches stay in step.
Responses must be equal but for their ids and timestamps, SSE chunk
sequences too; ``OpenAIRouter`` routes the same paths with the same hints.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import engine as jengine
from ray_tpu.llm import kv_tier as jkt
from ray_tpu.llm import server as jserver
from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import server as tserver
from ray_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU models: one intra-op thread each, so the test workers do
    not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def servers():
    jcfg = jllama.LlamaConfig(
        vocab_size=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, dtype="float32", remat=False)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = jllama.init(jcfg, jax.random.PRNGKey(1))
    state = convert.llama_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")

    def ecfg(mod):
        return mod.EngineConfig(max_slots=4, num_pages=64, page_size=8,
                                max_seq_len=256,
                                prefill_buckets=(16, 32, 64, 128))

    with pytest.MonkeyPatch.context() as mp:
        # no store tier on the JAX side either (it would otherwise derive
        # one from a runtime worker left up by another test)
        mp.setattr(jkt, "_default_set", True)
        mp.setattr(jkt, "_default_tier", None)
        js = jserver.LLMServer(jserver.LLMConfig(
            model_id="tiny", model_loader=lambda: (params, jcfg),
            engine_config=ecfg(jengine), default_max_tokens=8))
        ts = tserver.LLMServer(tserver.LLMConfig(
            model_id="tiny", model_loader=lambda: (state, tcfg),
            engine_config=ecfg(tengine), default_max_tokens=8,
            device="cpu"))
        yield js, ts
        js._engine.stop()
        ts.shutdown()


class _Handle:
    """In-process stand-in for a serve deployment handle."""

    def __init__(self, target):
        self.target, self.hints = target, []

    def options(self, routing_hint=None):
        self.hints.append(routing_hint)
        return self

    def __getattr__(self, method):
        fn = getattr(self.target, method)

        def remote(*args, **kwargs):
            out = fn(*args, **kwargs)
            return types.SimpleNamespace(result=lambda timeout_s=None: out)

        return types.SimpleNamespace(remote=remote)


def _strip(resp):
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _sse(chunks):
    """Parsed SSE events, ids and timestamps dropped; "[DONE]" last."""
    out = []
    for chunk in chunks:
        assert chunk.startswith("data: ") and chunk.endswith("\n\n"), chunk
        data = chunk[len("data: "):-2]
        out.append(data if data == "[DONE]" else _strip(json.loads(data)))
    assert out[-1] == "[DONE]" and "[DONE]" not in out[:-1]
    return out


BODIES = [
    ("completions", {"prompt": "hello there, general", "max_tokens": 6}),
    ("completions", {"prompt": [1, 40, 41, 42, 43], "max_tokens": 5}),
    ("completions", {"prompt": "hello there, general kenobi"}),
    ("completions", {"prompt": "sampled", "max_tokens": 6,
                     "temperature": 0.9, "top_p": 0.8, "seed": 3}),
    ("chat", {"messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "hi"}],
              "max_tokens": 7}),
    ("chat", {"messages": [{"role": "user", "content": "again"}],
              "ignore_eos": True, "stop_token_ids": [5]}),
]


def test_completions_and_chat_match_jax(servers):
    js, ts = servers
    for method, body in BODIES:
        want = getattr(js, method)(dict(body))
        got = getattr(ts, method)(dict(body))
        assert _strip(got) == _strip(want), (method, body)
        assert got["id"].startswith("chatcmpl-" if method == "chat"
                                    else "cmpl-")
    assert ts.engine_stats()["prefix_cache"]["hit_tokens"] == \
        js.engine_stats()["prefix_cache"]["hit_tokens"]


@pytest.mark.parametrize("method", ["completions", "chat"])
def test_sse_chunks_match_jax(servers, method):
    js, ts = servers
    body = (BODIES[0][1] if method == "completions" else BODIES[4][1])
    want = js.__getattribute__(f"{method}_stream")(dict(body))
    got = ts.__getattribute__(f"{method}_stream")(dict(body))
    assert got.content_type == want.content_type == "text/event-stream"
    assert got.status == 200
    events = _sse(got.chunks)
    assert events == _sse(want.chunks)
    # streamed and whole responses agree on the count and the reason
    whole = getattr(ts, method)(dict(body))
    key = "delta" if method == "chat" else "text"
    content = [e for e in events[:-2]
               if e["choices"][0].get(key) not in ({"role": "assistant"},)]
    assert len(content) == whole["usage"]["completion_tokens"] == \
        body["max_tokens"]
    assert events[-2]["choices"][0]["finish_reason"] == "length" == \
        whole["choices"][0]["finish_reason"]


def test_sse_frames_submit_errors_like_jax(servers):
    js, ts = servers
    body = {"prompt": "x", "max_tokens": 400}  # past max_seq_len 256
    want = _sse(js.completions_stream(dict(body)).chunks)
    got = _sse(ts.completions_stream(dict(body)).chunks)
    assert got == want and "error" in got[0]


def test_router_paths_and_hints_match_jax(servers):
    js, ts = servers
    jh, th = _Handle(js), _Handle(ts)
    jr = jserver.OpenAIRouter(jh, "tiny")
    tr = tserver.OpenAIRouter(th, "tiny")
    for path, body in [("/v1/models", None), ("/models", None),
                       ("/v1/embeddings", {}),
                       ("/v1/completions", BODIES[0][1]),
                       ("/v1/chat/completions", BODIES[4][1])]:
        req = {"path": path, "body": body}
        want, got = jr.handle_http(dict(req)), tr.handle_http(dict(req))
        assert _strip(got) == _strip(want), path
    stream = tr.handle_http({"path": "/v1/completions",
                             "body": dict(BODIES[1][1], stream=True)})
    assert isinstance(stream, tserver.StreamingResponse)
    assert _sse(stream.chunks)[-2]["choices"][0]["finish_reason"] == "length"
    assert th.hints == jh.hints + [",".join(
        str(t) for t in BODIES[1][1]["prompt"])]
    for body, chat in [(BODIES[0][1], False), (BODIES[1][1], False),
                       (BODIES[4][1], True), ({"prompt": ""}, False),
                       ({"messages": []}, True),
                       ({"prompt": "y" * 600}, False)]:
        assert tserver.OpenAIRouter._hint(body, chat) == \
            jserver.OpenAIRouter._hint(body, chat)


def test_generate_tokens_and_health(servers):
    js, ts = servers
    prompt = [1, 9, 8, 7, 6, 5, 4, 3]
    assert ts.generate_tokens(prompt, max_tokens=6) == \
        js.generate_tokens(prompt, max_tokens=6)
    ts.check_health()
    assert ts.kv_prehydrate(["ab" * 8]) == 1  # no tier: a no-op
    assert ts.engine_stats()["kv_tier"] is None
