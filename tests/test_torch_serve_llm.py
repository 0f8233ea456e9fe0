"""The port's LLM serve applications on its runtime, held to the JAX
package's.

``build_openai_app`` runs in both packages with ``tests/test_llm_serving.py``'s
tiny Llama (f32, 2 layers, d 64); the port's replicas get the same numpy
parameters through ``convert.py`` and ``device="cpu"``.  Through each
package's HTTP proxy, ``/v1/models``, ``/v1/completions``, chat and SSE give
the same responses (ids and timestamps aside), and the servers' greedy ids
are equal exactly, at one replica and at two.  Beside the parity: the P/D
application's ids against a single engine's with the handoff through the
store tier between two replica processes; ``WorkerStoreBackend`` and
``GcsDirectory`` carrying a spine from one replica process to another; a
replica killed under traffic; ``default_tier()``; and the warm restart of a
replacement replica.  Every ``get`` and ``result`` carries a timeout.
"""

import dataclasses
import json
import os
import sys
import time

import cloudpickle
import numpy as np
import pytest
import requests
import torch

import jax

# Loaders and the functions run inside replicas ship to processes that
# cannot import this module: pickle them by value.
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """``tests/test_llm_serving.py``'s tiny Llama, in both packages."""
    from ray_tpu.models import llama as jllama

    jcfg = jllama.LlamaConfig(
        vocab_size=259, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=512, dtype="float32", remat=False)
    params = jllama.init(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, dataclasses.asdict(jcfg), tree


def _torch_loader(tree, cfg_kwargs):
    """A loader of the port's model from the JAX package's numpy
    parameters, run in the replica's process."""

    def loader():
        import torch

        from ray_tpu_torch import convert
        from ray_tpu_torch.models import llama

        torch.set_num_threads(1)
        return (convert.params_from_jax(tree, device="cpu"),
                llama.LlamaConfig(**cfg_kwargs))

    return loader


def _jax_loader(params, cfg):
    def loader():
        return params, cfg

    return loader


def _engine_kwargs():
    return dict(max_slots=4, num_pages=128, page_size=8, max_seq_len=256,
                prefill_buckets=(32, 64, 128))


# The parity apps run without the store tier in both packages: the JAX
# session cluster's tier outlives this module, and its directory, keyed by
# token digests alone, would warm a fresh replica with other tests' spines
# of other models of the same page geometry (ROADMAP.md §3).
NO_TIER = {"runtime_env": {"env_vars": {"RTPU_KV_TIER": "0"}}}


def _llm_config(pkg, model, **kw):
    jcfg, params, cfg_kwargs, tree = model
    if pkg == "jax":
        from ray_tpu.llm import EngineConfig, LLMConfig

        return LLMConfig(model_id="tiny",
                         model_loader=_jax_loader(params, jcfg),
                         engine_config=EngineConfig(**_engine_kwargs()),
                         default_max_tokens=8, **kw)
    from ray_tpu_torch.llm import EngineConfig, LLMConfig

    return LLMConfig(model_id="tiny",
                     model_loader=_torch_loader(tree, cfg_kwargs),
                     engine_config=EngineConfig(**_engine_kwargs()),
                     default_max_tokens=8, device="cpu", **kw)


@pytest.fixture(scope="module")
def port(ray_cluster):
    import ray_tpu.serve
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 28,
            resources={"CPU": 8.0})
    yield rt
    try:
        rt.serve.shutdown()
    finally:
        rt.shutdown()
        ray_tpu.serve.shutdown()


def _packages():
    import ray_tpu
    import ray_tpu.llm
    import ray_tpu.serve
    import ray_tpu_torch
    import ray_tpu_torch.llm
    import ray_tpu_torch.serve

    return {"jax": (ray_tpu, ray_tpu.serve, ray_tpu.llm),
            "torch": (ray_tpu_torch, ray_tpu_torch.serve, ray_tpu_torch.llm)}


def _strip(resp):
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _sse(resp):
    """Parsed SSE events, ids and timestamps dropped; "[DONE]" last."""
    assert "text/event-stream" in resp.headers.get("Content-Type", "")
    out = []
    for line in resp.iter_lines():
        if not line:
            continue
        line = line.decode()
        assert line.startswith("data: "), line
        data = line[len("data: "):]
        out.append(data if data == "[DONE]" else _strip(json.loads(data)))
    assert out[-1] == "[DONE]" and "[DONE]" not in out[:-1]
    return out


BODIES = [
    ("completions", {"prompt": "hello", "max_tokens": 6}),
    ("completions", {"prompt": [1, 40, 41, 42, 43], "max_tokens": 5}),
    ("chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                          "max_tokens": 4}),
    ("completions", {"prompt": "stream me", "max_tokens": 6,
                     "stream": True}),
    ("chat/completions", {"messages": [{"role": "system",
                                        "content": "be brief"},
                                       {"role": "user", "content": "yo"}],
                          "max_tokens": 5, "stream": True}),
]
ID_PROMPTS = [([1, 40, 41, 42, 43, 44, 45], 8), ([1] + list(range(60, 100)),
                                                 6)]


def _through_proxy(pkg, model, replicas):
    rt, serve, llm = _packages()[pkg]
    app = llm.build_openai_app(_llm_config(pkg, model,
                                           num_replicas=replicas,
                                           ray_actor_options=NO_TIER))
    serve.run(app, name="llm", route_prefix="/llm", _blocking_timeout_s=240)
    try:
        base = f"http://127.0.0.1:{serve.http_port()}/llm/v1"
        out = [requests.get(f"{base}/models", timeout=60).json()]
        for path, body in BODIES:
            with requests.post(f"{base}/{path}", json=body, timeout=300,
                               stream=bool(body.get("stream"))) as r:
                out.append(_sse(r) if body.get("stream")
                           else _strip(r.json()))
        # the greedy ids themselves: the byte tokenizer's text can map two
        # ids to one replacement character, so read the ids through the
        # LLMServer deployment's raw token API
        server = serve.DeploymentHandle("llm", "LLMServer:tiny")
        ids = [server.generate_tokens.remote(prompt, max_tokens=n).result(
            timeout_s=TIMEOUT) for prompt, n in ID_PROMPTS]
        controller = rt.get_actor("SERVE_CONTROLLER")
        running = rt.get(controller.get_app_status.remote("llm"),
                         timeout=TIMEOUT)["deployments"]
    finally:
        serve.delete("llm")
    return out, ids, {d: s["running"] for d, s in running.items()}


@pytest.mark.parametrize("replicas", [1, 2])
def test_openai_app_through_the_proxy_matches_jax(replicas, model, port):
    want = _through_proxy("jax", model, replicas)
    got = _through_proxy("torch", model, replicas)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] == {"LLMServer:tiny": replicas,
                                 "OpenAIRouter": 1}
    assert want[0][0]["data"][0]["id"] == "tiny"
    assert all(len(i) == n for i, (_, n) in zip(got[1], ID_PROMPTS))


# ---------------------------------------------------------------------------
# the port's store tier across replica processes


def _replicas(rt, app, deployment):
    controller = rt.get_actor("SERVE_CONTROLLER")
    return rt.get(controller.get_replicas.remote(app, deployment),
                  timeout=TIMEOUT)["replicas"]


def _apply(rt, replica, fn, *args):
    """Run ``fn(user_instance, *args)`` inside a replica's process."""
    return rt.get(replica.__rtpu_apply__.remote(
        lambda inst, *a: fn(inst._user, *a), *args), timeout=TIMEOUT)


def _until(fn, within=60.0):
    deadline = time.monotonic() + within
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.05)


def _seal(server, prompt):
    """Serve ``prompt`` until its family is sealed into the store tier;
    the family's root digest and the process id."""
    engine = server._engine
    seals = engine.stats()["kv_seals"]
    # each repeat hits the family once more, until it passes the seal gate
    # (RTPU_KV_SEAL_MIN_HITS hits); the scheduler seals after the stream
    _until(lambda: server.generate_tokens(list(prompt), max_tokens=4)
           and engine.stats()["kv_seals"] > seals)
    root = engine.prefix_cache.root_digest_for(prompt, engine.cfg.page_size)
    return root, os.getpid()


def _spine(server, root):
    """A family spine's tokens in this process."""
    return server._engine.prefix_cache.spine(bytes.fromhex(root))[0]


def _pages_of(server, tokens):
    """The KV of ``tokens``' resident full pages in this process, as
    numpy (the engine is idle: its scheduler thread owns the cache)."""
    engine = server._engine
    pages = engine.prefix_cache.match(list(tokens) + [0])
    k, v = engine._extract_pages(pages)
    return [np.asarray(k.float()), np.asarray(v.float())], len(pages)


def _tier_of(server):
    from ray_tpu_torch.llm import kv_tier

    tier = server._tier
    return (type(tier.store).__name__, type(tier.directory).__name__,
            tier is kv_tier.default_tier())


def _pull(server, root, tokens):
    server.kv_prehydrate([root])
    engine = server._engine
    ps = engine.cfg.page_size
    _until(lambda: len(engine.prefix_cache.match(list(tokens) + [0]))
           == len(tokens) // ps)
    return engine.stats()["kv_pulls"], os.getpid()


def _prompt(seed, n=60):
    return [1] + [int(t) for t in np.random.RandomState(seed).randint(
        3, 259, n - 1)]


def _start(port, model, app, replicas, builder="build_openai_app"):
    from ray_tpu_torch import llm, serve

    serve.run(getattr(llm, builder)(_llm_config(
        "torch", model, num_replicas=replicas)), name=app,
        route_prefix=f"/{app}", _blocking_timeout_s=240)


def test_a_spine_sealed_in_one_replica_is_pulled_in_another(model, port):
    from ray_tpu_torch import serve

    _start(port, model, "tier", 2)
    try:
        a, b = _replicas(port, "tier", "LLMServer:tiny")
        assert _apply(port, a, _tier_of) == _apply(port, b, _tier_of) == (
            "WorkerStoreBackend", "GcsDirectory", True)
        root, pid_a = _apply(port, a, _seal, _prompt(0))
        tokens = _apply(port, a, _spine, root)
        assert len(tokens) == 7 * 8  # the 60-token prompt's full pages
        pulls, pid_b = _apply(port, b, _pull, root, tokens)
        assert pid_a != pid_b and pulls >= 1
        (ka, va), n_a = _apply(port, a, _pages_of, tokens)
        (kb, vb), n_b = _apply(port, b, _pages_of, tokens)
        assert n_a == n_b == 7
        np.testing.assert_array_equal(kb, ka)
        np.testing.assert_array_equal(vb, va)
    finally:
        serve.delete("tier")


def _default_tiers(server):
    from ray_tpu_torch.llm import kv_tier

    os.environ["RTPU_KV_TIER"] = "0"
    try:
        off = kv_tier.default_tier()
    finally:
        del os.environ["RTPU_KV_TIER"]
    on = kv_tier.default_tier()
    return off is None, type(on).__name__, type(on.store).__name__


def test_default_tier_is_the_store_tier_only_inside_the_runtime(
        model, port, monkeypatch):
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.llm import kv_tier

    monkeypatch.setattr(kv_tier, "_default_set", False)
    monkeypatch.setattr(worker, "global_worker_or_none", lambda: None)
    assert kv_tier.default_tier() is None  # outside the runtime
    monkeypatch.undo()
    _start(port, model, "dflt", 1)
    try:
        (rep,) = _replicas(port, "dflt", "LLMServer:tiny")
        assert _apply(port, rep, _default_tiers) == (
            True, "KVTier", "WorkerStoreBackend")
    finally:
        serve.delete("dflt")


def _completion(handle, prompt, max_tokens=4):
    out = handle.handle_http.remote({"path": "/v1/completions", "body": {
        "prompt": prompt, "max_tokens": max_tokens, "ignore_eos": True}})
    return out.result(timeout_s=TIMEOUT)["choices"][0]["text"]


def _stats(server):
    return server.engine_stats()


def test_killed_replica_under_traffic_survivor_pulls(model, port):
    """``tests/test_kv_tier.py``'s kill-and-recover scenario over real
    replicas: two replicas behind the prefix-aware router warm four
    families; the one that sealed more dies; every later request completes
    with the same text, and the survivor serves from the store tier."""
    from ray_tpu_torch import serve

    _start(port, model, "kill", 2)
    try:
        handle = serve.get_app_handle("kill")
        families = [_prompt(10 + f, 40) for f in range(4)]
        baseline = {i: _completion(handle, fam)
                    for i, fam in enumerate(families)}
        for i in range(16):  # warm: homes form, families heat and seal
            assert _completion(handle, families[i % 4]) == baseline[i % 4]
        reps = _replicas(port, "kill", "LLMServer:tiny")
        seals = [_apply(port, r, _stats)["kv_seals"] for r in reps]
        assert sum(seals) >= 1, "no family sealed during the warm phase"
        victim = reps[int(np.argmax(seals))]
        survivor = next(r for r in reps if r is not victim)
        port.kill(victim)
        for i in range(16):  # failed-over burst
            assert _completion(handle, families[i % 4]) == baseline[i % 4]
        st = _apply(port, survivor, _stats)
        assert st["kv_pulls"] >= 1, "the survivor never pulled"
        assert st["kv_pull_fallbacks"] == 0
    finally:
        serve.delete("kill")


def _pulls_after_start(server, pid):
    engine = server._engine
    _until(lambda: engine.stats()["kv_pulls"] >= 1)
    return os.getpid() != pid, engine.stats()["kv_pulls"]


def test_a_replacement_replica_prehydrates_the_hottest_families(model,
                                                                port):
    from ray_tpu_torch import serve

    _start(port, model, "warm", 1)
    try:
        (first,) = _replicas(port, "warm", "LLMServer:tiny")
        roots = [_apply(port, first, _seal, _prompt(20 + i))[0]
                 for i in range(2)]
        pid = _apply(port, first, lambda s: os.getpid())
        assert set(roots) <= set(_apply(
            port, first, lambda s: s._tier.hottest(8)))
        port.kill(first)
        new = _until(lambda: [r for r in _replicas(port, "warm",
                                                   "LLMServer:tiny")
                              if r.actor_id != first.actor_id])[0]
        fresh, pulls = _apply(port, new, _pulls_after_start, pid)
        assert fresh and pulls >= 1
    finally:
        serve.delete("warm")


# ---------------------------------------------------------------------------
# prefill / decode across two replica processes


PD_PROMPTS = ["hello world, a prompt long enough for several pages",
              "another prompt that spans more than one page of eight"]


def test_pd_app_ids_equal_a_single_engine_through_the_store_tier(
        model, port):
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    _, _, cfg_kwargs, tree = model
    state, cfg = _torch_loader(tree, cfg_kwargs)()
    single = LLMEngine(state, cfg, EngineConfig(**_engine_kwargs()),
                       device="cpu")
    tok = ByteTokenizer()
    want = [single.generate(tok.encode(p), SamplingParams(
        max_tokens=6, stop_token_ids=(tok.eos_id,))) for p in PD_PROMPTS]
    single.stop()

    _start(port, model, "pd", 1, "build_pd_openai_app")
    try:
        prefill = serve.DeploymentHandle("pd", "Prefill:tiny")
        decode = serve.DeploymentHandle("pd", "Decode:tiny")
        got, handoffs = [], []
        for p in PD_PROMPTS:
            pre = prefill.prefill.remote(p, {"max_tokens": 6}).result(
                timeout_s=TIMEOUT)
            handoffs.append((pre.get("kv_in_tier"), "kv_k" in pre))
            got.append(decode.decode.remote(pre, {"max_tokens": 6}).result(
                timeout_s=TIMEOUT)["tokens"])
        ingress = serve.get_app_handle("pd")
        text = ingress.handle_http.remote({
            "path": "/v1/completions",
            "body": {"prompt": PD_PROMPTS[0], "max_tokens": 6}}).result(
                timeout_s=TIMEOUT)["choices"][0]["text"]
        (p_rep,) = _replicas(port, "pd", "Prefill:tiny")
        (d_rep,) = _replicas(port, "pd", "Decode:tiny")
        pids = {_apply(port, r, lambda s: os.getpid())
                for r in (p_rep, d_rep)}
        d_stats = _apply(port, d_rep, _stats)
    finally:
        serve.delete("pd")
    assert got == want
    assert text == tok.decode(want[0])
    assert handoffs == [(True, False)] * len(PD_PROMPTS)
    assert len(pids) == 2
    assert d_stats["kv_pulls"] >= len(PD_PROMPTS)
    assert d_stats["kv_pull_fallbacks"] == 0
