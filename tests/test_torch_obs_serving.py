"""The observability plane's traced serving request on the port, held to
the JAX package's (``ray_tpu/scripts/obs_smoke.py``'s traced-serving
section).

JAX's obs_smoke tiny Llama (vocab 128, d 64, 2 layers, f32, weights from
``PRNGKey(0)``) is carried into the port by ``convert.params_from_jax`` and
served by ``obs_smoke.Gen``: a KV-tiered engine in a replica process of
this module's port cluster (``device="cpu"``), behind a serve handle, the
cluster started with obs_smoke's SLO rules and sampler cadence.  The
port's ``traced_serving`` section runs on it: the warm-up and the traced
request give the JAX engine's greedy ids on the same prompts in the same
order, the traced request renders as one tree holding JAX's span set
(``obs_smoke.py:415-416``), and ``smoke_ttft`` fires with that trace as
its exemplar, which ``exemplars_for`` finds in the TSDB.
"""

import dataclasses
import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import jax

from ray_tpu_torch.scripts import obs_smoke

# The loader ships to a replica process that cannot import this module.
cloudpickle.register_pickle_by_value(sys.modules[__name__])

# ray_tpu/scripts/obs_smoke.py:415-416
JAX_SPANS = {"serving-anatomy", "serve.route", "replica.handle",
             "llm.request", "llm.queue", "llm.kv_pull", "llm.prefill",
             "llm.decode"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    from ray_tpu.models import llama as jllama

    jcfg = jllama.LlamaConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, dtype="float32", remat=False)
    params = jllama.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_ids(model):
    """JAX's engine on the same prompts, in the replica's order."""
    from ray_tpu.llm.engine import EngineConfig, LLMEngine, SamplingParams

    jcfg, params, _ = model
    eng = LLMEngine(params, jcfg, EngineConfig(**obs_smoke.ENGINE))
    try:
        sp = SamplingParams(max_tokens=obs_smoke.MAX_TOKENS)
        return [eng.generate(list(p), sp) for p in
                (obs_smoke.WARMUP_PROMPT, obs_smoke.ANATOMY_PROMPT)]
    finally:
        eng.stop()


def _loader(tree_ref, cfg_kwargs):
    """The weights travel through the store: inline, the 0.4 MB tree
    would ride the serve controller's first call, which the native
    transport drops while the new controller reads nothing for 10 s
    (ROADMAP.md §3 item 3)."""
    def loader():
        import torch

        import ray_tpu_torch
        from ray_tpu_torch import convert
        from ray_tpu_torch.models import llama

        torch.set_num_threads(1)
        tree = ray_tpu_torch.get(tree_ref, timeout=60)
        return (convert.params_from_jax(tree, device="cpu"),
                llama.LlamaConfig(**cfg_kwargs))

    return loader


def _drop_engine_metrics():
    """Forget the port engine's metric families in this process.  A module
    run before this one in the same process may have served through an
    in-process engine with tracing on; a fresh ``init()`` re-uses the
    registry, so this process's flusher would push those observations and
    their exemplars into this module's cluster, on the same series as the
    replica's.  The replica's own families are what the section reads."""
    from ray_tpu_torch.llm import engine
    from ray_tpu_torch.util import metrics

    with engine._metrics_lock:
        stale = list((engine._METRICS or {}).values())
        engine._METRICS = None
    with metrics._registry_lock:
        metrics._registry[:] = [m for m in metrics._registry
                                if not any(m is s for s in stale)]


@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch as rt

    _drop_engine_metrics()
    saved = {k: os.environ.get(k) for k in obs_smoke.SMOKE_ENV}
    os.environ.update(obs_smoke.SMOKE_ENV)
    from ray_tpu_torch.util import tracing

    rt.init(min_workers=2, resources={"CPU": 4.0})
    tracing.enable_tracing()
    try:
        yield rt
    finally:
        tracing.disable_tracing()
        try:
            rt.serve.shutdown()
        finally:
            rt.shutdown()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


@pytest.fixture(scope="module")
def traced(port, model):
    jcfg, _, tree = model
    loader = _loader(port.put(tree), dataclasses.asdict(jcfg))
    return obs_smoke.traced_serving(loader, "cpu", jcfg.n_layers)


def test_the_replica_gives_jax_engines_ids(traced, jax_ids):
    anat = traced["anatomy"]
    assert [anat["warmup_tokens"], anat["tokens"]] == jax_ids


def test_the_traced_request_is_one_tree_of_jax_spans(traced):
    anat = traced["anatomy"]
    assert obs_smoke.ANATOMY_SPANS == JAX_SPANS
    assert JAX_SPANS <= set(anat["names"])
    # the replica's task span is the one name JAX's set leaves implicit
    assert set(anat["names"]) - JAX_SPANS == {"ReplicaActor.handle_request"}
    assert anat["route_policy"] == "prefix_aware"
    assert anat["kv_pull"] == "miss"
    assert anat["processes"] == 2
    assert 0 < anat["prefill_ms"] <= anat["ttft_ms"]

    from ray_tpu_torch.util import state

    tree = state.get_trace(anat["trace_id"])["tree"]
    assert len(tree) == 1 and tree[0]["name"] == "serving-anatomy"


def test_smoke_ttft_fires_with_the_trace_as_exemplar(traced):
    from ray_tpu_torch.util import state

    tid = traced["anatomy"]["trace_id"]
    slo = traced["slo_ttft"]
    assert slo["fire_s"] >= 0 and set(slo["phases"]) == {
        "queue", "kv_pull", "prefill", "decode"}
    row = next(r for r in state.slo_status()["rules"]
               if r["rule"] == "smoke_ttft")
    assert tid in row["attribution"]["exemplar_trace_ids"]
    fires = [e for e in state.list_events(kind="slo.fire")
             if e["data"].get("rule") == "smoke_ttft"]
    assert any(tid in e["data"].get("exemplar_trace_ids", ())
               for e in fires), fires
    ex = state.exemplars_for("llm_ttft_s", window_s=300.0)
    assert any(tid in by_bucket.values() for by_bucket in ex.values()), ex
