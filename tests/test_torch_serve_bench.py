"""The port's serving load-wall benchmark against the JAX package's.

The request lists must be the JAX bench's, draw for draw.  Under the load
wall's geometry (page 8, the bench's prefill buckets, a page pool below
the 6-family working set) the same requests, sent one at a time, must
give the same output tokens and the same eviction, copy-on-write, hit and
preemption counts on a JAX engine and a port engine holding the same tiny
f32 weights (``convert.llama_params_from_jax``).  Then a tiny cell of each
policy and a tiny tier-on kill cell run on port engines on the CPU and
complete every request without an error.  Nothing here depends on
timing; the card's run (``chip_smoke.py``'s ``run_serve_bench``) gates
the rest.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ray_tpu._private import serve_bench as jbench
from ray_tpu.llm import engine as jengine
from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch._private import serve_bench as tbench
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.request_router import Pow2Router, PrefixAwareRouter

# 6 families of 28 pages (a 232-token prompt plus its one generated
# token) are 168 pages; a pool of 100 holds barely three
WALL_PAGES = 100
WALL_REQUESTS = 40


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


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("families", [6, 14])
def test_request_lists_equal_jax(seed, families):
    want = jbench._build_requests(150, seed, families)
    got = tbench._build_requests(150, seed, families)
    assert got == want
    assert {len(toks) for _, toks in got} == {tbench._PREFIX_TOKENS
                                              + tbench._TAIL_TOKENS}


def _load_wall(mod, model):
    """The bench's requests one at a time, each drained before the next,
    on one engine of the load wall's geometry with a pool below the
    working set; returns the output tokens and the counters, read after
    stop()."""
    jcfg, tcfg, params, state = model
    ecfg = mod.EngineConfig(
        page_size=tbench._PAGE_SIZE, num_pages=WALL_PAGES, max_slots=4,
        max_seq_len=tbench._MAX_SEQ_LEN, prefill_buckets=tbench._BUCKETS)
    if mod is tengine:
        engine = tengine.LLMEngine(state, tcfg, ecfg, device="cpu")
    else:
        engine = jengine.LLMEngine(params, jcfg, ecfg)
    sp = mod.SamplingParams(max_tokens=tbench._MAX_TOKENS)
    try:
        outs = [engine.generate(toks, sp) for _, toks in
                tbench._build_requests(WALL_REQUESTS, 7, families=6)]
    finally:
        engine.stop()
    st = engine.stats()
    pc = st["prefix_cache"]
    counts = {k: st[k] for k in ("page_evictions", "cow_copies",
                                 "prefill_tokens_saved", "preempted",
                                 "prefills")}
    counts.update({k: pc[k] for k in (
        "hit_tokens", "lookup_tokens", "evictions_cold_family",
        "evictions_hot_root_forced")})
    return outs, counts


def test_load_wall_engine_mechanics_equal_jax(model):
    want, want_counts = _load_wall(jengine, model)
    got, got_counts = _load_wall(tengine, model)
    assert got == want
    assert got_counts == want_counts
    # the geometry reached the wall and reused pages across it
    assert got_counts["page_evictions"] > 0
    assert got_counts["cow_copies"] > 0
    assert got_counts["prefill_tokens_saved"] > 0


def _tiny(model):
    _, tcfg, _, state = model
    return state, tcfg


@pytest.mark.parametrize("router_cls", [Pow2Router, PrefixAwareRouter])
def test_cell_completes_every_request(model, router_cls):
    cell = tbench._run_cell(_tiny(model), router_cls, 24, 4, 7,
                            device="cpu")
    assert cell["requests"] == 24
    assert sum(cell["decisions"].values()) == 24
    assert cell["ttft_p50_ms"] is not None


def test_kill_cell_completes_every_request(model):
    cell = tbench._run_kill_cell(_tiny(model), True, 48, 4, 7, families=6,
                                 kill_frac=0.45, device="cpu")
    assert cell["errors"] == 0, cell["first_error"]
    assert cell["requests_completed"] == 48
    assert cell["kill_at_request"] == 21


def test_entry_points_raise_without_a_gpu(model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.reference_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run(_tiny(model), ((1, 1),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--ladder", "1:1"])
