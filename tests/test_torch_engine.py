"""The port's LLM engine against the JAX engine, plus the port's rules.

Both engines get the same tiny f32 weights and the same requests; greedy
streams must be identical, through a prefix-cache hit, a sampled request
(same numpy generator on both sides) and preemption in a small page pool.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import engine as jengine
from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import llama as tllama

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _make(mod, model, num_pages):
    jcfg, tcfg, params, state = model
    ecfg = mod.EngineConfig(max_slots=4, num_pages=num_pages, page_size=8,
                            max_seq_len=256, prefill_buckets=(16, 32, 64))
    if mod is tengine:
        return tengine.LLMEngine(state, tcfg, ecfg, device="cpu")
    return jengine.LLMEngine(params, jcfg, ecfg)


def _drain(req):
    toks = []
    while True:
        item = req.out_queue.get(timeout=120)
        if item is None:
            return toks
        if isinstance(item, Exception):
            raise item
        toks.append(item)


def _prompts():
    rng = np.random.default_rng(0)
    a = [int(t) for t in rng.integers(1, 128, 30)]
    b = a[:16] + [int(t) for t in rng.integers(1, 128, 10)]
    c = [int(t) for t in rng.integers(1, 128, 21)]
    return a, b, c


def _sequential(mod, model):
    """A request, one sharing its first two pages, then a sampled one."""
    engine = _make(mod, model, 64)
    a, b, c = _prompts()
    try:
        out = [engine.generate(a, mod.SamplingParams(max_tokens=10)),
               engine.generate(b, mod.SamplingParams(max_tokens=10)),
               engine.generate(c, mod.SamplingParams(
                   max_tokens=10, temperature=0.8, seed=3))]
        return out, engine.stats()
    finally:
        engine.stop()


def _pressure(mod, model):
    """Four requests that together need 28 pages of a 15-page pool."""
    engine = _make(mod, model, 16)
    rng = np.random.default_rng(1)
    reqs = [engine.submit([int(t) for t in rng.integers(1, 128, 12)],
                          mod.SamplingParams(max_tokens=40))
            for _ in range(4)]
    engine.start()
    try:
        return [_drain(r) for r in reqs], engine.stats()
    finally:
        engine.stop()


@pytest.mark.parametrize("scenario", [_sequential, _pressure])
def test_streams_match_jax_engine(model, scenario):
    want, jstats = scenario(jengine, model)
    got, tstats = scenario(tengine, model)
    assert got == want
    if scenario is _sequential:
        assert [len(s) for s in got] == [10, 10, 10]
        assert tstats["prefix_cache"]["hit_tokens"] >= 16
        assert tstats["prefix_cache"]["hit_tokens"] == \
            jstats["prefix_cache"]["hit_tokens"]
    else:
        assert [len(s) for s in got] == [40] * 4
        assert tstats["preempted"] > 0


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_ray_tpu():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 8
    # ml_dtypes comes with JAX and is absent where the port runs on the card
    banned = {"jax", "jaxlib", "optax", "ray_tpu", "ml_dtypes"}
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert bad == []


def test_the_cpp_client_includes_nothing_of_jax_or_ray_tpu():
    """Every quoted ``#include`` under ``ray_tpu_torch/cpp/`` resolves,
    from the including file's directory or the builder's ``-I``
    directories, to a file of ``ray_tpu_torch/``; those directories are
    all the port's; and no source names JAX or the JAX package."""
    import re

    from ray_tpu_torch.cpp import build

    port = ROOT / "ray_tpu_torch"
    dirs = [pathlib.Path(d).resolve() for d in build.INCLUDE_DIRS]
    assert dirs and all(d.is_relative_to(port) and d.is_dir() for d in dirs)
    assert build.include_flags() == [f"-I{d}" for d in build.INCLUDE_DIRS]
    files = sorted(p for p in (port / "cpp").rglob("*")
                   if p.suffix in (".h", ".cc"))
    assert {p.name for p in files} >= {"client.h", "client.cc", "demo.cc",
                                       "generate.cc"}
    resolved = set()
    for f in files:
        text = f.read_text()
        assert not re.search(r"jax|ray_tpu(?!_torch)", text, re.I), f
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            hits = [d / name for d in [f.parent, *dirs]
                    if (d / name).is_file()]
            assert hits, (f.name, name)
            target = hits[0].resolve()
            assert target.is_relative_to(port), (f.name, name, target)
            resolved.add(target.relative_to(port).as_posix())
    assert resolved == {"native/wire.h",
                        "cpp/include/ray_tpu_torch/client.h"}


def test_entry_points_raise_without_a_gpu(model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg, _, state = model
    from ray_tpu_torch.llm.paged_cache import CacheConfig, init_cache

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.LLMEngine(state, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(CacheConfig(n_layers=1, n_kv_heads=1, head_dim=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.llama_params_from_jax({"x": np.zeros(2, np.float32)})
    from ray_tpu_torch.llm.pd_disagg import DecodeServer, PrefillServer
    from ray_tpu_torch.llm.server import LLMConfig, LLMServer

    cfg = LLMConfig(model_loader=lambda: (state, tcfg))
    for server in (LLMServer, PrefillServer, DecodeServer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server(cfg)


def test_byte_tokenizer_round_trip():
    tok = ByteTokenizer()
    ids = tok.encode("héllo")
    assert ids[0] == tok.bos_id and tok.decode(ids) == "héllo"
