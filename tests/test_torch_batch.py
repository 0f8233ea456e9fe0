"""The port's batch inference against the JAX package's.

``_EngineUDF`` of each package runs over the same numpy batch with the
same tiny f32 model; generated tokens and texts must be equal.
``build_llm_processor`` drives any dataset with ``map`` and
``map_batches``: here a small in-memory stand-in.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import batch as jbatch
from ray_tpu.llm import engine as jengine
from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.llm import batch as tbatch
from ray_tpu_torch.llm import engine as tengine
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
def loaders():
    jcfg = jllama.LlamaConfig(
        vocab_size=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, dtype="float32", remat=False)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = jllama.init(jcfg, jax.random.PRNGKey(2))
    state = convert.llama_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    return (lambda: (params, jcfg)), (lambda: (state, tcfg))


def _ecfg(mod):
    return mod.EngineConfig(max_slots=4, num_pages=64, page_size=8,
                            max_seq_len=256, prefill_buckets=(16, 32, 64))


PROMPTS = np.array(["the cat", "a much longer prompt about dogs", "x",
                    "the cat sat", "1 2 3 4 5 6 7 8 9", "zz", "hello",
                    "the cat sat on the mat"])


@pytest.mark.parametrize("chat", [False, True])
def test_engine_udf_matches_jax(loaders, chat):
    jload, tload = loaders
    sampling = {"max_tokens": 6, "stop_token_ids": (7,)}
    judf = jbatch._EngineUDF(jbatch.ProcessorConfig(
        model_loader=jload, engine_config=_ecfg(jengine),
        sampling=sampling, apply_chat_template=chat))
    tudf = tbatch._EngineUDF(tbatch.ProcessorConfig(
        model_loader=tload, engine_config=_ecfg(tengine),
        sampling=sampling, apply_chat_template=chat, device="cpu"))
    batch = {"prompt": PROMPTS, "id": np.arange(len(PROMPTS))}
    try:
        want, got = judf(dict(batch)), tudf(dict(batch))
    finally:
        judf._engine.stop()
        tudf.shutdown()
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["id"], batch["id"])
    assert got["generated_text"] == want["generated_text"]
    assert [list(t) for t in got["generated_tokens"]] == \
        [list(t) for t in want["generated_tokens"]]
    assert all(len(t) <= 6 for t in got["generated_tokens"])
    assert sum(len(t) for t in got["generated_tokens"]) > 8


class _Dataset:
    """In-memory dataset with the two methods the processor calls."""

    def __init__(self, rows):
        self.rows = rows

    def map(self, fn):
        return _Dataset([fn(dict(r)) for r in self.rows])

    def map_batches(self, cls, fn_constructor_args, concurrency,
                    batch_size, batch_format):
        assert batch_format == "numpy" and concurrency == 1
        udf = cls(*fn_constructor_args)
        try:
            out = []
            for i in range(0, len(self.rows), batch_size):
                rows = self.rows[i:i + batch_size]
                b = udf({k: np.array([r[k] for r in rows]) for k in rows[0]})
                out += [{k: b[k][j] for k in b} for j in range(len(rows))]
        finally:
            udf.shutdown()
        return _Dataset(out)


def test_build_llm_processor_over_a_dataset(loaders):
    _, tload = loaders
    proc = tbatch.build_llm_processor(
        tbatch.ProcessorConfig(model_loader=tload, engine_config=_ecfg(
            tengine), batch_size=3, sampling={"max_tokens": 4},
            device="cpu"),
        preprocess=lambda r: {"prompt": f"q: {r['q']}", "q": r["q"]},
        postprocess=lambda r: {"q": r["q"], "n": len(r["generated_tokens"])})
    out = proc(_Dataset([{"q": str(i)} for i in range(7)])).rows
    assert [r["q"] for r in out] == [str(i) for i in range(7)]
    assert all(1 <= r["n"] <= 4 for r in out)
