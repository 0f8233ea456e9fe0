"""The port's batch inference and preprocessors against the JAX package's.

``_EngineUDF`` of each package runs over the same numpy batch with the
same tiny f32 model; generated tokens and texts must be equal.
``build_llm_processor`` runs over each package's own ``Dataset`` with two
engine actors, the JAX package's on its session cluster and the port's
on its runtime (a module fixture starts it in the same process): the ids
and texts of every row must be equal.  The preprocessor cases of
``tests/test_data_llm.py`` run over each package's ``Dataset`` and read
the same rows.
"""

import dataclasses
import math
import sys

import cloudpickle
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

# functions defined here run in worker processes that cannot import this
# module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU models: one intra-op thread each, so the test workers do
    not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the engine actors
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(ray_cluster, _one_torch_thread):
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 28,
            resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


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


def _bounded(fn, *args, **kwargs):
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args, **kwargs).result(timeout=TIMEOUT)


def test_build_llm_processor_over_a_dataset(loaders, ray_cluster, port):
    """Each package's processor over its own ``Dataset``: 7 rows in 3
    blocks, batches of 3, two engine actors; the rows come back in order
    with equal ids and texts."""
    import ray_tpu.data
    import ray_tpu_torch.data

    jload, tload = loaders
    sampling = {"max_tokens": 4}

    def run(data, mod, eng, load, **extra):
        proc = mod.build_llm_processor(
            mod.ProcessorConfig(model_loader=load, engine_config=_ecfg(eng),
                                batch_size=3, concurrency=2,
                                sampling=sampling, **extra),
            preprocess=lambda r: {"prompt": f"q: {r['q']}", "q": r["q"]},
            postprocess=lambda r: {
                "q": r["q"], "text": r["generated_text"],
                "ids": [int(t) for t in r["generated_tokens"]]})
        ds = data.from_items([{"q": str(i)} for i in range(7)],
                             override_num_blocks=3)
        return proc(ds).take_all()

    want = _bounded(run, ray_tpu.data, jbatch, jengine, jload)
    got = _bounded(run, ray_tpu_torch.data, tbatch, tengine, tload,
                   device="cpu")
    assert [r["q"] for r in got] == [str(i) for i in range(7)]
    assert all(1 <= len(r["ids"]) <= 4 for r in got)
    assert got == want


# ---------------------------------------------------------------------------
# tests/test_data_llm.py's preprocessor cases, under both packages


def _preprocessors(rd):
    ds = rd.from_items([
        {"x": float(i), "y": float(2 * i), "cat": "ab"[i % 2]}
        for i in range(10)])
    out = {}
    scaler = rd.StandardScaler(columns=["x"]).fit(ds)
    xs = np.array(sorted(r["x"] for r in scaler.transform(ds).take_all()))
    assert abs(xs.mean()) < 1e-9 and abs(xs.std() - 1.0) < 1e-6
    out["scaled"] = xs.tolist()
    mm = rd.MinMaxScaler(columns=["y"]).fit(ds)
    ys = [r["y"] for r in mm.transform(ds).take_all()]
    assert min(ys) == 0.0 and max(ys) == 1.0
    out["minmax"] = ys
    le = rd.LabelEncoder(label_column="cat").fit(ds)
    out["labels"] = [r["cat"] for r in le.transform(ds).take_all()]
    assert set(out["labels"]) == {0, 1}
    oh = rd.OneHotEncoder(columns=["cat"]).fit(ds)
    row = oh.transform(ds).take(1)[0]
    assert {"cat_a", "cat_b"} <= set(row)
    out["onehot"] = sorted(row.items())
    chain = rd.Chain(
        rd.StandardScaler(columns=["x"]),
        rd.Concatenator(columns=["x", "y"], output_column_name="f"),
    ).fit(ds)
    row = chain.transform(ds).take(1)[0]
    assert np.asarray(row["f"]).shape == (2,)
    out["chain"] = np.asarray(row["f"]).tolist()
    with pytest.raises(Exception, match="must be fit"):
        rd.StandardScaler(columns=["x"]).transform(ds)
    return out


def _simple_imputer(rd):
    ds = rd.from_items([{"v": 1.0}, {"v": float("nan")}, {"v": 3.0}])
    imp = rd.SimpleImputer(columns=["v"]).fit(ds)
    vals = sorted(r["v"] for r in imp.transform(ds).take_all())
    assert vals == [1.0, 2.0, 3.0]
    raw = [r["v"] for r in ds.take_all()]
    return vals, [None if math.isnan(v) else v for v in raw]


@pytest.mark.parametrize("case", [_preprocessors, _simple_imputer],
                         ids=["preprocessors", "simple_imputer"])
def test_preprocessors_match_jax(case, ray_cluster, port):
    import ray_tpu.data
    import ray_tpu_torch.data

    want = _bounded(case, ray_tpu.data)
    got = _bounded(case, ray_tpu_torch.data)
    assert got == want
