"""The port's KV tier against the JAX package's.

KVT1 blobs must be byte-identical for the same KV in f32 and bf16, and each
package must decode the other's; damaged blobs fail with the same typed
reasons.  At the engine level the tiny f32 model (the JAX package's own
tier-test model, carried across by ``convert.llama_params_from_jax``) runs
the same seal → prehydrate → stream scenario on both engines: token streams
exact, tier counters equal.  A spine sealed by either package's engine is
hydrated by the other's, and a torn blob falls back to cold prefill with
the same stream.
"""

import dataclasses
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import engine as jengine
from ray_tpu.llm import kv_tier as jkt
from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import kv_tier as tkt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util import metrics as tmetrics

PACKAGES = {"jax": (jengine, jkt), "torch": (tengine, tkt)}


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


def _engine(pkg, model, tier):
    jcfg, tcfg, params, state = model
    mod = PACKAGES[pkg][0]
    ecfg = mod.EngineConfig(max_slots=4, num_pages=64, page_size=8,
                            max_seq_len=256, prefill_buckets=(16, 32, 64, 128))
    if pkg == "torch":
        return tengine.LLMEngine(state, tcfg, ecfg, kv_tier=tier,
                                 device="cpu")
    return jengine.LLMEngine(params, jcfg, ecfg, kv_tier=tier)


def _prompt(seed: int, n: int = 40):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 128, n)]


def _kv(seed, dtype):
    """[layers 2, blocks 3, page 8, kv heads 2, head_dim 4] K and V, as
    numpy for the JAX package and as torch for the port."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        return ((k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)),
                (torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()))
    return (k, v), (torch.from_numpy(k), torch.from_numpy(v))


def _bits(x):
    """The raw bits of a numpy (ml_dtypes bf16 or f32) or torch array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.numpy()
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


# ------------------------------------------------------------ blob codec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blobs_byte_equal_and_cross_decode(dtype):
    tokens = list(range(24))
    (jk, jv), (tk, tv) = _kv(0, dtype)
    jblob = jkt.encode_spine(tokens, jk, jv, page_size=8)
    tblob = tkt.encode_spine(tokens, tk, tv, page_size=8)
    assert tblob == jblob  # byte-identical, header included

    t_tokens, k, v, hdr = tkt.decode_spine(jblob)  # port reads JAX's blob
    assert t_tokens == tokens and hdr["dtype"] == dtype
    assert k.dtype == getattr(torch, dtype) and k.device.type == "cpu"
    np.testing.assert_array_equal(_bits(k), _bits(jk))
    np.testing.assert_array_equal(_bits(v), _bits(jv))

    j_tokens, k, v, hdr = jkt.decode_spine(tblob)  # JAX reads the port's
    assert j_tokens == tokens and hdr["dtype"] == dtype
    np.testing.assert_array_equal(_bits(k), _bits(tk))
    np.testing.assert_array_equal(_bits(v), _bits(tv))


_DAMAGE = {
    "bad_magic": lambda b: b"JUNK" + b[4:],
    "torn_stripe": lambda b: b[:len(b) // 2],
    "header_cut": lambda b: b[:10],
    "no_preamble": lambda b: b[:6],
}


@pytest.mark.parametrize("damage", sorted(_DAMAGE))
def test_damaged_blob_typed_reasons_match(damage):
    kv = np.ones((1, 1, 8, 2, 4), dtype=np.float32)
    blob = _DAMAGE[damage](jkt.encode_spine(list(range(8)), kv, kv, 8))
    with pytest.raises(jkt.KVPullError) as want:
        jkt.decode_spine(blob)
    with pytest.raises(tkt.KVPullError) as got:
        tkt.decode_spine(blob)
    assert got.value.reason == want.value.reason
    assert got.value.reason in ("corrupt", "truncated")


def test_oid_for_equal():
    for root in ("aa" * 8, "0123456789abcdef"):
        for blocks in (1, 2, 37):
            assert tkt.KVTier.oid_for(root, blocks) == \
                jkt.KVTier.oid_for(root, blocks)
    assert tkt.KVTier.oid_for("aa" * 8, 2) != tkt.KVTier.oid_for("aa" * 8, 3)


def test_directory_never_shadows_deeper_spine():
    d = tkt.LocalDirectory()
    d.publish("r", {"oid": "aa", "blocks": 4, "hits": 9})
    d.publish("r", {"oid": "bb", "blocks": 2, "hits": 20})
    rec = d.lookup("r")
    assert rec["oid"] == "aa" and rec["blocks"] == 4 and rec["hits"] == 20
    assert d.hottest(1) == ["r"]


def test_default_tier_is_only_the_installed_one():
    assert tkt.default_tier() is None
    tier = tkt.KVTier(tkt.InProcessStore(), tkt.LocalDirectory())
    tkt.set_default_tier(tier)
    try:
        assert tkt.default_tier() is tier
    finally:
        tkt.set_default_tier(None)
    assert tkt.default_tier() is None


# ------------------------------------------------- seal -> pull -> decode


def _seal_then_prehydrate(pkg, model):
    """Engine 1 serves a prompt twice (the second run heats and seals its
    family); a fresh engine 2 over the same store prehydrates the hottest
    families, then serves the prompt."""
    kt = PACKAGES[pkg][1]
    sp = PACKAGES[pkg][0].SamplingParams(max_tokens=10)
    store, directory = kt.InProcessStore(), kt.LocalDirectory()
    prompt = _prompt(0)
    e1 = _engine(pkg, model, kt.KVTier(store, directory, seal_min_hits=1))
    try:
        first = [e1.generate(list(prompt), sp) for _ in range(2)]
    finally:
        e1.stop()  # joins the scheduler, which seals after a stream ends
    s1 = e1.stats()
    tier2 = kt.KVTier(store, directory, seal_min_hits=1)
    e2 = _engine(pkg, model, tier2)
    try:
        e2.kv_prehydrate(tier2.hottest(8))
        deadline = time.monotonic() + 30
        while e2.stats()["kv_pulls"] < 1:
            assert time.monotonic() < deadline, "prehydrate never pulled"
            time.sleep(0.01)
        got = e2.generate(list(prompt), sp)
    finally:
        e2.stop()
    return first, got, s1, e2.stats()


def test_seal_prehydrate_stream_matches_jax(model):
    want = _seal_then_prehydrate("jax", model)
    got = _seal_then_prehydrate("torch", model)
    assert got[0] == want[0] and got[0][0] == got[0][1]
    assert got[1] == want[1] == want[0][0]  # streams exact
    assert got[2]["kv_seals"] == want[2]["kv_seals"] >= 1
    for key in ("kv_seals", "kv_pulls", "kv_pull_pages",
                "prefill_tokens_saved", "kv_pull_fallbacks"):
        assert got[3][key] == want[3][key], key
    assert got[3]["kv_pulls"] >= 1 and got[3]["kv_pull_pages"] >= 4
    assert got[3]["prefill_tokens_saved"] > 0
    assert got[3]["kv_tier"]["pulls"] == want[3]["kv_tier"]["pulls"]


@pytest.mark.parametrize("sealer,puller", [("jax", "torch"),
                                           ("torch", "jax")])
def test_spine_sealed_by_one_package_hydrates_the_other(model, sealer,
                                                        puller):
    """The puller's tier reads the sealer's store and directory (the two
    packages' stores have one surface)."""
    skt, pkt = PACKAGES[sealer][1], PACKAGES[puller][1]
    store, directory = skt.InProcessStore(), skt.LocalDirectory()
    prompt = _prompt(1)
    e1 = _engine(sealer, model, skt.KVTier(store, directory,
                                           seal_min_hits=1))
    sp1 = PACKAGES[sealer][0].SamplingParams(max_tokens=8)
    try:
        expected = e1.generate(list(prompt), sp1)
        e1.generate(list(prompt), sp1)
        assert e1.stats()["kv_seals"] >= 1
    finally:
        e1.stop()
    e2 = _engine(puller, model, pkt.KVTier(store, directory,
                                           seal_min_hits=1))
    try:
        got = e2.generate(list(prompt),
                          PACKAGES[puller][0].SamplingParams(max_tokens=8))
        st = e2.stats()
    finally:
        e2.stop()
    assert got == expected
    assert st["kv_pulls"] >= 1 and st["kv_pull_pages"] >= 4
    assert st["kv_pull_fallbacks"] == 0
    assert st["prefix_cache"]["hit_tokens"] >= 32


def _truncated_fallback(pkg, model):
    kt = PACKAGES[pkg][1]
    sp = PACKAGES[pkg][0].SamplingParams(max_tokens=8)
    store, directory = kt.InProcessStore(), kt.LocalDirectory()
    prompt = _prompt(3)
    e1 = _engine(pkg, model, kt.KVTier(store, directory, seal_min_hits=1))
    try:
        expected = e1.generate(list(prompt), sp)
        e1.generate(list(prompt), sp)
    finally:
        e1.stop()
    with store._lock:  # tear every sealed blob in half
        for oid in list(store._objs):
            store._objs[oid] = store._objs[oid][:len(store._objs[oid]) // 2]
    e2 = _engine(pkg, model, kt.KVTier(store, directory, seal_min_hits=1))
    try:
        got = e2.generate(list(prompt), sp)
        st = e2.stats()
    finally:
        e2.stop()
    return expected, got, st


def _fallbacks(reason):
    for snap in tmetrics.snapshot():
        if snap["name"] == "llm_kv_pull_fallbacks_total":
            return snap["values"].get((reason,), 0.0)
    return 0.0


def test_truncated_blob_falls_back_like_jax(model):
    want = _truncated_fallback("jax", model)
    before = _fallbacks("truncated")
    got = _truncated_fallback("torch", model)
    assert got[0] == want[0] and got[1] == want[1] == got[0]
    assert got[2]["kv_pull_fallbacks"] == want[2]["kv_pull_fallbacks"] >= 1
    assert got[2]["kv_pulls"] == 0 == want[2]["kv_pulls"]
    assert _fallbacks("truncated") - before == got[2]["kv_pull_fallbacks"]
    assert got[2]["prefix_cache"]["hit_tokens"] == 0  # genuinely cold
