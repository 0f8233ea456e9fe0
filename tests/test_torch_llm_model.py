"""The port's cache-aware forwards against ``ray_tpu.llm.model``.

Both sides get the same f32 weights, tokens, pages and tables; the port
writes its cache in place where JAX returns a new one.  Logits and the
cache entries at valid positions (pages a sequence owns, slots < its
length) are compared; the null page 0 holds scratch on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import model as jlm
from ray_tpu.llm.paged_cache import CacheConfig as JCacheConfig
from ray_tpu.llm.paged_cache import init_cache as jinit_cache
from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.llm import model as tlm
from ray_tpu_torch.llm.paged_cache import CacheConfig, init_cache
from ray_tpu_torch.models import llama as tllama

TOL = 1e-4  # f32 logits and K/V; summation order differs between stacks
PS, NUM_PAGES, P = 8, 16, 8  # page size, pool pages, pages per table


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


def _caches(cfg):
    kw = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, num_pages=NUM_PAGES, page_size=PS,
              dtype="float32")
    jk, jv = jinit_cache(JCacheConfig(**kw))
    tk, tv = init_cache(CacheConfig(**kw), device="cpu")
    return [jk, jv], [tk, tv]


def _rows(pages, positions):
    pi = positions // PS
    return np.array([pages[i] if i < len(pages) else 0 for i in pi],
                    np.int32), (positions % PS).astype(np.int32)


def _prefill(model, jc, tc, tokens, pages, true_len):
    jcfg, tcfg, params, state = model
    bucket = len(tokens)
    rows, slots = _rows(pages, np.arange(bucket))
    jlog, jc[0], jc[1] = jlm.prefill(
        params, jnp.asarray(tokens), jc[0], jc[1], jnp.asarray(rows),
        jnp.int32(true_len), jnp.asarray(slots), jcfg)
    tlog = tlm.prefill(state, torch.from_numpy(tokens).long(), tc[0], tc[1],
                       torch.from_numpy(rows).long(), true_len,
                       torch.from_numpy(slots).long(), tcfg)
    return np.asarray(jlog), tlog.numpy()


def _assert_cache_close(jc, tc, pages, n_tokens):
    for j, t in zip(jc, tc):
        j = np.asarray(j)
        for pos in range(n_tokens):
            page, slot = pages[pos // PS], pos % PS
            np.testing.assert_allclose(t[:, page, slot].numpy(),
                                       j[:, page, slot], atol=TOL, rtol=0)


def _tokens(n, bucket, seed):
    out = np.zeros(bucket, np.int32)
    out[:n] = np.random.default_rng(seed).integers(1, 128, n)
    return out


def test_prefill_matches(model):
    jc, tc = _caches(model[0])
    pages = [3, 5, 7]
    jlog, tlog = _prefill(model, jc, tc, _tokens(20, 32, 0), pages, 20)
    assert tlog.shape == (128,) and np.abs(tlog - jlog).max() < TOL
    _assert_cache_close(jc, tc, pages, 20)


def test_prefill_plain_attention_is_the_same_function(model):
    _, tcfg, _, state = model
    tokens = torch.from_numpy(_tokens(20, 32, 1)).long()
    rows, slots = (torch.from_numpy(a).long()
                   for a in _rows([2, 4, 6], np.arange(32)))
    outs = []
    for impl in ("flash", "plain"):
        ck, cv = init_cache(CacheConfig(2, 2, 16, NUM_PAGES, PS, "float32"),
                            device="cpu")
        outs.append(tlm.prefill(state, tokens, ck, cv, rows, 20, slots, tcfg,
                                attn_impl=impl))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)


def test_prefill_with_prefix_matches(model):
    jcfg, tcfg, params, state = model
    jc, tc = _caches(jcfg)
    pages = [3, 5, 7, 9]
    full = _tokens(30, 32, 2)
    # the prefix (2 full pages) first, through the bucketed prefill
    _prefill(model, jc, tc, np.concatenate([full[:16], np.zeros(16, np.int32)]),
             pages[:2], 16)
    ls, bucket, prefix = 14, 16, 16
    suffix = np.zeros(bucket, np.int32)
    suffix[:ls] = full[16:30]
    positions = (prefix + np.arange(bucket)).astype(np.int32)
    rows, slots = _rows(pages, positions)
    table = np.zeros(P, np.int32)
    table[:len(pages)] = pages
    jlog, jc[0], jc[1] = jlm.prefill_with_prefix(
        params, jnp.asarray(suffix), jc[0], jc[1], jnp.asarray(rows),
        jnp.int32(ls), jnp.asarray(slots), jnp.asarray(table),
        jnp.asarray(positions), jcfg)
    t = {k: torch.from_numpy(v).long() for k, v in dict(
        suffix=suffix, rows=rows, slots=slots, table=table,
        positions=positions).items()}
    tlog = tlm.prefill_with_prefix(state, t["suffix"], tc[0], tc[1],
                                   t["rows"], ls, t["slots"], t["table"],
                                   t["positions"], tcfg)
    assert np.abs(tlog.numpy() - np.asarray(jlog)).max() < TOL
    _assert_cache_close(jc, tc, pages, prefix + ls)


def test_decode_steps_match(model):
    jcfg, tcfg, params, state = model
    jc, tc = _caches(jcfg)
    seqs = {0: ([1, 2], 9), 2: ([4, 6], 13)}  # slot -> (pages, length)
    for seed, (pages, n) in seqs.items():
        _prefill(model, jc, tc, _tokens(n, 16, seed), pages, n)
    B = 4
    tables = np.zeros((B, P), np.int32)
    positions = np.zeros(B, np.int32)
    active = np.zeros(B, bool)
    toks = np.zeros(B, np.int32)
    for slot, (pages, n) in seqs.items():
        tables[slot, :len(pages)] = pages
        positions[slot] = n
        active[slot] = True
        toks[slot] = 5 + slot
    tt = torch.from_numpy(tables).long()
    ta = torch.from_numpy(active)
    for step in range(3):
        pos = positions + step
        jlog, jc[0], jc[1] = jlm.decode_step(
            params, jnp.asarray(toks), jc[0], jc[1], jnp.asarray(tables),
            jnp.asarray(pos), jnp.asarray(active), jcfg)
        tlog = tlm.decode_step(state, torch.from_numpy(toks).long(), tc[0],
                               tc[1], tt, torch.from_numpy(pos).long(), ta,
                               tcfg)
        assert np.abs(tlog.numpy()[active]
                      - np.asarray(jlog)[active]).max() < TOL
        jtok, jc[0], jc[1] = jlm.decode_step_greedy(
            params, jnp.asarray(toks), jc[0], jc[1], jnp.asarray(tables),
            jnp.asarray(pos), jnp.asarray(active), jcfg)
        ttok = tlm.decode_step_greedy(state, torch.from_numpy(toks).long(),
                                      tc[0], tc[1], tt,
                                      torch.from_numpy(pos).long(), ta, tcfg)
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy()[active],
                                      np.asarray(jtok)[active])
        toks = np.array(jtok)
    for slot, (pages, n) in seqs.items():
        _assert_cache_close(jc, tc, pages, n + 3)


def test_copy_page_matches(model):
    jcfg = model[0]
    jc, tc = _caches(jcfg)
    rng = np.random.default_rng(3)
    fill = rng.standard_normal(np.asarray(jc[0]).shape).astype(np.float32)
    jc = [jnp.asarray(fill), jnp.asarray(-fill)]
    tc = [torch.from_numpy(fill.copy()), torch.from_numpy(-fill)]
    jk, jv = jlm.copy_page(jc[0], jc[1], jnp.int32(4), jnp.int32(9))
    tlm.copy_page(tc[0], tc[1], 4, 9)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jv))
