"""Cache-aware Llama forwards: bucketed prefill + batched paged decode.

Counterpart of ``ray_tpu/llm/model.py``.  The shapes stay static as there:
one decode step for the whole ``[max_slots]`` batch (inactive slots write
into the null page 0 and are ignored), one prefill per length bucket.

Where JAX donates the cache and returns the updated buffers, these
functions write the cache tensors in place (``index_put_``) and return only
what is new (logits, tokens).

The bucketed ``prefill`` sends its attention through
``ops.attention.flash_attention`` (the Hopper kernel on CUDA).  JAX masks
it with ``causal & (col < true_len)``; for every kept row (< true_len)
causality alone already excludes the columns >= true_len, and the K/V that
padded rows write at positions >= true_len are overwritten by decode before
any read (decode masks ``tpos <= position``).  So the logits at
``true_len - 1`` and every cache entry later read are the same function.
The prefix-hit prefill, the decode steps, ``copy_page`` and the page
scatter and gather of the P/D handoff and the KV tier (``inject_kv_pages``,
``extract_pages``) are plain torch ops, as JAX leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import torch_dtype
from ray_tpu_torch.models.llama import (LlamaConfig, layer_params, rms_norm,
                                        rope)
from ray_tpu_torch.ops.attention import ATTENTION


def _qkv(cfg: LlamaConfig, p, h):
    q = (h @ p["attn"]["wq"].to(h.dtype)).reshape(
        *h.shape[:-1], cfg.n_heads, cfg.head_dim)
    k = (h @ p["attn"]["wk"].to(h.dtype)).reshape(
        *h.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["attn"]["wv"].to(h.dtype)).reshape(
        *h.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _mlp(p, h):
    gate = F.silu(h @ p["mlp"]["w_gate"].to(h.dtype))
    up = h @ p["mlp"]["w_up"].to(h.dtype)
    return (gate * up) @ p["mlp"]["w_down"].to(h.dtype)


def _masked_softmax_attend(cfg: LlamaConfig, q, keys, vals, mask, eq: str,
                           out_eq: str):
    """JAX's XLA attention: scores in the model dtype scaled after the
    product, -1e30 where ``mask`` is False, softmax in f32, the weights cast
    back to the value dtype."""
    rep = cfg.n_heads // cfg.n_kv_heads
    keys = keys.repeat_interleave(rep, dim=-2)
    vals = vals.repeat_interleave(rep, dim=-2)
    scores = torch.einsum(eq, q, keys) / math.sqrt(cfg.head_dim)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    attn = torch.softmax(scores.float(), dim=-1)
    return torch.einsum(out_eq, attn.to(vals.dtype), vals)


@torch.no_grad()
def prefill(state: Dict, tokens: torch.Tensor, cache_k: torch.Tensor,
            cache_v: torch.Tensor, page_rows: torch.Tensor, true_len: int,
            slot_positions: torch.Tensor, cfg: LlamaConfig,
            attn_impl: str = "flash") -> torch.Tensor:
    """Prefill ONE sequence padded to a length bucket.

    tokens: [L] int (padded); page_rows: [L] page id per token position;
    slot_positions: [L] slot inside the page; true_len: int.  Writes K/V
    for all L positions into the paged cache in place and returns the f32
    logits at the last real token [V].  ``attn_impl="plain"`` runs the
    plain attention instead of the kernel (what the kernel is held
    against)."""
    attn = ATTENTION[attn_impl]
    L = tokens.shape[0]
    x = state["embed"].to(torch_dtype(cfg.dtype))[tokens]  # [L, D]
    positions = torch.arange(L, device=tokens.device)
    for i in range(cfg.n_layers):
        p = layer_params(state["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        cache_k[i].index_put_((page_rows, slot_positions), k)
        cache_v[i].index_put_((page_rows, slot_positions), v)
        out = attn(q[None], k[None], v[None], causal=True)[0]
        x = x + out.reshape(L, -1) @ p["attn"]["wo"].to(x.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, h)
    x = rms_norm(x, state["final_norm"], cfg.norm_eps)
    last = x[max(int(true_len) - 1, 0)]
    return last.float() @ state["lm_head"].float()


@torch.no_grad()
def prefill_with_prefix(state: Dict, tokens: torch.Tensor,
                        cache_k: torch.Tensor, cache_v: torch.Tensor,
                        page_rows: torch.Tensor, true_len: int,
                        slot_positions: torch.Tensor,
                        page_table: torch.Tensor, positions: torch.Tensor,
                        cfg: LlamaConfig) -> torch.Tensor:
    """Prefill the SUFFIX of one sequence whose leading pages are already
    resident (prefix-cache hit).

    tokens: [L] suffix padded to a bucket; positions: [L] absolute
    positions; page_rows/slot_positions: [L] write coordinates for the
    suffix KV; page_table: [P] the sequence's FULL page table (0-padded);
    true_len: suffix length.  Attention gathers keys through the page table,
    masked at tpos <= position.  Writes the cache in place; returns the f32
    logits at the last suffix token [V]."""
    L = tokens.shape[0]
    P = page_table.shape[0]
    page_size = cache_k.shape[2]
    x = state["embed"].to(torch_dtype(cfg.dtype))[tokens]  # [L, D]
    tpos = torch.arange(P * page_size, device=tokens.device)[None]  # [1, T]
    mask = (tpos <= positions[:, None])[None]  # [1, L, T]
    for i in range(cfg.n_layers):
        p = layer_params(state["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        cache_k[i].index_put_((page_rows, slot_positions), k)
        cache_v[i].index_put_((page_rows, slot_positions), v)
        keys = cache_k[i][page_table].reshape(
            P * page_size, cfg.n_kv_heads, cfg.head_dim)
        vals = cache_v[i][page_table].reshape(
            P * page_size, cfg.n_kv_heads, cfg.head_dim)
        out = _masked_softmax_attend(cfg, q, keys, vals, mask,
                                     "qhd,khd->hqk", "hqk,khd->qhd")
        x = x + out.reshape(L, -1) @ p["attn"]["wo"].to(x.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, h)
    x = rms_norm(x, state["final_norm"], cfg.norm_eps)
    last = x[max(int(true_len) - 1, 0)]
    return last.float() @ state["lm_head"].float()


@torch.no_grad()
def decode_step(state: Dict, tokens: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, page_tables: torch.Tensor,
                positions: torch.Tensor, active: torch.Tensor,
                cfg: LlamaConfig) -> torch.Tensor:
    """One token for EVERY slot (the continuous-batching hot loop).

    tokens: [B] current token per slot; positions: [B] its position;
    page_tables: [B, P] page ids (0 = null page); active: [B] bool.
    Writes the cache in place; returns the f32 logits [B, V]."""
    B = tokens.shape[0]
    P = page_tables.shape[1]
    page_size = cache_k.shape[2]
    x = state["embed"].to(torch_dtype(cfg.dtype))[tokens]  # [B, D]
    # where this step's k/v lands: slot b writes page_tables[b, pos//ps];
    # inactive slots write into the null page (page 0) — harmless scratch
    write_page = torch.gather(page_tables, 1,
                              (positions // page_size)[:, None])[:, 0]
    write_page = torch.where(active, write_page,
                             torch.zeros_like(write_page))
    write_slot = positions % page_size
    tpos = torch.arange(P * page_size, device=tokens.device)[None]  # [1, T]
    mask = (tpos <= positions[:, None])[:, None, :]  # [B, 1, T]
    for i in range(cfg.n_layers):
        p = layer_params(state["layers"], i)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h)  # q: [B, H, d]; k, v: [B, Hkv, d]
        q = rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        k = rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        cache_k[i].index_put_((write_page, write_slot), k)
        cache_v[i].index_put_((write_page, write_slot), v)
        keys = cache_k[i][page_tables].reshape(
            B, P * page_size, cfg.n_kv_heads, cfg.head_dim)
        vals = cache_v[i][page_tables].reshape(
            B, P * page_size, cfg.n_kv_heads, cfg.head_dim)
        out = _masked_softmax_attend(cfg, q, keys, vals, mask,
                                     "bhd,bthd->bht", "bht,bthd->bhd")
        x = x + out.reshape(B, -1) @ p["attn"]["wo"].to(x.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, h)
    x = rms_norm(x, state["final_norm"], cfg.norm_eps)
    return x.float() @ state["lm_head"].float()


def decode_step_greedy(state: Dict, tokens: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor,
                       page_tables: torch.Tensor, positions: torch.Tensor,
                       active: torch.Tensor, cfg: LlamaConfig
                       ) -> torch.Tensor:
    """Greedy decode: argmax on the device, so a burst of steps chains
    tokens on the device and the host fetches [B] int32 once."""
    logits = decode_step(state, tokens, cache_k, cache_v, page_tables,
                         positions, active, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def copy_page(cache_k: torch.Tensor, cache_v: torch.Tensor, src: int,
              dst: int) -> None:
    """Copy-on-write boundary page: duplicate one KV page across all layers,
    in place.  The whole page is copied even when only the first
    ``cow_len`` slots are valid — the suffix prefill / decode overwrites
    every slot past the divergence point before any attention reads it."""
    cache_k[:, dst] = cache_k[:, src]
    cache_v[:, dst] = cache_v[:, src]


@torch.no_grad()
def inject_kv_pages(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    idx: Sequence[int], kv_k, kv_v) -> None:
    """Scatter shipped KV pages into the paged cache, in place (the P/D
    decode side and KV-tier hydration).

    kv_k, kv_v: [n_layers, len(idx), page_size, n_kv, head_dim] tensors on
    any device, or numpy arrays (one host-to-device copy each); idx: the
    destination pages.  The JAX package pads idx and the pages to
    ``max_pages_per_seq`` only so that XLA compiles its scatter once, and
    the padded rows land in the null page 0; here only the real pages are
    written and page 0 never."""
    dev = cache_k.device
    index = torch.as_tensor(list(idx), dtype=torch.long, device=dev)
    for cache, kv in ((cache_k, kv_k), (cache_v, kv_v)):
        if not isinstance(kv, torch.Tensor):
            kv = torch.tensor(kv)  # a copy: numpy arrays may be read-only
        cache.index_copy_(1, index, kv.to(dev, cache.dtype))


@torch.no_grad()
def extract_pages(cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pages: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host copies of the given pages' KV across all layers: [n_layers,
    len(pages), page_size, n_kv, head_dim] each (the P/D prefill side and
    KV-tier sealing)."""
    index = torch.as_tensor(list(pages), dtype=torch.long,
                            device=cache_k.device)
    return (cache_k.index_select(1, index).cpu(),
            cache_v.index_select(1, index).cpu())
