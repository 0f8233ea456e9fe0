"""Llama-family decoder LM in PyTorch.

Counterpart of ``ray_tpu/models/llama.py``.  Parameters are a nested dict
of tensors with the same keys and the same stacked ``[n_layers, ...]``
layout as the JAX tree, so JAX parameters load unchanged
(``ray_tpu_torch.convert``).  Master weights are f32; matmul weights and
norms are cast to ``cfg.dtype`` where they are used, as in JAX.
Attention goes through ``_attention``: ``ops.attention.flash_attention``
(the Hopper kernels, forward and backward, on CUDA tensors; their plain
versions on CPU tensors), or with a mesh the sequence-parallel attention of
``ops/ring_attention.py``.  ``loss_fn`` is the next-token cross-entropy the
trainer takes.

With a mesh the forwards run per rank on the rank's local tokens: a
contiguous block of the sequence over the rules' "seq" axes (major to
minor), whose positions are offset by the block's start.  A dense
``attn_impl`` then attends over the sequence gathered over those axes
(``ring_attention.dense_attention``).  Parameters are whole on every
rank, unless the caller passes ``shards`` (``parallel.sharding.
LocalShards``, which the sharded train step builds): then each leaf is the
rank's local block, the ``fsdp``-split dims (and the vocab's tp split) are
all-gathered where they are used, a stacked layer's slice inside its
checkpoint so that remat gathers it again in the backward, and the
``LOCAL_AXES`` stay split over their group (one mesh axis or several):
Megatron's column-parallel wq / wk / wv and w_gate / w_up into the
row-parallel wo and w_down, with ``collectives.replicate`` at each block's
input and ``sum_replicated`` on its partial output, the attention over
the heads' group and the MLP over the mlp's.  The head counts and the MLP
width come from the weights' local shapes.  Where the KV heads are whole
while the query heads are split, each rank takes the KV heads its query
heads read.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from ray_tpu_torch.models.losses import chunked_softmax_xent
import torch.distributed as dist

from ray_tpu_torch.ops.ring_attention import SEQUENCE_PARALLEL, \
    dense_attention, sequence_parallel_attention
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import block_coords, live_axes, \
    to_partition_spec
from ray_tpu_torch.parallel.sharding import logical_spec as L


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True  # per-layer non-reentrant checkpoint in training
    loss_chunk: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(d_model=8192, n_layers=80, n_heads=64,
                           n_kv_heads=8, d_ff=28672)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """For tests."""
        return LlamaConfig(vocab_size=vocab_size, d_model=128, n_layers=2,
                           n_heads=4, n_kv_heads=2, d_ff=256,
                           max_seq_len=256, remat=False)

    @staticmethod
    def llama3_8b_dry(vocab_size: int = 512) -> "LlamaConfig":
        """The llama3_8b geometry ratios (4:1 GQA, 3.5x FFN, head_dim 32)
        at tiny scale."""
        return LlamaConfig(vocab_size=vocab_size, d_model=256, n_layers=4,
                           n_heads=8, n_kv_heads=2, d_ff=896,
                           max_seq_len=512, remat=True, loss_chunk=128)


# the logical axes a tensor-parallel forward keeps split over tp
LOCAL_AXES = ("heads", "kv_heads", "mlp")


def param_logical_specs(cfg: LlamaConfig):
    """Logical sharding spec tree, mirroring init()'s param tree."""
    layer = {
        "attn": {
            "wq": L("layers", "embed", "heads"),
            "wk": L("layers", "embed", "kv_heads"),
            "wv": L("layers", "embed", "kv_heads"),
            "wo": L("layers", "heads", "embed"),
        },
        "mlp": {
            "w_gate": L("layers", "embed", "mlp"),
            "w_up": L("layers", "embed", "mlp"),
            "w_down": L("layers", "mlp", "embed"),
        },
        "attn_norm": L("layers", "norm"),
        "mlp_norm": L("layers", "norm"),
    }
    return {
        "embed": L("vocab", "embed"),
        "layers": layer,
        "final_norm": L("norm",),
        "lm_head": L("embed", "vocab"),
    }


def init(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Dict:
    """Random f32 master weights with JAX ``init``'s scales and layout.

    Numbers come from ``generator`` (seed 0 on the target device when
    None); they differ from JAX's for the same seed.  Runs on CUDA unless
    ``device`` says otherwise, and raises where CUDA is missing."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, nl = cfg.d_model, cfg.n_layers
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * fan_in ** -0.5).to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    embed = dense((cfg.vocab_size, d), d) * (d ** 0.5) * 0.02
    layers = {
        "attn": {
            "wq": dense((nl, d, hq), d),
            "wk": dense((nl, d, hkv), d),
            "wv": dense((nl, d, hkv), d),
            "wo": dense((nl, hq, d), hq),
        },
        "mlp": {
            "w_gate": dense((nl, d, cfg.d_ff), d),
            "w_up": dense((nl, d, cfg.d_ff), d),
            "w_down": dense((nl, cfg.d_ff, d), cfg.d_ff),
        },
        "attn_norm": ones(nl, d),
        "mlp_norm": ones(nl, d),
    }
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": dense((d, cfg.vocab_size), d)}


def cast_weights(state: Dict, cfg: LlamaConfig) -> Dict:
    """The casts every forward makes on use, made once: every tensor but
    ``lm_head`` in ``cfg.dtype``.  The forwards' own ``.to(dtype)`` calls
    then return the tensor itself, so results are unchanged; ``lm_head``
    stays f32 because the cache-aware forwards use it in f32."""
    dt = torch_dtype(cfg.dtype)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key == "lm_head" else tree.to(dt)

    return walk(state)


def layer_params(layers: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked ``[n_layers, ...]`` tree (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    """Variance in f32; the result is cast back to x's dtype BEFORE the
    weight multiply, as in JAX."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, half-split rotation in f32; x: (..., seq, heads,
    head_dim), positions broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., s, d/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attention(attn_impl: str, mesh=None, rules: Optional[Dict] = None):
    """The attention ``(q, k, v, causal=...) -> out`` that ``attn_impl``
    names: dense "flash" (the kernels) or "plain", over the gathered
    sequence where the rules split it on ``mesh``, or with a mesh the
    sequence-parallel "ring", "zigzag" (the balanced ring) or "ulysses"."""
    if attn_impl in SEQUENCE_PARALLEL:
        if mesh is None:
            raise ValueError(f"attn_impl={attn_impl!r} requires a mesh")
        return functools.partial(sequence_parallel_attention, mesh=mesh,
                                 impl=attn_impl, rules=rules)
    return dense_attention(attn_impl, mesh, rules)


def _positions(seq: int, mesh, rules: Optional[Dict], device
               ) -> torch.Tensor:
    """(1, seq) global positions of the rank's tokens: its contiguous
    block of the sequence over the rules' "seq" axes, major to minor."""
    start = 0
    if mesh is not None:
        axes = live_axes(mesh, to_partition_spec(("seq",), rules)[0])
        start = block_coords(mesh, axes)[1] * seq
    return (start + torch.arange(seq, device=device))[None, :]


def _kv_weights(cfg, p, heads):
    """wk and wv, and where the KV heads are whole while the query heads
    are split over ``heads``, the columns of the KV heads this rank's query
    heads read.  The whole weights are then the same on every rank of the
    group and each rank reads a part, so their cotangents are summed over
    it (in f32, before the cast)."""
    wk, wv = p["attn"]["wk"], p["attn"]["wv"]
    hd = cfg.head_dim
    if heads is None:
        return wk, wv
    if p["attn"]["wq"].shape[-1] % hd or wk.shape[-1] % hd:
        raise ValueError("the rules split a head between ranks; split the "
                         "heads over fewer ranks")
    if wk.shape[-1] // hd != cfg.n_kv_heads:
        return wk, wv
    q_local = p["attn"]["wq"].shape[-1] // hd
    group = cfg.n_heads // cfg.n_kv_heads  # query heads per KV head
    if q_local % group and group % q_local:
        raise ValueError(f"{q_local} query heads per rank do not cover "
                         f"whole GQA groups of {group}")
    first = dist.get_rank(heads) * q_local
    lo, hi = first // group, (first + q_local - 1) // group + 1
    wk, wv = collectives.replicate(heads, wk, wv)
    return wk[..., lo * hd:hi * hd], wv[..., lo * hd:hi * hd]


def _attention_block(cfg, x, p, positions, attn, tp=None):
    """x plus the attention of its RMS-normed self: the first half of a
    layer, shared with ``models/moe.py``.  The heads are those of the
    weights given (a rank's local heads); with ``tp``, the group they are
    split over, the partial output is summed over it."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if tp is not None:
        (h,) = collectives.replicate(tp, h)
    wk, wv = (w.to(h.dtype) for w in _kv_weights(cfg, p, tp))
    wq = p["attn"]["wq"].to(h.dtype)
    q = (h @ wq).reshape(b, s, wq.shape[-1] // hd, hd)
    k = (h @ wk).reshape(b, s, wk.shape[-1] // hd, hd)
    v = (h @ wv).reshape(b, s, wv.shape[-1] // hd, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = attn(q, k, v, causal=True).reshape(b, s, wq.shape[-1])
    out = out @ p["attn"]["wo"].to(h.dtype)
    if tp is not None:
        out = collectives.sum_replicated(out, tp)
    return x + out


def _layer(cfg: LlamaConfig, x, p, positions, attn, shards=None):
    heads = tp = None
    if shards is not None:
        p = shards.gather(p, _LAYER_SPECS)
        heads, tp = shards.group("heads"), shards.group("mlp")
    x = _attention_block(cfg, x, p, positions, attn, heads)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if tp is not None:
        (h,) = collectives.replicate(tp, h)
    gate = F.silu(h @ p["mlp"]["w_gate"].to(h.dtype))
    up = h @ p["mlp"]["w_up"].to(h.dtype)
    out = (gate * up) @ p["mlp"]["w_down"].to(h.dtype)
    if tp is not None:
        out = collectives.sum_replicated(out, tp)
    return x + out


def layer_specs(specs: Dict) -> Dict:
    """A stacked layer's slice's logical specs: ``specs["layers"]``
    without the leading "layers" dim."""
    return {k: layer_specs(v) if isinstance(v, dict) else v[1:]
            for k, v in specs.items()}


_SPECS = param_logical_specs(LlamaConfig())
_LAYER_SPECS = layer_specs(_SPECS["layers"])


def _whole(state: Dict, key: str, shards, specs: Dict = _SPECS
           ) -> torch.Tensor:
    """A top-level leaf, all-gathered where ``shards`` says it is split
    (by ``specs``, the model's spec tree)."""
    if shards is None:
        return state[key]
    return shards.gather(state[key], specs[key])


def trunk(state: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
          attn_impl: str = "flash", mesh=None,
          rules: Optional[Dict] = None, shards=None) -> torch.Tensor:
    """Embeddings -> final RMS norm, without the LM head: (b, s, d).
    ``attn_impl`` "flash" is the kernel path; "plain" runs the plain
    attention on any device (what the kernel is held against); "ring",
    "zigzag" and "ulysses" need ``mesh`` (``_attention``).  With
    ``cfg.remat`` each layer runs under a non-reentrant checkpoint while
    gradients are being recorded (``jax.checkpoint`` in JAX).  ``shards``:
    the parameters are the rank's local blocks (module docstring)."""
    attn = _attention(attn_impl, mesh, rules)
    x = _whole(state, "embed", shards)[tokens].to(torch_dtype(cfg.dtype))
    positions = _positions(tokens.shape[1], mesh, rules, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = layer_params(state["layers"], i)
        if remat:
            x = checkpoint(_layer, cfg, x, p, positions, attn, shards,
                           use_reentrant=False)
        else:
            x = _layer(cfg, x, p, positions, attn, shards)
    return rms_norm(x, state["final_norm"], cfg.norm_eps)


def apply(state: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
          attn_impl: str = "flash", mesh=None,
          rules: Optional[Dict] = None, shards=None) -> torch.Tensor:
    """Forward pass: tokens (batch, seq) int -> logits (batch, seq, vocab)
    f32.  The LM head takes operands rounded to ``cfg.dtype`` and
    accumulates in f32 (a product of two bf16 values is exact in f32)."""
    x = trunk(state, tokens, cfg, attn_impl, mesh, rules, shards)
    return x.float() @ _whole(state, "lm_head", shards).to(x.dtype).float()


def loss_fn(state: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
            attn_impl: str = "flash", mesh=None,
            rules: Optional[Dict] = None, shards=None) -> torch.Tensor:
    """Next-token cross-entropy of tokens (batch, seq + 1), with the head
    product in ``cfg.dtype`` and f32 logits, chunked by ``cfg.loss_chunk``
    (``models/losses.py``): the mean over these tokens, which with a mesh
    are the rank's own."""
    x = trunk(state, tokens[:, :-1], cfg, attn_impl, mesh, rules, shards)
    return chunked_softmax_xent(x, _whole(state, "lm_head", shards),
                                tokens[:, 1:], chunk=cfg.loss_chunk)
