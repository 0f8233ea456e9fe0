"""Llama-family decoder LM in PyTorch.

Counterpart of ``ray_tpu/models/llama.py``.  Parameters are a nested dict
of tensors with the same keys and the same stacked ``[n_layers, ...]``
layout as the JAX tree, so JAX parameters load unchanged
(``ray_tpu_torch.convert``).  Master weights are f32; matmul weights and
norms are cast to ``cfg.dtype`` where they are used, as in JAX.
Attention goes through ``ops.attention.flash_attention`` (the Hopper
kernels, forward and backward, on CUDA tensors; their plain versions on CPU
tensors).  ``loss_fn`` is the next-token cross-entropy the trainer takes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from ray_tpu_torch.models.losses import chunked_softmax_xent
from ray_tpu_torch.ops.attention import ATTENTION


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


def _layer(cfg: LlamaConfig, x, p, positions, attn):
    b, s, _ = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = (h @ p["attn"]["wq"].to(h.dtype)).reshape(
        b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["attn"]["wk"].to(h.dtype)).reshape(
        b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["attn"]["wv"].to(h.dtype)).reshape(
        b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = attn(q, k, v, causal=True).reshape(b, s, cfg.n_heads * cfg.head_dim)
    x = x + out @ p["attn"]["wo"].to(h.dtype)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ p["mlp"]["w_gate"].to(h.dtype))
    up = h @ p["mlp"]["w_up"].to(h.dtype)
    return x + (gate * up) @ p["mlp"]["w_down"].to(h.dtype)


def trunk(state: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
          attn_impl: str = "flash") -> torch.Tensor:
    """Embeddings -> final RMS norm, without the LM head: (b, s, d).
    ``attn_impl`` "flash" is the kernel path; "plain" runs the plain
    attention on any device (what the kernel is held against).  With
    ``cfg.remat`` each layer runs under a non-reentrant checkpoint while
    gradients are being recorded (``jax.checkpoint`` in JAX)."""
    attn = ATTENTION[attn_impl]
    x = state["embed"][tokens].to(torch_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = layer_params(state["layers"], i)
        if remat:
            x = checkpoint(_layer, cfg, x, p, positions, attn,
                           use_reentrant=False)
        else:
            x = _layer(cfg, x, p, positions, attn)
    return rms_norm(x, state["final_norm"], cfg.norm_eps)


def apply(state: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
          attn_impl: str = "flash") -> torch.Tensor:
    """Forward pass: tokens (batch, seq) int -> logits (batch, seq, vocab)
    f32.  The LM head takes operands rounded to ``cfg.dtype`` and
    accumulates in f32 (a product of two bf16 values is exact in f32)."""
    x = trunk(state, tokens, cfg, attn_impl)
    return x.float() @ state["lm_head"].to(x.dtype).float()


def loss_fn(state: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
            attn_impl: str = "flash") -> torch.Tensor:
    """Next-token cross-entropy of tokens (batch, seq + 1), with the head
    product in ``cfg.dtype`` and f32 logits, chunked by ``cfg.loss_chunk``
    (``models/losses.py``)."""
    x = trunk(state, tokens[:, :-1], cfg, attn_impl)
    return chunked_softmax_xent(x, state["lm_head"], tokens[:, 1:],
                                chunk=cfg.loss_chunk)
