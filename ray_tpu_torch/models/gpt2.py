"""GPT-2 decoder LM in PyTorch: the 124M trainer's model.

Counterpart of ``ray_tpu/models/gpt2.py``.  Parameters are a nested dict
of f32 tensors with the same keys and the same stacked ``[n_layers, ...]``
layout as the JAX tree, so JAX parameters load unchanged
(``ray_tpu_torch.convert.gpt2_params_from_jax``).  Learned positional
embeddings, pre-LN, tanh-approximate GELU MLP, and the LM head tied to
``wte``.  Matmul weights and biases are cast to ``cfg.dtype`` where they
are used, as in JAX.  Attention goes through ``ops.attention.ATTENTION``:
"flash" runs the Hopper kernels forward and backward on CUDA tensors and
their plain versions on CPU tensors.  ``param_logical_specs`` names each
parameter's axes for ``parallel.sharding``.

With ``shards`` (``parallel.sharding.LocalShards``, which the sharded train
step builds) each leaf is the rank's local block.  The MLP stays split over
tp (``LOCAL_AXES``): column-parallel ``w_in`` / ``b_in`` into the
row-parallel ``w_out``, whose partial output is summed over the group
before ``b_out`` is added once.  Every other split dim is all-gathered
where it is used.  That includes the heads: the fused ``wqkv`` is one
``(d, 3d)`` leaf, and a tp rank's block of its columns is not a whole set
of heads.  The tied ``wte`` is gathered once and serves as both the
embedding and the head, so its gradient flows back through one gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from ray_tpu_torch.models.llama import _whole, layer_params, layer_specs
from ray_tpu_torch.models.losses import chunked_softmax_xent, head_logits
from ray_tpu_torch.ops.attention import ATTENTION
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import logical_spec as L


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = False
    # sequence-chunked cross-entropy (models/losses.py); 0 disables chunking
    loss_chunk: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "GPT2Config":
        return GPT2Config(vocab_size=vocab_size, d_model=64, n_layers=2,
                          n_heads=2, max_seq_len=128)


# the logical axes a tensor-parallel forward keeps split over tp
LOCAL_AXES = ("mlp",)


def param_logical_specs(cfg: GPT2Config):
    """Logical sharding spec tree, mirroring init()'s param tree."""
    layer = {
        "attn": {
            "wqkv": L("layers", "embed", "heads"),
            "bqkv": L("layers", "heads"),
            "wo": L("layers", "heads", "embed"),
            "bo": L("layers", "norm"),
        },
        "mlp": {
            "w_in": L("layers", "embed", "mlp"),
            "b_in": L("layers", "mlp"),
            "w_out": L("layers", "mlp", "embed"),
            "b_out": L("layers", "norm"),
        },
        "ln1_g": L("layers", "norm"),
        "ln1_b": L("layers", "norm"),
        "ln2_g": L("layers", "norm"),
        "ln2_b": L("layers", "norm"),
    }
    return {
        "wte": L("vocab", "embed"),
        "wpe": L(None, "embed"),
        "layers": layer,
        "lnf_g": L("norm",),
        "lnf_b": L("norm",),
    }


def init(cfg: GPT2Config, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Dict:
    """Random f32 master weights with JAX ``init``'s scales and layout:
    normal(0.02) weights, residual-out projections at 0.02 / sqrt(2 *
    n_layers), ``wpe`` at 0.01, zero biases, unit layer-norm gains.

    Numbers come from ``generator`` (seed 0 on the target device when
    None); they differ from JAX's for the same seed.  Runs on CUDA unless
    ``device`` says otherwise, and raises where CUDA is missing."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, nl, ff = cfg.d_model, cfg.n_layers, cfg.d_ff

    def dense(shape, std=0.02):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * std).to(dev)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    res_std = 0.02 / (2 * nl) ** 0.5
    wte = dense((cfg.vocab_size, d))
    wpe = dense((cfg.max_seq_len, d), 0.01)
    layers = {
        "attn": {
            "wqkv": dense((nl, d, 3 * d)),
            "bqkv": const(0.0, nl, 3 * d),
            "wo": dense((nl, d, d), res_std),
            "bo": const(0.0, nl, d),
        },
        "mlp": {
            "w_in": dense((nl, d, ff)),
            "b_in": const(0.0, nl, ff),
            "w_out": dense((nl, ff, d), res_std),
            "b_out": const(0.0, nl, d),
        },
        "ln1_g": const(1.0, nl, d),
        "ln1_b": const(0.0, nl, d),
        "ln2_g": const(1.0, nl, d),
        "ln2_b": const(0.0, nl, d),
    }
    return {"wte": wte, "wpe": wpe, "layers": layers,
            "lnf_g": const(1.0, d), "lnf_b": const(0.0, d)}


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Statistics in f32; ``out * g + b`` is cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * g + b).to(x.dtype)


def _layer(cfg: GPT2Config, x: torch.Tensor, p: Dict, attn,
           shards=None) -> torch.Tensor:
    tp = None
    if shards is not None:
        p = shards.gather(p, _LAYER_SPECS)
        tp = shards.group("mlp")
    b, s, d = x.shape
    dt = x.dtype
    h = layer_norm(x, p["ln1_g"], p["ln1_b"], cfg.norm_eps)
    qkv = h @ p["attn"]["wqkv"].to(dt) + p["attn"]["bqkv"].to(dt)
    shape = (b, s, cfg.n_heads, cfg.head_dim)
    q, k, v = (t.reshape(shape) for t in qkv.split(d, dim=-1))
    out = attn(q, k, v, causal=True).reshape(b, s, d)
    x = x + out @ p["attn"]["wo"].to(dt) + p["attn"]["bo"].to(dt)
    h = layer_norm(x, p["ln2_g"], p["ln2_b"], cfg.norm_eps)
    if tp is not None:
        (h,) = collectives.replicate(tp, h)
    h = F.gelu(h @ p["mlp"]["w_in"].to(dt) + p["mlp"]["b_in"].to(dt),
               approximate="tanh")
    out = h @ p["mlp"]["w_out"].to(dt)
    if tp is not None:
        out = collectives.sum_replicated(out, tp)
    return x + out + p["mlp"]["b_out"].to(dt)


_SPECS = param_logical_specs(GPT2Config())
_LAYER_SPECS = layer_specs(_SPECS["layers"])


def _trunk(params: Dict, wte: torch.Tensor, tokens: torch.Tensor,
           cfg: GPT2Config, attn_impl: str, mesh, shards) -> torch.Tensor:
    if mesh_axis_size(mesh, "sp") > 1:
        raise ValueError("GPT-2 attends over the whole sequence; the mesh "
                         "splits it over sp")
    attn = ATTENTION[attn_impl]
    s = tokens.shape[1]
    wpe = _whole(params, "wpe", shards, _SPECS)
    x = (wte[tokens] + wpe[:s][None]).to(torch_dtype(cfg.dtype))
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        if remat:
            x = checkpoint(_layer, cfg, x, p, attn, shards,
                           use_reentrant=False)
        else:
            x = _layer(cfg, x, p, attn, shards)
    return layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.norm_eps)


def trunk(params: Dict, tokens: torch.Tensor, cfg: GPT2Config,
          attn_impl: str = "flash", mesh=None, rules: Optional[Dict] = None,
          shards=None) -> torch.Tensor:
    """Embeddings -> final layer norm, without the LM head: (b, s, d).
    With ``cfg.remat`` each layer runs under a non-reentrant checkpoint
    while gradients are being recorded (``jax.checkpoint`` in JAX).
    ``shards``: the parameters are the rank's local blocks (module
    docstring).  ``mesh`` and ``rules`` are what the sharded step passes
    every model; the sequence is attended whole, so a mesh that splits it
    over sp raises."""
    wte = _whole(params, "wte", shards, _SPECS)
    return _trunk(params, wte, tokens, cfg, attn_impl, mesh, shards)


def apply(params: Dict, tokens: torch.Tensor, cfg: GPT2Config,
          attn_impl: str = "flash", mesh=None, rules: Optional[Dict] = None,
          shards=None) -> torch.Tensor:
    """Forward pass: tokens (batch, seq) int -> f32 logits (batch, seq,
    vocab) through the head tied to ``wte``, with operands in
    ``cfg.dtype``."""
    wte = _whole(params, "wte", shards, _SPECS)
    x = _trunk(params, wte, tokens, cfg, attn_impl, mesh, shards)
    return head_logits(x, wte.t())


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: GPT2Config,
            attn_impl: str = "flash", mesh=None, rules: Optional[Dict] = None,
            shards=None) -> torch.Tensor:
    """Next-token cross-entropy of tokens (batch, seq + 1): the mean over
    these tokens, which with a mesh are the rank's own."""
    wte = _whole(params, "wte", shards, _SPECS)
    x = _trunk(params, wte, tokens[:, :-1], cfg, attn_impl, mesh, shards)
    return chunked_softmax_xent(x, wte.t(), tokens[:, 1:],
                                chunk=cfg.loss_chunk)
