"""Mixtral-family sparse MoE decoder LM with expert parallelism, in PyTorch.

Counterpart of ``ray_tpu/models/moe.py``.  Parameters are a nested dict of
f32 tensors with the JAX tree's keys and stacked ``[n_layers, ...]``
layout (``ray_tpu_torch.convert.moe_params_from_jax`` loads JAX's).  Token
dispatch and combine are dense einsums against a static-capacity one-hot
dispatch tensor (GShard-style): top-k routing, capacity dropping and
combine are static-shape products, with no ragged gathers.

Attention, norm and rope are the Llama block's (``models/llama.py``), so
attention runs through ``llama._attention``: with no mesh,
``flash_attention`` (the Hopper kernels on CUDA tensors).

Expert parallelism: with a mesh whose ``ep`` axis (the rules' "experts"
entry) is larger than 1, each rank's expert leaves hold its E/ep experts,
the local shard along their "experts" axis.  The tokens are the same on
every rank of an ``ep`` group (the default rules shard batch over
dcn/dp/fsdp, not ep), so each rank computes the routing, runs its own
experts on its slice of dispatch and combine, and the partial outputs are
summed over the group: what XLA emits for the JAX package's sharding.

With ``shards`` (``parallel.sharding.LocalShards``, which the sharded
train step builds) each leaf is the rank's local block: attention runs
through the Llama block with its heads split over tp, the experts stay
split over ep (``LOCAL_AXES``), and every other split dim, the experts'
MLP width included, is all-gathered where it is used.  The batch is then
split over the data axes, and JAX's GSPMD routes the global token set:
capacity, each token's place in its expert's buffer and the aux loss's
``f`` and ``p`` are all reckoned over every token.  So the router logits
are all-gathered over the data axes in JAX's ``(B, S)`` order, the global
routing is computed on every rank, and each rank keeps its own tokens'
rows of ``dispatch`` and ``combine``.  A capacity slot holds at most one
token, so those rows pick exactly the rank's tokens' slots and no token
exchange is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from ray_tpu_torch.models.llama import _attention, _attention_block, \
    _positions, _whole, layer_params, layer_specs, rms_norm
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import logical_spec as L
from ray_tpu_torch.parallel.sharding import to_partition_spec


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    max_seq_len: int = 32768
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "MoEConfig":
        return MoEConfig(vocab_size=vocab_size, d_model=128, n_layers=2,
                         n_heads=4, n_kv_heads=2, d_ff=256, n_experts=4,
                         experts_per_token=2, max_seq_len=256, remat=False)


# the logical axes a sharded forward keeps split: the attention's heads over
# tp, the experts over ep
LOCAL_AXES = ("heads", "kv_heads", "experts")


def param_logical_specs(cfg: MoEConfig):
    """Logical sharding spec tree, mirroring init()'s param tree."""
    layer = {
        "attn": {
            "wq": L("layers", "embed", "heads"),
            "wk": L("layers", "embed", "kv_heads"),
            "wv": L("layers", "embed", "kv_heads"),
            "wo": L("layers", "heads", "embed"),
        },
        "router": L("layers", "embed", None),
        "experts": {
            "w_gate": L("layers", "experts", "embed", "expert_mlp"),
            "w_up": L("layers", "experts", "embed", "expert_mlp"),
            "w_down": L("layers", "experts", "expert_mlp", "embed"),
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


def init(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Dict:
    """Random f32 master weights with JAX ``init``'s scales and layout.

    Numbers come from ``generator`` (seed 0 on the target device when
    None); they differ from JAX's for the same seed.  Runs on CUDA unless
    ``device`` says otherwise, and raises where CUDA is missing."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, nl, ne = cfg.d_model, cfg.n_layers, cfg.n_experts
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
        "router": dense((nl, d, ne), d),
        "experts": {
            "w_gate": dense((nl, ne, d, cfg.d_ff), d),
            "w_up": dense((nl, ne, d, cfg.d_ff), d),
            "w_down": dense((nl, ne, cfg.d_ff, d), cfg.d_ff),
        },
        "attn_norm": ones(nl, d),
        "mlp_norm": ones(nl, d),
    }
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": dense((d, cfg.vocab_size), d)}


def expert_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Static per-expert token capacity, rounded up to a multiple of 8."""
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(cfg: MoEConfig, xf: torch.Tensor, router_w: torch.Tensor
          ) -> Dict[str, torch.Tensor]:
    """Top-k routing of tokens xf (N, D) with capacity dropping.

    Returns ``probs`` (N, E) f32 router probabilities, ``top_idx`` (N, k)
    the chosen experts (descending probability), ``keep`` (N, k) whether
    each choice fits its expert's capacity, ``dispatch`` (N, E, C) 0/1 and
    ``combine`` (N, E, C) the renormalised top-k weights at the dispatched
    slots, both f32."""
    return route_logits(cfg, xf.float() @ router_w.float())


def route_logits(cfg: MoEConfig, logits: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """``route`` from the f32 router logits (N, E)."""
    n = logits.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = expert_capacity(cfg, n)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)  # (N, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # Mixtral renorm

    # Position of each (token, choice) in its expert's buffer.  Priority is
    # choice-major (all first choices before any second choice) so a
    # token's primary expert wins capacity contention.
    choice = F.one_hot(top_idx, e).float()  # (N, k, E)
    flat = choice.transpose(0, 1).reshape(k * n, e)
    pos_flat = torch.cumsum(flat, dim=0) - flat  # (k*N, E)
    pos = pos_flat.reshape(k, n, e).transpose(0, 1)  # (N, k, E)
    pos_in_expert = (pos * choice).sum(dim=-1)  # (N, k)
    keep = pos_in_expert < cap  # capacity drop mask

    # jax.nn.one_hot gives an all-zero row at or past capacity, where
    # F.one_hot raises: clamp, and let keep zero those rows.
    slot = F.one_hot(pos_in_expert.long().clamp(max=cap - 1), cap).float()
    kept = choice * keep[..., None].float()  # (N, k, E)
    dispatch = torch.einsum("nke,nkc->nec", kept, slot)
    # each expert appears at most once among a token's k choices, so its
    # weight is the one top_p that chose it
    gate = (choice * top_p[..., None]).sum(dim=1)  # (N, E)
    combine = dispatch * gate[..., None]
    return {"probs": probs, "top_idx": top_idx, "keep": keep,
            "dispatch": dispatch, "combine": combine}


def _ep_axis(mesh, rules: Optional[Dict]) -> Optional[str]:
    """The mesh axis the experts are sharded over, or None for none."""
    axis = to_partition_spec(("experts",), rules)[0]
    if axis is None or mesh is None:
        return None
    if not isinstance(axis, str):
        raise ValueError(f"experts sharded over {axis}: expert parallelism "
                         "takes one mesh axis")
    return axis if mesh_axis_size(mesh, axis) > 1 else None


def _global_logits(shards, logits: torch.Tensor):
    """The router logits of the whole batch from every rank's (b, s, E)
    block, flattened in JAX's (B, S) order, and the rows of the rank's own
    tokens in it; ``(logits flattened, None)`` where the batch is whole.
    Each sequence's blocks are gathered over the seq axis, then the batch
    blocks over the batch axes, minor axis first (``LocalShards.gather``'s
    order), so the blocks land major to minor."""
    b, s, e = logits.shape
    batch_axes, seq_axes = shards.data_axes()
    if not batch_axes and not seq_axes:
        return logits.reshape(b * s, e), None
    mesh = shards.mesh
    row0, col0 = 0, 0
    for axis in reversed(seq_axes):
        col0 += mesh.get_local_rank(axis) * logits.shape[1]
        logits = collectives.all_gather(logits, mesh.get_group(axis), 1)
    for axis in reversed(batch_axes):
        row0 += mesh.get_local_rank(axis) * logits.shape[0]
        logits = collectives.all_gather(logits, mesh.get_group(axis), 0)
    big_b, big_s = logits.shape[:2]
    rows = torch.arange(row0, row0 + b, device=logits.device)[:, None] \
        * big_s + torch.arange(col0, col0 + s, device=logits.device)
    return logits.reshape(big_b * big_s, e), rows.reshape(-1)


def moe_mlp(cfg: MoEConfig, x: torch.Tensor, router_w: torch.Tensor,
            experts: Dict, mesh=None, rules: Optional[Dict] = None,
            shards=None):
    """Top-k routed expert MLP.  x: (B, S, D) -> (out (B, S, D), aux_loss).

    Tokens over an expert's capacity are dropped (their residual stream
    passes through unchanged), as in GShard/Switch.  The router is f32;
    dispatch and combine are cast to x's dtype before the expert products.
    With expert parallelism (module docstring) ``experts`` holds the rank's
    experts and the output is the sum of every rank's partial one; with
    ``shards`` x is the rank's block of the batch, routed with the whole
    batch (module docstring)."""
    b, s, d = x.shape
    e = cfg.n_experts
    xf = x.reshape(b * s, d)
    logits = xf.float() @ router_w.float()
    rows = None
    if shards is not None:
        # the gather's backward sums every rank's cotangents: each rank's
        # copy of the aux term feeds the router gradient, which the step's
        # 1 / n_data scale makes the mean
        logits, rows = _global_logits(shards, logits.reshape(b, s, e))
    r = route_logits(cfg, logits)
    dispatch, combine = r["dispatch"], r["combine"]
    if rows is not None:
        dispatch, combine = dispatch[rows], combine[rows]

    e_local = experts["w_gate"].shape[0]
    axis = _ep_axis(mesh, rules)
    ep = mesh_axis_size(mesh, axis) if axis else 1
    if e_local * ep != e:
        raise ValueError(f"{e_local} experts per rank over ep {ep} != "
                         f"n_experts {e}")
    x_in = xf
    if axis:
        group = mesh.get_group(axis)
        # every rank holds the tokens and the routing alike; its experts
        # read them, so their cotangents are summed over the group
        x_in, combine = collectives.replicate(group, xf, combine)
        lo = mesh.get_local_rank(axis) * e_local
        dispatch = dispatch[:, lo:lo + e_local]
        combine = combine[:, lo:lo + e_local]

    cdt = x.dtype
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cdt), x_in)
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                               experts["w_gate"].to(cdt)))
    up = torch.einsum("ecd,edf->ecf", expert_in, experts["w_up"].to(cdt))
    expert_out = torch.einsum("ecf,efd->ecd", gate * up,
                              experts["w_down"].to(cdt))
    out = torch.einsum("nec,ecd->nd", combine.to(cdt), expert_out)
    if axis:
        out = collectives.sum_replicated(out, group)

    # Switch-style load-balancing auxiliary loss: E * sum_e f_e * p_e where
    # f_e = fraction of tokens whose TOP choice is e, p_e = mean router
    # prob; from the full routing, so the same on every rank.
    f = F.one_hot(r["top_idx"][:, 0], e).float().mean(dim=0)
    p = r["probs"].mean(dim=0)
    aux = e * (f * p).sum()
    return out.reshape(b, s, d), aux


def _layer(cfg: MoEConfig, x, p, positions, attn, mesh, rules, shards=None):
    tp = None
    if shards is not None:
        p = shards.gather(p, _LAYER_SPECS)
        tp = shards.group("heads")
    x = _attention_block(cfg, x, p, positions, attn, tp)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    moe_out, aux = moe_mlp(cfg, h, p["router"], p["experts"], mesh, rules,
                           shards)
    return x + moe_out, aux


_SPECS = param_logical_specs(MoEConfig())
_LAYER_SPECS = layer_specs(_SPECS["layers"])


def apply(params: Dict, tokens: torch.Tensor, cfg: MoEConfig,
          attn_impl: str = "flash", mesh=None, rules: Optional[Dict] = None,
          return_aux: bool = False, shards=None):
    """Forward: tokens (B, S) -> f32 logits (B, S, vocab) [, aux_loss
    averaged over the layers].  The LM head is an f32 product of the f32
    activations, as in JAX.  With ``cfg.remat`` each layer runs under a
    non-reentrant checkpoint while gradients are being recorded.
    ``shards``: the parameters are the rank's local blocks and the tokens
    its block of the batch (module docstring)."""
    embed = _whole(params, "embed", shards, _SPECS)
    x = embed[tokens].to(torch_dtype(cfg.dtype))
    positions = _positions(tokens.shape[1], mesh, tokens.device)
    attn = _attention(attn_impl, mesh, rules)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        if remat:
            x, a = checkpoint(_layer, cfg, x, p, positions, attn, mesh,
                              rules, shards, use_reentrant=False)
        else:
            x, a = _layer(cfg, x, p, positions, attn, mesh, rules, shards)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x.float() @ _whole(params, "lm_head", shards, _SPECS)
    aux = aux / cfg.n_layers
    return (logits, aux) if return_aux else logits


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: MoEConfig,
            attn_impl: str = "flash", mesh=None,
            rules: Optional[Dict] = None, shards=None) -> torch.Tensor:
    """Next-token cross-entropy of tokens (B, S + 1) plus
    ``aux_loss_weight`` times the load-balancing aux loss: the mean over
    these tokens, which with ``shards`` are the rank's own, and the aux
    loss of the whole batch."""
    logits, aux = apply(params, tokens[:, :-1], cfg, attn_impl, mesh=mesh,
                        rules=rules, return_aux=True, shards=shards)
    targets = tokens[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - gold).mean() + cfg.aux_loss_weight * aux
