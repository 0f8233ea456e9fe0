"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``ray_tpu/ops/ring_attention.py``.  Every function takes the
rank's local shards, which is what ``shard_map`` hands the JAX package's
``local``: q (batch, seq_local, heads, head_dim) and k/v (batch, seq_local,
kv_heads, head_dim), the sequence split over the mesh's ``sp`` axis in
contiguous blocks (rank ``i`` of the axis holds ``[i*s, (i+1)*s)``).

* ``ring_attention`` rotates K/V around the ``sp`` group
  (``parallel.collectives.rotate``, the counterpart of ``ppermute``) while
  each rank folds every block into an online-softmax accumulator for its
  local queries.  Plain torch ops in f32, as the JAX package's einsums;
  masks compare global positions, so causality across ring steps is exact.
* ``ulysses_attention`` swaps the sharded dim from sequence to heads with
  one all-to-all, runs ``flash_attention`` (the Hopper kernels on CUDA
  tensors) on the full sequence for heads/sp heads, and swaps back.

Gradients are autograd through the collectives' Functions: the ring's
backward is the reverse rotation, Ulysses' the reverse all-to-all.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import NEG_INF, flash_attention, \
    repeat_kv_heads
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import to_partition_spec

# the impls of sequence_parallel_attention, which shard the sequence over
# the mesh's sp axis
SEQUENCE_PARALLEL = ("ring", "zigzag", "ulysses")


def _shard_positions(idx: int, s_loc: int, sp: int, layout: str,
                     device=None) -> torch.Tensor:
    """Global sequence positions held by ring shard ``idx``.

    contiguous: shard i holds [i*s_loc, (i+1)*s_loc).
    zigzag: shard i holds the PAIR of chunks (i, 2*sp-1-i), each of size
    s_loc/2, so every shard owns one early and one late chunk and the
    unmasked area each shard computes per ring step is near-uniform."""
    if layout == "zigzag":
        c = s_loc // 2
        lo = idx * c + torch.arange(c, device=device)
        hi = (2 * sp - 1 - idx) * c + torch.arange(c, device=device)
        return torch.cat([lo, hi])
    return idx * s_loc + torch.arange(s_loc, device=device)


def zigzag_permutation(seq: int, sp: int):
    """Index arrays mapping contiguous -> zigzag layout and back.

    zigzag layout order: shard 0's chunks (0, 2sp-1), shard 1's (1, 2sp-2),
    ...  ``perm`` gathers a contiguous-layout sequence axis into zigzag
    order (``x_zig = x[:, perm]``); ``inv`` undoes it."""
    c = seq // (2 * sp)
    order = []
    for i in range(sp):
        order.append(np.arange(i * c, (i + 1) * c))
        order.append(np.arange((2 * sp - 1 - i) * c, (2 * sp - i) * c))
    perm = np.concatenate(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq)
    return perm, inv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   layout: str = "contiguous") -> torch.Tensor:
    """Ring attention over the ranks of ``group`` (the ``sp`` sub-group).

    Local shapes: q (batch, seq_local, heads, head_dim), k/v (batch,
    seq_local, kv_heads, head_dim).  Global sequence = seq_local * ring
    size; ``layout`` names how global positions map onto shards
    (``_shard_positions``).  K/V rotate "upward" (rank i sends to i+1) in
    their raw GQA form; heads are repeated locally per block.  Returns
    (batch, seq_local, heads, head_dim) in q's dtype."""
    sp = dist.get_world_size(group)
    idx = dist.get_rank(group)
    b, s_loc, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.float() * sm_scale
    rows = _shard_positions(idx, s_loc, sp, layout, q.device)

    def block(k_cur, v_cur, src, acc, m_prev, l_prev):
        """Fold one KV shard (originally at ring position src) into the
        online-softmax accumulator."""
        k_rep, v_rep = repeat_kv_heads(k_cur, v_cur, h)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_rep.float())
        if causal:
            cols = _shard_positions(src, s_loc, sp, layout, q.device)
            mask = rows[:, None] >= cols[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m_prev, s.amax(dim=-1))  # (b, h, q)
        # A fully masked block keeps m == NEG_INF; exp(s - m) would be 1
        # for every masked entry, so zero them explicitly.
        p = torch.where(s <= NEG_INF / 2, 0.0,
                        torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m_prev - m_new)
        l_new = l_prev * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_rep.float())
        return acc, m_new, l_new

    acc = q.new_zeros((b, h, s_loc, d), dtype=torch.float32)
    m = q.new_full((b, h, s_loc), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, s_loc), dtype=torch.float32)
    # the first sp-1 steps each end with a rotation; the last shard is
    # folded after the loop so no rotation result is discarded
    for t in range(sp - 1):
        acc, m, l = block(k, v, (idx - t) % sp, acc, m, l)
        k = collectives.rotate(k, group)
        v = collectives.rotate(v, group)
    acc, m, l = block(k, v, (idx - (sp - 1)) % sp, acc, m, l)

    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]  # (b, h, q, d)
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, *, causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses sequence parallelism over ``group``: an all-to-all swaps the
    sharded dim from sequence to heads, ``flash_attention`` runs on the
    full sequence for heads/sp heads, and the reverse all-to-all restores
    sequence sharding.  Local q: (batch, seq_local, heads, head_dim);
    requires heads % ring size == 0."""
    sp = dist.get_world_size(group)
    h = q.shape[2]
    if h % sp != 0:
        raise ValueError(f"ulysses needs heads ({h}) % sp ({sp}) == 0")

    def fwd(x):  # (b, s/sp, h, d) -> (b, s, h/sp, d)
        return collectives.all_to_all(x, group, split_dim=2, concat_dim=1)

    # When the kv_heads dim itself splits over sp, swap the raw GQA K/V
    # (fewer bytes); flash_attention reads the groups in place.
    if k.shape[2] % sp != 0:
        k, v = repeat_kv_heads(k, v, h)
    out = flash_attention(fwd(q), fwd(k), fwd(v), causal=causal,
                          sm_scale=sm_scale)
    # (b, s, h/sp, d) -> (b, s/sp, h, d)
    return collectives.all_to_all(out, group, split_dim=1, concat_dim=2)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mesh, *,
                                impl: str = "ring", causal: bool = True,
                                sm_scale: Optional[float] = None,
                                rules: Optional[dict] = None,
                                sp_axis: str = "sp") -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``sp_axis`` on the
    rank's local shards (contiguous sequence blocks over ``sp_axis``; batch
    and heads as the caller's layout has them).  At sp 1 it is
    ``flash_attention(q, k, v)``.

    impl: "ring", "ulysses", or "zigzag", the causal-balanced ring: the
    shards are gathered into zigzag order with ``perm`` (each rank then
    holds one early and one late chunk), the balanced ring runs, and the
    output is gathered back with ``inv``.  The rules' "seq" entry must be
    ``sp_axis``, where the shards lie."""
    if mesh_axis_size(mesh, sp_axis) == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl not in SEQUENCE_PARALLEL:
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    seq_axis = to_partition_spec(("batch", "seq", "heads", "head_dim"),
                                 rules)[1]
    if seq_axis != sp_axis:
        raise ValueError(f"the rules shard seq over {seq_axis!r}, but the "
                         f"ring runs over {sp_axis!r}")
    group = mesh.get_group(sp_axis)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, group, causal=causal,
                                 sm_scale=sm_scale)
    if impl == "ring":
        return ring_attention(q, k, v, group, causal=causal,
                              sm_scale=sm_scale)

    sp, s_loc = mesh_axis_size(mesh, sp_axis), q.shape[1]
    seq, idx = sp * s_loc, mesh.get_local_rank(sp_axis)
    if seq % (2 * sp) != 0:
        raise ValueError(f"zigzag needs seq ({seq}) % 2*sp ({2 * sp}) == 0")
    perm, inv = (torch.from_numpy(a).to(q.device)
                 for a in zigzag_permutation(seq, sp))
    mine = slice(idx * s_loc, (idx + 1) * s_loc)

    def regather(x, order):  # the global take, on this rank's block
        full = collectives.all_gather(x, group, dim=1)
        return full.index_select(1, order[mine])

    q, k, v = (regather(x, perm) for x in (q, k, v))
    out = ring_attention(q, k, v, group, causal=causal, sm_scale=sm_scale,
                         layout="zigzag")
    return regather(out, inv)
