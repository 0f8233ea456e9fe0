"""Differentiable collectives over a process group, for per-rank SPMD code.

The JAX package differentiates through ``lax.ppermute``, ``psum`` and
``all_to_all`` inside ``shard_map``; here each is a
``torch.autograd.Function`` whose backward is the transpose:

* ``rotate`` sends to the next rank of the group and receives from the
  previous one (``ppermute`` with ``i -> i + shift``); its gradient rotates
  the other way.
* ``all_to_all`` splits one dim over the group and concatenates what it
  receives along another (``all_to_all(..., tiled=True)``); its gradient is
  the reverse exchange.
* ``all_gather`` concatenates every rank's block along a dim; its gradient
  sums every rank's cotangent of the result and keeps the rank's own block.
* ``sum_replicated`` sums over the group a value that every rank then uses
  in the same way (a ``psum`` whose result is replicated over the axis):
  each rank already holds the whole cotangent, so it passes through.
* ``replicate`` hands a value every rank holds to work split over the
  group: the value is unchanged and its cotangents, partial on each rank,
  are summed.

Every rank of the group must make the same calls in the same order, in the
forward and in the backward: each function's result feeds the loss on every
rank, so autograd runs every backward exchange on every rank.  A failed
collective raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _exchange(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _swap(x: torch.Tensor, group, split_dim: int,
          concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = torch.stack(x.tensor_split(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _exchange(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _swap(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, *ctx.args), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()  # the all-reduce writes in place
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        mine = g.tensor_split(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
        return mine.contiguous(), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:  # one all-reduce per input, in argument order
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of ``group`` sends ``x`` to rank ``i + shift`` and
    returns what rank ``i - shift`` sent (modulo the group size)."""
    return _Rotate.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``split_dim`` into group-size blocks, send block ``j`` to rank
    ``j``, and concatenate the blocks received along ``concat_dim`` in rank
    order."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, group, dim)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, which every rank then uses alike."""
    return _SumReplicated.apply(x, group)


def replicate(group, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` unchanged, with their cotangents summed over ``group`` in the
    backward: for values that every rank holds alike and feeds into work
    split over the group."""
    return _Replicate.apply(group, *xs)
