"""Differentiable collectives over a process group.

The JAX package differentiates through `lax.psum`, `all_gather` and
`ppermute` inside `shard_map`; these are their counterparts for the port's
one-rank-a-process groups, each an autograd Function whose backward is the
collective's transpose:

- `all_reduce` (sum): the backward all-reduces the gradient, since every
  rank's output depends on every rank's input.
- `all_gather` along a dimension: the backward reduce-scatters the
  gradient (a rank's slice collects what every rank's loss asks of it), as
  JAX transposes `all_gather` (ops/sharded_attention.py:17-21).
- `global_moments` and `global_mean_var`: a norm's statistics over the
  ranks' slabs, from sums and element counts (one or two all-reduces).
- `ppermute(x, perm)`: each rank sends to the destination its (src, dst)
  pair names and receives from the source that names it, zeros where none
  does, in one all-to-all; the backward sends the gradient back along the
  inverse pairs.

A group of None means a single process: each is then the identity. Ranks
in `perm` are positions in the group. torch's own differentiable
collectives (`torch.distributed.nn.functional`) are deprecated in the
torch this port runs on, and their all-gather backward takes an all-to-all
on every backend but nccl.
"""
from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, on every rank."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def global_moments(
    x: torch.Tensor, dims: Sequence[int], group
) -> tuple[torch.Tensor, torch.Tensor]:
    """E[x] and E[x^2] of x over `dims` and over the group's ranks: the sums
    and the element counts in one all-reduce (differentiable), in x's type
    (f32 for the statistics of the norms). The other axes keep their shape."""
    count = x.new_full((1,), math.prod(x.shape[d] for d in dims))
    sums = all_reduce(torch.cat([x.sum(dims).reshape(-1), (x * x).sum(dims).reshape(-1), count]),
                      group)
    mean, msq = (sums[:-1] / sums[-1]).chunk(2)
    shape = [n for d, n in enumerate(x.shape) if d not in dims]
    return mean.reshape(shape), msq.reshape(shape)


def global_mean_var(
    x: torch.Tensor, dims: Sequence[int], group
) -> tuple[torch.Tensor, torch.Tensor]:
    """E[x] and the variance E[(x - E[x])^2] of x over `dims` and over the
    group's ranks, in two passes (two all-reduces of the sums with the
    element counts, differentiable): the two-pass variance of torch's
    norms. Its gradient keeps x - E[x] whole where E[x]^2 is far above the
    variance; `global_moments`' E[x^2] - E[x]^2 cancels there."""
    count = x.new_full((1,), math.prod(x.shape[d] for d in dims))
    keep = [1 if d in dims else n for d, n in enumerate(x.shape)]

    def mean_of(t):
        sums = all_reduce(torch.cat([t.sum(dims).reshape(-1), count]), group)
        return (sums[:-1] / sums[-1]).reshape(keep)

    mean = mean_of(x)
    centred = x - mean
    shape = [n for d, n in enumerate(x.shape) if d not in dims]
    return mean.reshape(shape), mean_of(centred * centred).reshape(shape)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter0(g: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    g = g.contiguous()
    out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g.movedim(ctx.dim, 0), ctx.group).movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in group-rank order."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def _send_recv(x: torch.Tensor, group, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """One all-to-all whose only non-empty parts are the pairs of `perm`
    (gloo takes it on CUDA tensors, where it takes no send/recv)."""
    me, n = dist.get_rank(group), _size(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    flat = x.contiguous().reshape(-1)
    m = flat.numel()
    send = [m if dst and r == dst[0] else 0 for r in range(n)]
    recv = [m if src and r == src[0] else 0 for r in range(n)]
    out = flat.new_empty(sum(recv))
    dist.all_to_all_single(out, flat if dst else flat[:0], recv, send, group=group)
    return out.reshape(x.shape) if src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _send_recv(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: torch.Tensor, group, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """JAX's `lax.ppermute` over the group (zeros where no pair sends here)."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, perm)
