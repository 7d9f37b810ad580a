"""Collectives with autograd over the data group.

The JAX package's data parallelism is one SPMD program over the global
batch: its BatchNorm sums and its triplet loss's distance matrix span
every device, and GSPMD places the collectives and their transposes. Here
each rank runs its own slice, and these two Functions carry the global
quantities both ways:

  * ``all_reduce_sum``: the sum over ranks; its backward is the sum over
    ranks of the gradient (each rank's statistics reach every rank's
    loss).
  * ``all_gather_batch``: the ranks' tensors concatenated along dim 0 in
    rank order; its backward sums the gradient over ranks and keeps this
    rank's rows.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: gloo runs
them on CUDA tensors as well as on CPU ones. ``counts`` holds the
collectives run, by kind, forward and backward apart.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

counts = collections.Counter()


def reset_counts() -> None:
    counts.clear()


def all_reduce_(t: torch.Tensor, group, kind: str = 'all_reduce'
                ) -> torch.Tensor:
    """In-place sum over the group's ranks (no autograd), counted."""
    dist.all_reduce(t, group=group)
    counts[kind] += 1
    return t


def gather_batch(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along dim 0 in rank
    order (no autograd), counted."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    counts['all_gather'] += 1
    return torch.cat(parts, dim=0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group,
                           'all_reduce_backward'), None


class _AllGatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return gather_batch(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group,
                        'all_gather_backward')
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of x over the group's ranks."""
    return _AllReduceSum.apply(x, group)


def all_gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable concatenation of the ranks' x along dim 0."""
    return _AllGatherBatch.apply(x, group)
