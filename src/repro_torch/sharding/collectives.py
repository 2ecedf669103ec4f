"""The collectives of the reference's ``shard_map`` bodies, with a backward.

``torch.distributed``'s collectives record no gradient.  These two carry
one, under the port's convention for SPMD training: every rank runs the
backward of its own copy of the loss, and the parameter gradients of the
ranks add up (an all-reduce SUM, as a data-parallel step does) to the
gradient of the global loss.

* :func:`all_reduce_sum` — ``psum`` of a value every rank contributes a
  part of; the backward hands each rank's part the incoming gradient.
* :func:`all_gather_rows` — ``all_gather(..., tiled=True)`` along dim 0;
  the backward sums the incoming gradients over the ranks (each rank's
  copy of the gathered rows fed its own loss terms) and hands each rank
  its block.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather_rows"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0, in group-rank order."""
    return _AllGatherRows.apply(x, group)
