"""The collectives of the sharded train step, each written out, with its
gradient, so that every one can be seen and tested.

Where the reference lets GSPMD insert collectives from shardings, the
port calls them itself over the training mesh's groups
(``parallel/mesh.py::RankMesh``):

- :func:`all_reduce_sum` — a sum over a group, and its gradient the sum of
  the ranks' output gradients (BatchNorm's moments over ``'data'``);
- :func:`sum_grad` — the identity, its gradient summed over a group (the
  input of a layer sharded over ``'model'``: each rank's gradient is the
  part its slice of the layer contributes);
- :func:`gather_channels` — the ranks' channel slices concatenated along
  dim 1, its gradient the rank's own slice of the output gradient. The
  compute after the gather is the same on every rank of the group, so each
  holds the whole gradient already; summing it over the ranks, as
  ``torch.distributed.nn.functional.all_gather``'s backward does, would
  count it once a rank.

A group of one rank makes each of them the identity without a call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.slice = (r * x.shape[1], x.shape[1])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        start, width = ctx.slice
        return g.narrow(1, start, width).contiguous(), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``x``; the gradient is summed over it too."""
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group``."""
    return x if group_size(group) == 1 else _SumGrad.apply(x, group)


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """[B, C/n, …] slices of the ``n`` ranks of ``group``, in rank order →
    [B, C, …]; the gradient is this rank's slice of the output's."""
    return x if group_size(group) == 1 else _GatherChannels.apply(x, group)
