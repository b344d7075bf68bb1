"""The collectives of the meshes, as autograd functions.

Every rank runs the same program on its own share; these are the points
where the shares meet.  Two conventions for a cotangent meet here:

- over ``data`` each rank's loss is its own term of the global mean, so a
  collective's backward sums the cotangents the ranks hold
  (`all_reduce_sum`: batch norm's moments);
- over ``model`` and ``pipe`` the ranks compute the same loss from the same
  rows, so a tensor they all hold has the same cotangent on each of them,
  and only the work split between them needs a sum.  `copy_to_group` is
  the identity forward and sums its cotangent over the group (a replicated
  tensor that feeds work split over the group: the input and the kernels
  of a channel-sharded conv, the kernels and the input of a pipeline
  stage); `gather_channels` all-gathers channel slices forward and keeps
  this rank's slice of the cotangent; `sum_over` sums forward and passes
  the cotangent through; `ring_hop` hands a tensor to the next rank of the
  ring and its cotangent back to the previous one.

Each rank must issue the same collectives in the same order, forward and
backward: the callers keep one static schedule on every rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_data_group = None
# An all-gather into one tensor (concatenated on the first axis): the
# newer name where this torch has it.
all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, batch norm in train mode normalizes by the moments
    of the whole batch over ``group`` (the mesh's ``data`` axis); None
    leaves it local."""
    global _data_group
    saved, _data_group = _data_group, group
    try:
        yield
    finally:
        _data_group = saved


def data_group():
    """The group `data_parallel` set, or None."""
    return _data_group


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; its backward sums the
    cotangents over the group (each rank's loss a term of the objective)."""
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; in the backward, the sum of its cotangent over
    ``group``: each rank contributed the part of the gradient its share of
    the work gives."""
    return _CopyToGroup.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        size = dist.get_world_size(group)
        dim = dim % x.dim()
        ctx.group, ctx.rank, ctx.dim, ctx.width = group, dist.get_rank(group), dim, x.shape[dim]
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        all_gather_single(out, x.contiguous(), group=group)
        out = out.reshape((size,) + tuple(x.shape)).movedim(0, dim)
        return out.reshape(*x.shape[:dim], size * x.shape[dim], *x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' channel slices (the last axis) of ``group`` side by side,
    in rank order; the backward keeps this rank's slice of the cotangent."""
    return _Gather.apply(x, group, -1)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' rows (the first axis) of ``group`` one after another, in
    rank order; the backward keeps this rank's rows of the cotangent."""
    return _Gather.apply(x, group, 0)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the cotangent, the same on every rank,
    passes through to each rank's term."""
    return _SumOver.apply(x, group)


def _exchange(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in the ring of ``group``
    and receive from the one ``step`` places back, in one batch."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    out = torch.empty_like(x)
    x = x.contiguous()
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (rank + step) % size), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (rank - step) % size), group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return out


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, -1), None


def ring_hop(x: torch.Tensor, group) -> torch.Tensor:
    """What the previous rank of ``group``'s ring holds (rank r receives
    from r - 1 and sends to r + 1, modulo the size); the backward hands the
    cotangent back the other way.  A group of one returns ``x``."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingHop.apply(x, group)

