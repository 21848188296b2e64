"""Collectives with the gradients of the reference's ``shard_map``.

``jax.grad`` through a ``shard_map`` body (``check_vma=False``)
transposes its collectives under two conventions of its own: the
cotangent of an output replicated over a mesh axis is split evenly over
that axis's copies, and an input replicated over an axis gets its
cotangent summed over it. So a ``psum`` whose output is replicated
passes the cotangent through unchanged, and an input read by every rank
of a group gets the group's sum (Megatron's f/g pair). c10d's in-place
collectives have no autograd kernel, and
``torch.distributed.nn.functional.all_reduce`` all-reduces the upstream
gradient, which gives n times the gradient when every rank computes the
same loss from a replicated output. These functions keep c10d's forward
and give the reference's backward.

Every function takes a process group, or None for a trivial one (the
identity, both ways). Each collective of a backward runs on every rank
of its group in the same order, as the forward's did: all ranks must
run the same graph.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _SumReplicated(torch.autograd.Function):
    """``psum`` with a replicated output: the sum forward, the cotangent
    unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedInput(torch.autograd.Function):
    """An input every rank of ``group`` reads: the identity forward, the
    cotangent summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SplitCopies(torch.autograd.Function):
    """A value computed identically on ``n`` ranks and read as one: the
    identity forward, the cotangent divided over the copies backward."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _GatherRows(torch.autograd.Function):
    """Rows all-gathered over ``group`` (tiled, rank order) by a rank
    whose input is also replicated over ``reduce_group`` (a group that
    holds ``group``): the concatenation forward; backward the cotangent
    summed over ``reduce_group`` and the rank's rows kept (the
    transpose of the reference's ``all_gather(tiled=True)``, a
    reduce-scatter, then its replicated input's sum)."""

    @staticmethod
    def forward(ctx, x, group, reduce_group, index):
        ctx.reduce_group = reduce_group
        ctx.index, ctx.rows = index, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.reduce_group)
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


class _SumThenRows(torch.autograd.Function):
    """Partial outputs summed over ``reduce_group``, then this rank's
    ``rows`` rows at block ``index`` kept, the output replicated over the
    rest of ``reduce_group``: backward the rank's cotangent rows
    all-gathered over ``gather_group`` (the ranks that hold the other
    blocks), the whole cotangent on every rank."""

    @staticmethod
    def forward(ctx, x, reduce_group, gather_group, index, rows):
        ctx.gather_group = gather_group
        out = x.clone()
        dist.all_reduce(out, group=reduce_group)
        return out[index * rows:(index + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(_size(ctx.gather_group))]
        dist.all_gather(parts, g, group=ctx.gather_group)
        return torch.cat(parts), None, None, None, None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, replicated there (``psum``)."""
    if group is None:
        return x
    return _SumReplicated.apply(x, group)


def mean_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (the sum, then / size;
    ``pmean``)."""
    if group is None:
        return x
    return sum_replicated(x, group) / dist.get_world_size(group)


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as read by every rank of ``group``: its gradient is summed
    over the group."""
    if group is None:
        return x
    return _ReplicatedInput.apply(x, group)


def split_copies(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``, one of ``n`` identical copies: its gradient divided by n."""
    if n == 1:
        return x
    return _SplitCopies.apply(x, n)


def gather_rows(x: torch.Tensor, group, reduce_group, index: int) -> torch.Tensor:
    """The rows of every rank of ``group`` in rank order; the gradient
    of this rank's rows (block ``index``) summed over ``reduce_group``."""
    return _GatherRows.apply(x, group, reduce_group, index)


def sum_then_rows(x: torch.Tensor, reduce_group, gather_group, index: int,
                  rows: int) -> torch.Tensor:
    """Rows [index rows, (index + 1) rows) of the sum of ``x`` over
    ``reduce_group``; the gradient the cotangent's blocks gathered over
    ``gather_group``."""
    return _SumThenRows.apply(x, reduce_group, gather_group, index, rows)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` over ``group``, concatenated in rank
    order (no gradient: the transport's client gather)."""
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
