"""Collectives of the mesh paths (no JAX counterpart: GSPMD inserts them
there).

The plain helpers (``all_reduce_``, ``all_gather``, ``broadcast_``) take a
process group or None (a group of one: nothing to do). Under gloo a CUDA
tensor is staged through host memory (one copy each way), so one code path
serves NCCL, the CPU and two ranks sharing one card; under NCCL only a host
tensor (a generator's state) is staged, through the card.

The autograd functions say what the backward of each collective is, which
depends on what the ranks do with its result:

- ``gather_blocks``: every rank goes on with the same whole tensor (the
  stacked MC outputs, a tensor-parallel layer's output), so the loss is
  replicated and each rank's gradient of the whole is complete; the
  backward takes this rank's block and sums nothing
  (``torch.distributed.nn.functional.all_gather`` would sum it over the
  ranks and give k times the gradient).
- ``all_reduce_partial``: each rank goes on with its own rows (BatchNorm's
  global batch statistics), so each rank's gradient of the sum holds only
  its rows' part; the backward sums them.
- ``copy_to_group``: the identity whose backward sums (a tensor-parallel
  layer's input, whose gradient each shard holds a part of).
- ``sum_replicated``: the sum whose backward is the identity (the shards'
  KL terms, which enter a replicated loss once).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t, group):
    """(tensor to hand to the collective, copy-back or None): a CUDA tensor
    goes through host memory under gloo, a host tensor (a generator's
    state) through the rank's card under NCCL."""
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        return t.detach().cpu(), t
    if not t.is_cuda and backend == "nccl":
        return t.detach().cuda(), t
    return t, None


def all_reduce_(t, group):
    """Sum ``t`` over the group, in place; returns ``t``."""
    if group_size(group) == 1:
        return t
    work, back = _staged(t, group)
    dist.all_reduce(work, group=group)
    if back is not None:
        back.copy_(work)
    return t


def all_gather(t, group):
    """The group's tensors of ``t``'s shape, in group-rank order."""
    if group_size(group) == 1:
        return [t]
    work, back = _staged(t.contiguous(), group)
    parts = [torch.empty_like(work) for _ in range(group_size(group))]
    dist.all_gather(parts, work, group=group)
    if back is not None:
        parts = [p.to(back.device) for p in parts]
    return parts


def broadcast_(t, src: int, group):
    """Overwrite ``t`` with global rank ``src``'s value, in place."""
    if group_size(group) == 1:
        return t
    work, back = _staged(t, group)
    dist.broadcast(work, src=src, group=group)
    if back is not None:
        back.copy_(work)
    return t


class _GatherBlocks(torch.autograd.Function):
    """Forward: the group's blocks laid out on a grid; backward: this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, group, grid, dims, index):
        ctx.dims, ctx.index, ctx.sizes = dims, index, \
            [x.shape[d] for d in dims]
        parts = all_gather(x.detach(), group)

        def assemble(parts, level):
            if level == len(grid):
                return parts[0]
            step = len(parts) // grid[level]
            return torch.cat([assemble(parts[i * step:(i + 1) * step],
                                       level + 1)
                              for i in range(grid[level])], dim=dims[level])

        return assemble(parts, 0)

    @staticmethod
    def backward(ctx, g):
        for d, i, n in zip(ctx.dims, ctx.index, ctx.sizes):
            g = g.narrow(d, i * n, n)
        return g.contiguous(), None, None, None, None


def gather_blocks(x, group, grid, dims, index):
    """Lay the group's equal blocks of ``x`` out on a grid: ``grid[k]``
    blocks along dim ``dims[k]``, group rank r holding the block at the
    row-major position of r in ``grid``; ``index`` is this rank's position.
    Backward: this rank's block of the gradient (module docstring)."""
    if group_size(group) == 1:
        return x
    return _GatherBlocks.apply(x, group, tuple(grid), tuple(dims),
                               tuple(index))


class _AllReducePartial(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_partial(x, group):
    """The sum of ``x`` over the group; the backward sums the gradients."""
    if group_size(group) == 1:
        return x
    return _AllReducePartial.apply(x, group)


class _CopyToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to_group(x, group):
    """``x`` itself; the backward sums its gradient over the group."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


class _SumReplicated(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_replicated(x, group):
    """The sum of ``x`` over the group; the backward is the identity."""
    if group_size(group) == 1:
        return x
    return _SumReplicated.apply(x, group)
