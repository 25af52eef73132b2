"""Autograd-aware collectives over one process group: the counterparts of
``psum``, ``pmean`` and ``all_gather(..., tiled=True)`` inside the
reference's ``shard_map`` bodies.

The loss convention: every rank computes the same loss from values that
are whole and the same on every rank, and every rank's backward gives the
gradient of that one loss.  So a tensor that is the same on every rank of a
group (*replicated*) has the same gradient on every rank, and each rank's
``p.grad`` of a replicated parameter is the whole gradient, as
``jax.grad`` through the reference's ``shard_map`` gives it.  Each operation
says how its value changes between replicated and per-rank (*varying*):

* :func:`all_reduce` / :func:`all_mean`: varying in, replicated out; the
  backward passes the (replicated) gradient through.
* :func:`all_gather`: varying parts in, the replicated whole out; the
  backward takes the rank's part of the gradient.
* :func:`own_part`: a replicated whole in, the rank's part out; the
  backward all-gathers the parts' gradients into the whole.
* :func:`fan_out`: the identity on a replicated value that feeds work that
  differs between ranks; the backward sums the ranks' gradients.

Only ``all_reduce`` and ``all_gather`` are called, which every backend
(NCCL on the card, gloo on the CPU) has.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _part(g, ctx.dim, ctx.group), None, None


class _OwnPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _part(x, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _gather(g, ctx.dim, ctx.group), None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _sum(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` (``psum``)."""
    return _AllReduce.apply(x, group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of the ranks' ``x`` (``pmean``)."""
    return all_reduce(x, group) / dist.get_world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order
    (``all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, dim, group)


def own_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (one of the group's size,
    in rank order), with no communication."""
    return _OwnPart.apply(x, dim, group)


def fan_out(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, marked as feeding work that differs between the ranks,
    so that its gradient is the sum of theirs."""
    return _FanOut.apply(x, group)


def axis_group(mesh, names: str | tuple[str, ...]):
    """(process group, this rank's index in it, its size) of the mesh axes
    ``names``; several axes form one group, the first outermost."""
    names = (names,) if isinstance(names, str) else tuple(names)
    sub = mesh[names] if len(names) > 1 else mesh[names[0]]
    if len(names) > 1:
        sub = sub._flatten()
    return sub.get_group(), sub.get_local_rank(), sub.size()
