"""Manual SPMD over mesh axes: the collectives of the LM mesh path, each an
autograd ``Function``, so a step's gradients are the reference's.

GSPMD derives the collectives of a sharded program itself; PyTorch has no
eager counterpart, so the port's mesh path (``models.transformer`` under
``dist.sharding.use_mesh``) runs on rank-local tensors and calls these
where GSPMD would insert a collective.  Each takes the mesh and the axes it
runs over; over axes of one rank it returns its input unchanged (no
collective, no copy), so a (1, 1) mesh computes exactly what no mesh does.

Two gradient conventions meet here.  Over ``model`` the tensor-parallel
one: a tensor every model rank holds whole has its whole gradient on every
rank; :func:`copy` (identity, backward all-reduce) enters a region where
ranks compute different parts, :func:`all_reduce` (sum, backward identity)
leaves it.  Over the batch axes the data-parallel one: each rank's
gradient is its batch rows' part, and the parts sum to the gradient of the
step's loss; a parameter held whole on every batch rank enters through
:func:`copy` over those axes, a layer of a ZeRO-sharded stack through
:func:`broadcast` from its owner (backward: all-reduce, kept by the
owner).  All-gathers come in two kinds by what their output feeds:
:func:`gather` (backward: the rank's block of a gradient every rank holds
whole) and :func:`gather_sum` (backward: the sum over the ranks, then the
block; gloo has no reduce-scatter on every build).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.autograd import Function


def _axes(mesh, axes) -> tuple:
    """``axes`` (a name or a tuple) in mesh order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in mesh.axis_names if a in axes)


def size(mesh, axes) -> int:
    n = 1
    for a in _axes(mesh, axes):
        n *= mesh.shape[a]
    return n


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k).contiguous()


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _Mean(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return _summed(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Split(Function):
    @staticmethod
    def forward(ctx, x, group, dim, i, n):
        ctx.group, ctx.dim = group, dim
        return _block(x, dim, i, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim), None, None, None, None


class _Gather(Function):
    @staticmethod
    def forward(ctx, x, group, dim, i, n, summed):
        ctx.dim, ctx.i, ctx.n, ctx.group, ctx.summed = dim, i, n, group, \
            summed
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _summed(g, ctx.group)
        return _block(g, ctx.dim, ctx.i, ctx.n), None, None, None, None, None


class _Broadcast(Function):
    # ``anchor`` is a tensor of the rank's own stack: through it the output
    # needs a gradient on every rank, so every rank joins the backward's
    # all-reduce, the owner's input or not
    @staticmethod
    def forward(ctx, x, anchor, group, src, owner):
        ctx.group, ctx.owner = group, owner
        out = x.detach().contiguous().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = _summed(g, ctx.group)
        return (g if ctx.owner else None), None, None, None, None


class _ScaleGrad(Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes`` (backward: identity)."""
    group = mesh.group(_axes(mesh, axes))
    return x if group is None else _AllReduce.apply(x, group)


def copy(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity (backward: sum over ``axes``)."""
    group = mesh.group(_axes(mesh, axes))
    return x if group is None else _Copy.apply(x, group)


def mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Mean over ``axes`` (``lax.pmean``; backward: the gradient over the
    rank count)."""
    group = mesh.group(_axes(mesh, axes))
    return x if group is None else _Mean.apply(x, group)


def split(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The rank's block of ``x`` along ``dim`` over ``axes`` (backward:
    all-gather)."""
    axes = _axes(mesh, axes)
    group = mesh.group(axes)
    if group is None:
        return x
    return _Split.apply(x, group, dim, mesh.index(axes), size(mesh, axes))


def gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather the blocks of ``axes`` along ``dim``, for a consumer every
    rank runs alike (backward: the rank's block)."""
    axes = _axes(mesh, axes)
    group = mesh.group(axes)
    if group is None:
        return x
    return _Gather.apply(x, group, dim, mesh.index(axes), size(mesh, axes),
                         False)


def gather_sum(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` for consumers that differ by rank (backward:
    sum over ``axes``, then the rank's block)."""
    axes = _axes(mesh, axes)
    group = mesh.group(axes)
    if group is None:
        return x
    return _Gather.apply(x, group, dim, mesh.index(axes), size(mesh, axes),
                         True)


def scale_grad(x: torch.Tensor, c: float) -> torch.Tensor:
    """Identity whose backward scales the gradient by ``c``."""
    return x if c == 1 else _ScaleGrad.apply(x, c)


def broadcast(x: Optional[torch.Tensor], like: torch.Tensor, mesh, axes,
              owner: int) -> torch.Tensor:
    """The tensor held by the rank at block index ``owner`` of ``axes``, on
    every rank of them (the owner passes it as ``x``, the others pass None
    and get a tensor shaped as ``like``).  Backward: the sum over ``axes``,
    kept by the owner."""
    axes = _axes(mesh, axes)
    group = mesh.group(axes)
    if group is None:
        return x
    mine = mesh.index(axes) == owner
    src = dist.get_global_rank(group, owner)
    inp = x if mine else torch.empty_like(like)
    return _Broadcast.apply(inp, like, group, src, mine)


def max_(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Element-wise max over ``axes``, outside autograd (a log-sum-exp's
    shift)."""
    group = mesh.group(_axes(mesh, axes))
    x = x.detach().contiguous().clone()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def layer_of(stack, i: int, n_layers: int, mesh,
             axes: Sequence[str]) -> torch.Tensor:
    """Layer ``i`` of a stacked parameter whose leading (layer) axis is
    ZeRO-sharded over ``axes`` (the rank holds ``n_layers / n`` layers), or
    held whole on every rank of ``axes``: one layer at a time, from its
    owner, into every rank of ``axes`` (backward: its gradient summed over
    them and kept by the owner).  A stack held whole enters through
    :func:`copy` instead.  ``stack`` is the rank's stacked tensor or the
    sequence of its layers (``torch.unbind``'s views: the backward stacks
    their gradients once, where indexing writes each layer's gradient into
    a zero stack of its own)."""
    n = size(mesh, axes)
    if len(stack) == n_layers:
        return copy(stack[i], mesh, axes)
    per = n_layers // n
    if len(stack) != per or per * n != n_layers:
        raise ValueError(f"a stack of {len(stack)} local layers is "
                         f"neither whole ({n_layers}) nor its ZeRO shard "
                         f"over {n} ranks")
    owner, j = divmod(i, per)
    mine = mesh.index(_axes(mesh, axes)) == owner
    return broadcast(stack[j] if mine else None, stack[0], mesh, axes,
                     owner)
