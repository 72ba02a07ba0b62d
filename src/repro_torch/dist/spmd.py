"""Manual SPMD over mesh axes: the collectives of the mesh paths, each an
autograd ``Function``, so a step's gradients are the reference's.

GSPMD derives the collectives of a sharded program itself; PyTorch has no
eager counterpart, so the port's mesh paths (``models.transformer``, the
GNN models and wide & deep under ``dist.sharding.use_mesh``) run on
rank-local tensors and call these where GSPMD would insert a collective.  Each takes the mesh and the axes it
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

The graph layout (nodes and edges cut over every axis, edge ids indexing
the whole node set) adds three: :func:`reduce_scatter` (a partial sum over
the whole node set, summed and cut to the rank's block of nodes; backward:
all-gather), :func:`all_sum` (the sum on every rank, for consumers that
differ by rank; backward: the sum again) and :func:`segment_max` (over
the edges of every rank, the rank's block of segments, differentiable: a
segment's gradient is split evenly among the inputs of every rank that
tie for it, as ``core.aggregate.segment_max`` splits it on one device; a
min is the max of the negated inputs, as PNA's lanes take it).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.autograd import Function

from ..core import aggregate


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


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, group, dim, i, n):
        ctx.group, ctx.dim = group, dim
        return _block(_summed(x, group), dim, i, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim), None, None, None, None


class _AllSum(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _SegmentMax(Function):
    # the max over the ranks of each rank's partial segment max; backward:
    # the rank's block of the gradient gathered, then split among the
    # entries of every rank that equal their segment's max
    @staticmethod
    def forward(ctx, data, seg, num_segments, group, i, n):
        idx = seg.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
        m = data.new_full((num_segments, *data.shape[1:]), -math.inf
                          ).scatter_reduce(0, idx, data, "amax",
                                           include_self=False)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(data, seg, m)
        ctx.group = group
        return _block(m, 0, i, n)

    @staticmethod
    def backward(ctx, g):
        data, seg, m = ctx.saved_tensors
        g = _gather_dim(g, ctx.group, 0)
        tie = (data == m[seg]).to(g.dtype)
        count = _summed(torch.zeros_like(m).index_add_(0, seg, tie),
                        ctx.group)
        return (g / count)[seg] * tie, None, None, None, None, None


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


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Sum over ``axes``, then the rank's block along ``dim`` (backward:
    all-gather).  The sum is an all-reduce: gloo has no reduce-scatter on
    every build."""
    axes = _axes(mesh, axes)
    group = mesh.group(axes)
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, dim, mesh.index(axes),
                                size(mesh, axes))


def all_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes`` for consumers that differ by rank (backward: the
    sum over ``axes``)."""
    group = mesh.group(_axes(mesh, axes))
    return x if group is None else _AllSum.apply(x, group)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mesh, axes) -> torch.Tensor:
    """``core.aggregate.segment_max`` over the entries of every rank of
    ``axes`` (each rank passes its own, ``segment_ids`` indexing all
    ``num_segments``): the rank's block of the (num_segments, ...) result,
    -inf for an empty segment.  Backward: each entry that ties for its
    segment's max gets the segment's gradient over the number of tied
    entries on every rank."""
    axes = _axes(mesh, axes)
    group = mesh.group(axes)
    if group is None:
        return aggregate.segment_max(data, segment_ids, num_segments)
    return _SegmentMax.apply(data, segment_ids, num_segments, group,
                             mesh.index(axes), size(mesh, axes))


# ------------------------------------------------------- the graph layout
# nodes and edges cut over every axis of the mesh (None: no mesh, each a
# no-op); a rank's edge ids index the whole node set
def node_count(n_local: int, mesh) -> int:
    """The whole node set's size from the rank's ``n_local`` rows."""
    return n_local if mesh is None else n_local * mesh.size


def node_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole node set's rows of ``x`` (the rank's rows), for the rank's
    edges to index (:func:`gather_sum` over every axis)."""
    return x if mesh is None else gather_sum(x, mesh, mesh.axis_names, 0)


def node_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of the sum over the ranks of ``x``, a partial sum
    over the whole node set (:func:`reduce_scatter` over every axis)."""
    return x if mesh is None else reduce_scatter(x, mesh, mesh.axis_names,
                                                 0)


def node_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of ``x`` on every rank, for the rank's edges
    to index (:func:`all_sum` over every axis)."""
    return x if mesh is None else all_sum(x, mesh, mesh.axis_names)


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
