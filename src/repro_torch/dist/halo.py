"""Sharded graph aggregation: halo exchange vs. the all-gather baseline
(port of ``repro/dist/halo.py``).

Both entry points compute exactly ``core.segment_aggregate`` (weighted-sum
semantics over the plan's edge lists) with the node axis split over one
mesh axis; they are drop-in replacements for each other and for the
single-device oracle, differing only in collective volume:

* ``halo_aggregate``      — one ``all_to_all_single`` of equal splits moving
  only the deduplicated cut-edge rows (SendPlan tables), then a purely local
  gather + segment-sum over the renumbered [owned | halo] row space.
* ``allgather_aggregate`` — ships the full feature table (all-gather) and
  reads halo rows out of it; the baseline made explicit.

**A divergence of form.**  The reference's ``x`` is the global (N, d)
array, sharded by ``shard_map``; here every rank of the mesh's axis group
calls the function with its own (local_n, d) window of rows (rows
``[r * local_n, (r + 1) * local_n)`` on the rank at coordinate r) and gets
its window of the result back.  Every rank of the group must make the same
calls in the same order: each is a collective.

Both are differentiable.  The exchange is a ``torch.autograd.Function`` of
this module whose backward is the reverse ``all_to_all_single`` (an
all_to_all of equal splits is its own transpose); the all-gather's
backward all-reduces the full gradient and keeps the rank's window (gloo
has no reduce-scatter on every build).  So the sharded GNN train step in
``dist/gnn.py`` backprops straight through the exchange.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.aggregate import segment_sum
from ..graph.partition import HaloPlan, uniform_local_n
from ..memo import per_object
from .plan import SendPlan


def _check_local_n(plan: HaloPlan, local_n: int) -> None:
    if uniform_local_n(plan.parts) != local_n:
        raise ValueError(
            f"caller claims local_n={local_n} but the plan's windows hold "
            f"{uniform_local_n(plan.parts)} nodes each")


def axis_group(mesh, axis_name: Optional[str], num_parts: int
               ) -> Tuple[object, int]:
    """The process group of ``axis_name`` (the mesh's first axis by
    default) and this rank's coordinate on it; raises unless the axis has
    ``num_parts`` ranks."""
    axis = axis_name or mesh.mesh_dim_names[0]
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size != num_parts:
        raise ValueError(
            f"plan has {num_parts} parts but mesh axis '{axis}' has "
            f"size {size}")
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def _tensors(obj, rank: int, device: torch.device, names) -> dict:
    """Row ``rank`` of each of ``obj``'s tables on ``device`` (indices as
    int64), built once per (object, rank, device)."""
    def build():
        out = {}
        for name in names:
            a = np.ascontiguousarray(getattr(obj, name)[rank])
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            out[name] = torch.as_tensor(a, device=device)
        return out
    return per_object(obj, ("rank_tables", rank, str(device)), build)


_SEND = ("send_idx", "send_mask", "recv_slot", "recv_mask")
_EDGES = ("edge_src", "edge_dst", "edge_weight", "halo_src", "halo_mask")


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of equal splits; its backward is the same
    exchange of the gradient (rows go back to where they came from)."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, group):
        ctx.group = group
        return _all_to_all(rows, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_to_all(grad, ctx.group), None


def _gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    # all_gather_single where torch has it (all_gather_into_tensor is
    # deprecated there), all_gather_into_tensor before
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t.contiguous(), group=group)


class _AllGather(torch.autograd.Function):
    """The (P * n, d) table from every rank's (n, d) window; backward: the
    all-reduced gradient's window of this rank."""

    @staticmethod
    def forward(ctx, xl: torch.Tensor, group, rank: int, parts: int):
        ctx.group, ctx.rank, ctx.n = group, rank, xl.shape[0]
        out = xl.new_empty((parts * xl.shape[0], *xl.shape[1:]))
        _gather_into(out, xl, group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        lo = ctx.rank * ctx.n
        return grad[lo:lo + ctx.n], None, None, None


def send_rows(x: torch.Tensor, t: dict) -> torch.Tensor:
    """The (P * K, d) rows this rank ships: slot (q, k) holds local row
    ``send_idx[q, k]`` for rank q, zero where the slot is padding."""
    si, sm = t["send_idx"], t["send_mask"]
    rows = torch.where(sm[:, :, None], x[si], 0.0)
    return rows.reshape(-1, x.shape[1])


def local_aggregate(x: torch.Tensor, got: torch.Tensor, t: dict, e: dict,
                    halo_capacity: int, local_n: int) -> torch.Tensor:
    """The received rows filed into the halo buffer, then the gather over
    ``[owned | halo]`` and the weighted segment-sum into the window
    (``src/repro/dist/halo.py:65-74``)."""
    rs, rm = t["recv_slot"], t["recv_mask"]
    d = x.shape[1]
    slot = torch.where(rm, rs, halo_capacity - 1).reshape(-1)
    vals = torch.where(rm[:, :, None], got.reshape(*rm.shape, d),
                       0.0).reshape(-1, d)
    halo = segment_sum(vals, slot, halo_capacity)
    full = torch.cat([x, halo], dim=0)               # [owned | halo] rows
    msgs = full[e["edge_src"]] * e["edge_weight"][:, None]  # padding: w = 0
    return segment_sum(msgs, e["edge_dst"], local_n)


def _prepare(mesh, x, plan, send, local_n, axis_name):
    group, rank = axis_group(mesh, axis_name, plan.parts.num_parts)
    _check_local_n(plan, local_n)
    if x.shape[0] != local_n:
        raise ValueError(f"each rank passes its window of {local_n} rows; "
                         f"got {x.shape[0]}")
    e = _tensors(plan, rank, x.device, _EDGES)
    t = _tensors(send, rank, x.device, _SEND) if send is not None else None
    return group, rank, t, e


def halo_aggregate(mesh, x: torch.Tensor, plan: HaloPlan, send: SendPlan,
                   local_n: int, axis_name: Optional[str] = None
                   ) -> torch.Tensor:
    """Sharded ``a[v] = sum_{(u->v)} w_uv * x[u]`` via halo exchange.

    Called by every rank of ``axis_name``'s group with x: this rank's
    (local_n, d) window of the node features, in the contiguous windows of
    ``plan.parts``.  Returns this rank's (local_n, d) window of the
    aggregate.
    """
    group, _, t, e = _prepare(mesh, x, plan, send, local_n, axis_name)
    got = _Exchange.apply(send_rows(x, t), group)  # got[q] = from rank q
    return local_aggregate(x, got, t, e, plan.halo_capacity, local_n)


def allgather_aggregate(mesh, x: torch.Tensor, plan: HaloPlan,
                        local_n: int, axis_name: Optional[str] = None,
                        send: Optional[SendPlan] = None) -> torch.Tensor:
    """Same result as ``halo_aggregate`` but shipping the FULL feature table.

    ``send`` is accepted (and ignored) so callers can flip between the two
    executors without changing the call site.
    """
    group, rank, _, e = _prepare(mesh, x, plan, None, local_n, axis_name)
    xg = _AllGather.apply(x, group, rank, plan.parts.num_parts)   # (N, d)
    halo = torch.where(e["halo_mask"][:, None], xg[e["halo_src"]], 0.0)
    full = torch.cat([x, halo], dim=0)
    msgs = full[e["edge_src"]] * e["edge_weight"][:, None]
    return segment_sum(msgs, e["edge_dst"], local_n)
