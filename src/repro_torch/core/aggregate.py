"""Aggregation executors: the graph-level computing engine (paper's C1);
port of ``repro/core/aggregate.py``.

Interchangeable strategies for ``a_v = AGG_{u in N(v)} x_u``:

* ``segment_aggregate``  — gather + segment reduce (``index_add_`` for sum
                           and mean, ``scatter_reduce`` for max and min):
                           the index-order executor.
* ``shared_aggregate``   — the G-C computation-reuse executor driven by a
                           ``SharedSetPlan`` (paper §IV-A2): shared-set
                           partials built once, consumed by every buddy
                           destination (levels>1 = hierarchical extension).
* ``blockell_matmul``    — the block-ELL tile executor, the plain version
                           of the padded kernel ``spmm_blockell``.
* ``blockell_aggregate`` — ``A @ x`` from a ``BlockEll``: on a CUDA tensor
                           the ``spmm_blockell`` kernel (``kernels.ops.spmm``),
                           its backward the same kernel over Aᵀ's
                           block-ELL; on a CPU tensor ``blockell_matmul``.

All are differentiable and agree with each other and with the reference
(tests).  For max and min a segment with no message is -inf / +inf until
the end, where every non-finite entry becomes 0, as the reference's
``jax.ops.segment_max`` / ``segment_min`` give it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..memo import per_object
from .blocksparse import transpose_blockell
from .shared_set import SharedSetPlan

_OPS = ("sum", "mean", "max", "min")
_EXTREME = {"max": ("amax", float("-inf")), "min": ("amin", float("inf"))}


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over the leading axis (``index_add_``)."""
    return data.new_zeros((num_segments, *data.shape[1:])).index_add_(
        0, segment_ids, data)


def _segment_extreme(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int, op: str) -> torch.Tensor:
    """``jax.ops.segment_max`` (``op="max"``) / ``segment_min`` over the
    leading axis: an empty segment is -inf / +inf, and a segment's
    gradient is split evenly among the inputs that tie for it, as JAX
    splits it (``scatter_reduce`` with ``include_self=False``)."""
    reduce, fill = _EXTREME[op]
    idx = segment_ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return data.new_full((num_segments, *data.shape[1:]), fill
                         ).scatter_reduce(0, idx, data, reduce,
                                          include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` (see :func:`_segment_extreme`)."""
    return _segment_extreme(data, segment_ids, num_segments, "max")


def _segment_reduce(msgs: torch.Tensor, seg: torch.Tensor, num_segments: int,
                    op: str) -> torch.Tensor:
    """``jax.ops.segment_{sum,max,min}``: rows of ``msgs`` reduced into
    ``num_segments`` rows by ``seg`` (int64); an empty segment is 0 for sum
    and mean, -inf for max, +inf for min."""
    if op in ("sum", "mean"):
        return segment_sum(msgs, seg, num_segments)
    return _segment_extreme(msgs, seg, num_segments, op)


def _finite_or_zero(out: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# --------------------------------------------------------------------------
# canonical segment-reduce executor
# --------------------------------------------------------------------------
def segment_aggregate(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      num_nodes: int, op: str = "sum",
                      edge_weight: Optional[torch.Tensor] = None,
                      edge_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """a[v] = op_{(u->v)} (w_uv * x[u]).  op in {sum, mean, max, min}; a
    masked edge counts for nothing, a node without messages gets 0."""
    if op not in _OPS:
        raise ValueError(f"unknown aggregation {op!r} (sum | mean | max | "
                         "min)")
    src, dst = src.long(), dst.long()
    msgs = x[src]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    if edge_mask is not None:
        fill = _EXTREME[op][1] if op in _EXTREME else 0.0
        msgs = torch.where(edge_mask[:, None], msgs,
                           torch.full_like(msgs, fill))
    out = _segment_reduce(msgs, dst, num_nodes, op)
    if op == "mean":
        ones = (edge_mask.to(x.dtype) if edge_mask is not None
                else x.new_ones(src.shape[0]))
        deg = x.new_zeros(num_nodes).index_add_(0, dst, ones)
        return out / torch.clamp(deg, min=1.0)[:, None]
    return out if op == "sum" else _finite_or_zero(out)


# --------------------------------------------------------------------------
# G-C shared-set executor (paper CR; levels>1 = hierarchical extension)
# --------------------------------------------------------------------------
def _plan_tensors(plan: SharedSetPlan, device: torch.device) -> dict:
    """The plan's edge lists as int64 tensors on ``device`` and each
    destination's message count (residual plus every level's shared
    sources), built once per plan and device."""
    def build():
        t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
        N = plan.num_nodes
        deg = np.bincount(plan.residual_dst, minlength=N).astype(np.float64)
        levels = []
        for l in range(plan.num_levels):
            if plan.level_src[l].shape[0] == 0:
                continue
            width = 2 ** (l + 1)
            nb = (N + width - 1) // width
            cnt = np.bincount(plan.level_block[l], minlength=nb)
            deg += np.repeat(cnt, width)[:N]
            levels.append((t(plan.level_src[l]), t(plan.level_block[l]),
                           width, nb))
        return {"rs": t(plan.residual_src), "rd": t(plan.residual_dst),
                "levels": levels,
                "deg": torch.as_tensor(deg.astype(np.float32),
                                       device=device)}
    return per_object(plan, ("shared", device), build)


def _consume(out: torch.Tensor, sa: torch.Tensor, width: int, op: str
             ) -> torch.Tensor:
    """out[v] (+) SA[v >> (l+1)]: each block of ``width`` consecutive
    destinations folds in its shared partial, broadcast over the block
    (the reference's ``repeat`` of SA, without materializing it)."""
    N, d = out.shape
    nb = sa.shape[0]
    pad = nb * width - N
    blocks = (F.pad(out, (0, 0, 0, pad)) if pad else out).view(nb, width, d)
    sa = sa[:, None, :]
    if op == "max":
        y = torch.maximum(blocks, sa)
    elif op == "min":
        y = torch.minimum(blocks, sa)
    else:
        y = blocks + _finite_or_zero(sa)
    return y.reshape(nb * width, d)[:N]


def shared_aggregate(x: torch.Tensor, plan: SharedSetPlan, op: str = "sum"
                     ) -> torch.Tensor:
    """Two-phase aggregation with shared-set computation reuse.

    SA_l[b] aggregates the sources shared by the whole destination block b
    of size 2^(l+1); every original edge lives in exactly one list, so the
    residual plus all consumed levels reconstructs each row exactly.
    """
    if op not in _OPS:
        raise ValueError(f"unknown aggregation {op!r} (sum | mean | max | "
                         "min)")
    N = plan.num_nodes
    pt = _plan_tensors(plan, x.device)
    out = _segment_reduce(x[pt["rs"]], pt["rd"], N, op)
    for s, b, width, nb in pt["levels"]:
        sa = _segment_reduce(x[s], b, nb, op)        # (nb, d) shared partials
        out = _consume(out, sa, width, op)
    if op in _EXTREME:
        return _finite_or_zero(out)
    if op == "mean":
        out = out / torch.clamp(pt["deg"].to(x.dtype), min=1.0)[:, None]
    return out


# --------------------------------------------------------------------------
# block-ELL executor
# --------------------------------------------------------------------------
def blockell_matmul(block_cols: torch.Tensor, blocks: torch.Tensor,
                    x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """y = A @ x with A in block-ELL: the plain version of the padded
    kernel.  block_cols: (R, W) int, -1 for an inactive slot; blocks:
    (R, W, bm, bk) float; x: (n, d); returns (n, d).

    Inactive slots multiply a zero tile, as the reference does: exact and
    branch-free (the kernel skips them instead).
    """
    R, W = block_cols.shape
    n, d = x.shape
    C = -(-n // bk)
    xb = F.pad(x, (0, 0, 0, C * bk - n)).reshape(C, bk, d)
    tiles = xb[block_cols.clamp(min=0).long()]               # (R, W, bk, d)
    tiles = torch.where((block_cols >= 0)[:, :, None, None], tiles,
                        torch.zeros_like(tiles))
    y = torch.einsum("rwmk,rwkd->rmd", blocks.to(x.dtype), tiles)
    return y.reshape(R * bm, d)[:n]


class _BlockEllAggregate(torch.autograd.Function):
    """``A @ x`` by the ``spmm_blockell`` kernel; the backward ``Aᵀ @ g``
    by the same kernel over Aᵀ's block-ELL."""

    @staticmethod
    def forward(ctx, x, ell, ell_t):
        ctx.ell_t = ell_t
        return ops.spmm(ell, x)

    @staticmethod
    def backward(ctx, grad):
        return ops.spmm(ctx.ell_t, grad.contiguous()), None, None


def blockell_aggregate(ell, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over a square ``BlockEll``.  On a CUDA tensor one
    ``spmm_blockell`` launch, and one more over Aᵀ (built once per
    container on the host) in the backward when x needs a gradient; on a
    CPU tensor the plain ``blockell_matmul``."""
    if x.device.type == "cpu":
        cols, blocks = per_object(ell, ("dense", x.device), lambda: (
            torch.as_tensor(ell.block_cols),
            torch.as_tensor(ell.dense_blocks(np.float32))))
        return blockell_matmul(cols, blocks, x, ell.bm, ell.bk)
    ell_t = per_object(ell, "transpose", lambda: transpose_blockell(ell))
    return _BlockEllAggregate.apply(x.contiguous(), ell, ell_t)
