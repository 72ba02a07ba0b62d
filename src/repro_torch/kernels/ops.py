"""Public entry points of the kernels (the port of ``repro/kernels/ops.py``).

On a CUDA tensor each launches its hand-written kernel, on a CPU tensor the
kernel's plain version.  The reference pads every operand for the TPU (x to
C*bk rows and 128 lanes, the table and q/k to 128 lanes, the edge count to
a block); the port hands them over at their own shapes.

``spmm`` is the entry point of the padded kernel ``spmm_blockell`` over a
``BlockEll`` container (its device operands are built on the first call
and kept while the container lives); ``spmm_ref`` always runs its plain
version.
``embedding_bag`` keeps the reference's contract (a stable sort by bag,
weights defaulting to ones, empty bags giving zeros) and differentiates
with respect to the table.
``sddmm`` is the per-edge dot product.  ``decode_attention`` is
flash-decode over a KV cache, taken GQA-native or expanded, at any length
(the reference pads S to a multiple of its block).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..memo import per_object
from . import decode_attention as _decode
from . import embedding_bag as _bag
from . import sddmm as _sddmm
from .ref import spmm_blockell_ref
from .spmm_blockell import spmm_blockell


def _operands(ell, x: torch.Tensor):
    """The slot table and tiles of ``ell`` on x's device, built on the
    first call for that container and device."""
    def build():
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(x.device)
        # the exact 0/1 bitmask travels as uint8 tiles; weighted tiles as
        # fp32
        tiles = ell.dense_blocks(np.uint8 if ell.implicit else np.float32)
        return t(ell.block_cols), t(tiles)
    return per_object(ell, ("spmm", x.device), build)


def spmm(ell, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` from a :class:`~repro_torch.core.BlockEll`; x: (n, d)
    float32, returns (n, d)."""
    block_cols, blocks = _operands(ell, x)
    return spmm_blockell(block_cols, blocks, x.contiguous(), bm=ell.bm,
                         bk=ell.bk, n_dst=x.shape[0])


def spmm_ref(ell, x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`spmm`."""
    block_cols, blocks = _operands(ell, x)
    return spmm_blockell_ref(block_cols, blocks, x, bm=ell.bm, bk=ell.bk,
                             n_dst=x.shape[0])


# ---------------------------------------------------------- embedding bag
class _EmbeddingBag(torch.autograd.Function):
    """The bag sums, and the table's gradient by the same kernel on the
    transposed entries: sorted by id, one bag per table row (``num_bags =
    V``), gathering the output gradient's row of each entry's bag, weighted
    as in the forward.  Both sort with a stable argsort and hand the kernel
    a bag id per entry, as the TPU kernel takes them."""

    @staticmethod
    def forward(ctx, table, ids, bag_ids, weights, num_bags):
        order = torch.argsort(bag_ids, stable=True)
        ids_s, bags_s, w_s = ids[order], bag_ids[order], weights[order]
        ctx.save_for_backward(ids_s, bags_s, w_s)
        ctx.n_rows = table.shape[0]
        return _bag.embedding_bag(ids_s, bags_s, w_s, table, num_bags)

    @staticmethod
    def backward(ctx, grad_out):
        ids_s, bags_s, w_s = ctx.saved_tensors
        order = torch.argsort(ids_s, stable=True)
        grad_table = _bag.embedding_bag(bags_s[order], ids_s[order],
                                        w_s[order], grad_out.contiguous(),
                                        ctx.n_rows)
        return grad_table, None, None, None, None


def _check_indices(*checks):
    """Each ``(what, idx, n)``'s ``idx`` as int32, after checking that every
    entry lies in [0, n): all of them in one host synchronisation."""
    bad = []
    for what, idx, n in checks:
        if idx.dim() != 1:
            raise ValueError(f"{what} must be 1-D, got {tuple(idx.shape)}")
        if idx.dtype.is_floating_point or idx.dtype == torch.bool:
            raise TypeError(f"{what} must be integers, got {idx.dtype}")
        if idx.numel():
            bad.append(((idx < 0) | (idx >= n)).any())
        else:
            bad.append(torch.zeros((), dtype=torch.bool, device=idx.device))
    for (what, _, n), flag in zip(checks, torch.stack(bad).tolist()):
        if flag:
            raise IndexError(f"{what} out of range [0, {n})")
    return tuple(idx.to(torch.int32) for _, idx, _ in checks)


def embedding_bag(ids: torch.Tensor, bag_ids: torch.Tensor,
                  table: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-sum EmbeddingBag: ``out[b] = Σ_{i: bag_ids[i] = b}
    weights[i] · table[ids[i]]``, (num_bags, d), an empty bag as zeros.

    ids, bag_ids: (L,) integers in [0, V) and [0, num_bags), in any order
    (sorted by bag, stably, here); weights: (L,) or None (ones); table:
    (V, d) float32.  Differentiable in ``table`` only: weights that require
    a gradient raise.
    """
    V = table.shape[0]
    if weights is None:
        weights = torch.ones(ids.shape[0], dtype=torch.float32,
                             device=table.device)
    elif weights.requires_grad:
        raise NotImplementedError("embedding_bag differentiates the table "
                                  "only; the weights require a gradient")
    if weights.shape != ids.shape or bag_ids.shape != ids.shape:
        raise ValueError("ids, bag_ids and weights must have one shape")
    ids, bag_ids = _check_indices(("ids", ids, V),
                                  ("bag_ids", bag_ids, num_bags))
    return _EmbeddingBag.apply(table.contiguous(), ids, bag_ids,
                               weights.to(torch.float32).contiguous(),
                               num_bags)


# ------------------------------------------------------------------ sddmm
def sddmm(src: torch.Tensor, dst: torch.Tensor, q: torch.Tensor,
          k: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products ``s_e = <q[src_e], k[dst_e]>`` (GAT edge
    scores); src, dst: (E,) rows of q (N, d) and k (M, d); returns (E,)."""
    src, dst = _check_indices(("src", src, q.shape[0]),
                              ("dst", dst, k.shape[0]))
    return _sddmm.sddmm(src, dst, q.contiguous(), k.contiguous())


# --------------------------------------------------------- decode attention
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Flash-decode: ``softmax(q kᵀ / sqrt(d)) v`` over each row's first
    ``cache_len[b]`` positions.  q: (B, H, d); k/v: (B, S, KV, d) with
    ``H % KV == 0``, the reference's expanded ``KV == H`` or GQA-native;
    cache_len: (B,) integers.  float32 or bfloat16; returns (B, H, d)."""
    return _decode.decode_attention(q.contiguous(), k, v,
                                     cache_len.to(q.device, torch.int32))
