"""EmbeddingBag and sparse-feature lookups for recsys (the port of
``repro/nn/embedding.py``).

A bag lookup is a graph aggregation (bags are destinations, table rows
sources).  ``embedding_bag_apply``'s ``sum`` and ``mean`` go through
``kernels.ops.embedding_bag`` (the hand-written kernel on the card, its
plain version on the CPU, differentiable in the table); ``max`` is plain
torch (``scatter_reduce`` with ``amax``), as no kernel computes it.  The
per-field lookups are plain gathers, as in the reference.  On a mesh
that cuts a table's rows over ``model`` (wide & deep's mesh path),
:func:`sharded_take` and :func:`sharded_bag` keep the ids in the rank's
rows, look them up on its block and sum the result over ``model``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..dist import spmd
from ..kernels import ops


def embedding_bag_init(generator: torch.Generator, vocab: int, d: int,
                       device="cuda") -> dict:
    """A (vocab, d) table of N(0, 1/d) drawn where ``generator`` lives,
    then moved to ``device``."""
    dev = resolve_device(device)
    t = torch.randn((vocab, d), generator=generator, device=generator.device)
    return {"table": t.mul_(1.0 / math.sqrt(d)).to(dev)}


def _row_cut(mesh) -> bool:
    """Whether ``mesh`` cuts a table's rows (over ``model``, on more than
    one rank)."""
    return mesh is not None and mesh.shape.get("model", 1) > 1


def _shard_rows(ids: torch.Tensor, n_local: int, mesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids`` (rows of the whole table) as rows of the rank's block of
    ``n_local`` rows over ``model``, int64, clamped to [0, n_local), and
    the mask of those that lie in it."""
    local = ids.long() - mesh.coord("model") * n_local
    ok = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), ok


def sharded_take(table: torch.Tensor, ids: torch.Tensor,
                 mesh) -> torch.Tensor:
    """``table[ids]`` (the reference's take); under a mesh that cuts the
    table's rows over ``model`` (``table`` the rank's block, ``ids`` rows
    of the whole table), the rows in the rank's block (the others zero),
    summed over ``model`` (backward: identity, so the table's gradient is
    the rank's rows')."""
    if not _row_cut(mesh):
        return table[ids.long()]
    local, ok = _shard_rows(ids, table.shape[0], mesh)
    ok = ok.to(table.dtype).reshape(-1, *([1] * (table.dim() - 1)))
    return spmd.all_reduce(table[local] * ok, mesh, "model")


def sharded_bag(ids: torch.Tensor, bag_ids: torch.Tensor,
                table: torch.Tensor, num_bags: int, mesh) -> torch.Tensor:
    """``ops.embedding_bag`` (unweighted) under :func:`sharded_take`'s
    layout: the entries in the rank's block, remapped to its rows, then the
    sum over ``model`` (backward: identity).  Without a cut, the plain
    call."""
    if not _row_cut(mesh):
        return ops.embedding_bag(ids, bag_ids, table, num_bags)
    local, ok = _shard_rows(ids, table.shape[0], mesh)
    keep = torch.nonzero(ok)[:, 0]
    out = ops.embedding_bag(local[keep], bag_ids[keep], table, num_bags)
    return spmd.all_reduce(out, mesh, "model")


def embedding_bag_apply(p: dict, ids: torch.Tensor, bag_ids: torch.Tensor,
                        num_bags: int, weights: Optional[torch.Tensor] = None,
                        mode: str = "sum") -> torch.Tensor:
    """ids: (L,) flat row indices; bag_ids: (L,) the bag of each.  mode in
    {sum, mean, max}, as ``torch.nn.EmbeddingBag``; an empty bag gives
    zeros."""
    table = p["table"]
    if mode in ("sum", "mean"):
        s = ops.embedding_bag(ids, bag_ids, table, num_bags, weights)
        if mode == "sum":
            return s
        c = torch.zeros(num_bags, dtype=s.dtype, device=s.device).index_add_(
            0, bag_ids.long(), torch.ones(ids.shape[0], dtype=s.dtype,
                                          device=s.device))
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        rows = table[ids.long()]
        if weights is not None:
            rows = rows * weights[:, None].to(rows.dtype)
        idx = bag_ids.long()[:, None].expand(-1, rows.shape[1])
        m = torch.full((num_bags, rows.shape[1]), -math.inf, dtype=rows.dtype,
                       device=rows.device).scatter_reduce(0, idx, rows, "amax")
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    raise ValueError(mode)


def multi_field_lookup(tables: Sequence[dict],
                       ids: torch.Tensor) -> torch.Tensor:
    """ids: (B, F) one id per field; tables: F params (a shared table may be
    passed twice).  Returns (B, F, d)."""
    return torch.stack([tables[f]["table"][ids[:, f].long()]
                        for f in range(ids.shape[1])], dim=1)


def fused_field_lookup(p: dict, ids: torch.Tensor,
                       field_offsets: torch.Tensor) -> torch.Tensor:
    """One fused table for all fields (a row block per field): ids (B, F)
    per-field local ids, field_offsets (F,) each field's first row.  One
    gather instead of F.  Returns (B, F, d)."""
    return p["table"][(ids + field_offsets[None, :]).long()]


def hash_bucket(ids: torch.Tensor, vocab: int,
                salt: int = 0x9E3779B9) -> torch.Tensor:
    """Deterministic hash trick for open-vocabulary ids: the reference's
    uint32 arithmetic (``(ids * salt) >> 16`` modulo 2**32, then ``%
    vocab``) carried out in int64 with the wraparound made explicit."""
    mask = 0xFFFFFFFF
    h = ((ids.long() & mask) * salt & mask) >> 16
    return (h % vocab).to(torch.int32)
