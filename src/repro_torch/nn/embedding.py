"""EmbeddingBag and sparse-feature lookups for recsys (the port of
``repro/nn/embedding.py``).

A bag lookup is a graph aggregation (bags are destinations, table rows
sources).  ``embedding_bag_apply``'s ``sum`` and ``mean`` go through
``kernels.ops.embedding_bag`` (the hand-written kernel on the card, its
plain version on the CPU, differentiable in the table); ``max`` is plain
torch (``scatter_reduce`` with ``amax``), as no kernel computes it.  The
per-field lookups are plain gathers, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..device import resolve_device
from ..kernels import ops


def embedding_bag_init(generator: torch.Generator, vocab: int, d: int,
                       device="cuda") -> dict:
    """A (vocab, d) table of N(0, 1/d) drawn where ``generator`` lives,
    then moved to ``device``."""
    dev = resolve_device(device)
    t = torch.randn((vocab, d), generator=generator, device=generator.device)
    return {"table": t.mul_(1.0 / math.sqrt(d)).to(dev)}


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
