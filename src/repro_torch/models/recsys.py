"""Wide & Deep (arXiv:1606.07792): 40 sparse fields, embed 32, MLP
1024-512-256 — the port of ``repro/models/recsys.py``.

Wide part: a linear model over the sparse ids (one weight per table row, an
embed_dim = 1 EmbeddingBag) plus the dense features.  Deep part: the
concatenated field embeddings and the dense features through an MLP to a
logit.  One fused table holds every field's rows (field f at rows
``f * rows_per_field``).

The lookups are the hot path.  ``lookup="bag"`` (the default) sends both
through ``kernels.ops.embedding_bag``, as the reference's
``examples/serve_recsys.py::widedeep_logits_pallas`` sends them through
the Pallas kernel: the deep part as B·F single-id bags over the table
(d = embed_dim), the wide part as B bags of F ids over ``wide[:, None]``
(d = 1); the table's gradient comes from the same kernel on the transposed
bag list.  ``lookup="dense"`` is the reference model's own take +
segment-sum, in plain torch.  ``retrieval_score`` is a plain matrix-vector
product, as in the reference.  Every entry point takes a ``mesh`` (the
``RecsysBundle`` layout: ``table`` and ``wide`` the rank's rows over
``model``): the lookups keep the ids in the rank's rows and sum over
``model``, the rest runs alike on every ``model`` rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from ..nn.embedding import sharded_bag, sharded_take
from ..nn.layers import linear_apply, linear_init, mlp_apply, mlp_init

LOOKUPS = ("bag", "dense")


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    rows_per_field: int = 100_000     # fused table = n_sparse * rows_per_field
    embed_dim: int = 32
    n_dense: int = 13
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.rows_per_field

    def param_count(self) -> int:
        deep_in = self.n_sparse * self.embed_dim + self.n_dense
        dims = (deep_in,) + self.mlp_dims + (1,)
        mlp = sum(dims[i] * dims[i + 1] + dims[i + 1]
                  for i in range(len(dims) - 1))
        return self.total_rows * (self.embed_dim + 1) + mlp + self.n_dense + 1


def widedeep_init(generator: torch.Generator, cfg: WideDeepConfig,
                  device="cuda") -> Dict:
    """The reference's parameter tree, drawn where ``generator`` lives and
    moved to ``device``.  At the published width the table is 40 M x 32
    (5.12 GB): draw it with a generator on the card."""
    dev = resolve_device(device)
    deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    r = lambda *shape: torch.randn(shape, generator=generator,
                                   device=generator.device)
    table = r(cfg.total_rows, cfg.embed_dim).mul_(1.0 / math.sqrt(
        cfg.embed_dim))
    wide = r(cfg.total_rows).mul_(0.01)
    return {"table": table.to(dev, cfg.param_dtype),
            "wide": wide.to(dev, cfg.param_dtype),
            "wide_dense": linear_init(generator, cfg.n_dense, 1, device=dev),
            "deep": mlp_init(generator, [deep_in, *cfg.mlp_dims, 1],
                             device=dev)}


def _flat_ids(sparse_ids: torch.Tensor, cfg: WideDeepConfig) -> torch.Tensor:
    """(B, F) per-field local ids -> (B·F,) rows of the fused table."""
    F = sparse_ids.shape[1]
    offsets = torch.arange(F, dtype=sparse_ids.dtype,
                           device=sparse_ids.device) * cfg.rows_per_field
    return (sparse_ids + offsets[None, :]).reshape(-1)


def _deep_in(params, sparse_ids, dense, cfg: WideDeepConfig,
             lookup: str, mesh=None) -> torch.Tensor:
    """concat(field embeddings, dense): (B, F·embed_dim + n_dense)."""
    B, F = sparse_ids.shape
    flat = _flat_ids(sparse_ids, cfg)
    table = params["table"].to(cfg.dtype)
    if lookup == "bag":
        # the per-field gather == B·F bags of exactly one id
        emb = sharded_bag(flat, torch.arange(B * F, device=flat.device),
                          table, B * F, mesh)
    elif lookup == "dense":
        emb = sharded_take(table, flat, mesh)
    else:
        raise ValueError(f"unknown lookup {lookup!r} (choices: {LOOKUPS})")
    return torch.cat([emb.reshape(B, F * cfg.embed_dim),
                      dense.to(cfg.dtype)], dim=-1)


def widedeep_logits(params, sparse_ids: torch.Tensor, dense: torch.Tensor,
                    cfg: WideDeepConfig, lookup: str = "bag",
                    mesh=None) -> torch.Tensor:
    """sparse_ids: (B, F) per-field LOCAL ids; dense: (B, n_dense).
    Returns (B,) logits.  Under ``mesh``, ``table`` and ``wide`` are the
    rank's blocks of rows over ``model`` and the rows of the batch those the
    rank holds: the lookups are masked to the rank's block and summed over
    ``model``, the MLP runs alike on every ``model`` rank."""
    B, F = sparse_ids.shape
    deep = mlp_apply(params["deep"],
                     _deep_in(params, sparse_ids, dense, cfg, lookup,
                              mesh))[:, 0]
    flat = _flat_ids(sparse_ids, cfg)
    wide_table = params["wide"].to(cfg.dtype)
    if lookup == "bag":
        # a true F-id bag sum per row over the embed_dim = 1 table
        bag = torch.arange(B, device=flat.device).repeat_interleave(F)
        wide_sparse = sharded_bag(flat, bag, wide_table[:, None], B,
                                  mesh)[:, 0]
    else:
        wide_sparse = sharded_take(wide_table, flat, mesh).reshape(
            B, F).sum(dim=1)
    wide = wide_sparse + linear_apply(params["wide_dense"],
                                      dense.to(cfg.dtype))[:, 0]
    return deep + wide


def widedeep_loss(params, sparse_ids, dense, labels, cfg: WideDeepConfig,
                  lookup: str = "bag", mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in its stable form (under
    ``mesh``, over the rank's rows of the batch)."""
    z = widedeep_logits(params, sparse_ids, dense, cfg,
                        lookup, mesh).to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * labels
                      + torch.log1p(torch.exp(-torch.abs(z))))


# ------------------------------------------------------------- retrieval
def user_tower(params, sparse_ids, dense, cfg: WideDeepConfig,
               lookup: str = "bag", mesh=None) -> torch.Tensor:
    """(B, mlp_dims[-1]) user representation: the last hidden layer."""
    h = _deep_in(params, sparse_ids, dense, cfg, lookup, mesh)
    for p in params["deep"][:-1]:
        h = torch.relu(linear_apply(p, h))
    return h


def retrieval_score(params, sparse_ids, dense, candidate_emb: torch.Tensor,
                    cfg: WideDeepConfig, lookup: str = "bag",
                    mesh=None) -> torch.Tensor:
    """Score one query against N candidates: (1, F), (1, n_dense),
    (N, mlp_dims[-1]) -> (N,), one matrix-vector product.  Under ``mesh``
    the query is whole on every rank and ``candidate_emb`` the rank's
    block: the scores are the block's."""
    q = user_tower(params, sparse_ids, dense, cfg, lookup, mesh)
    return candidate_emb.to(cfg.dtype) @ q[0]
