"""Mesh-level flash decode: KV cache sequence-sharded on the model axis
(port of ``repro/dist/attention.py``).

The per-device kernel (``kernels/decode_attention.py``) keeps a running
(max, denominator, accumulator) across KV blocks; this module runs the
same recurrence one level up: each model rank reduces its local KV slice
to a partial (m, l, acc) triple, then one all-reduce MAX and two
all-reduce SUMs over the ``model`` group merge the partials (the LSE
merge).  Batch rides the data axis untouched.  Per-rank collective payload
is O(B*H*d), independent of S.

As in ``dist.halo``, every rank passes its own blocks (the reference's
arguments are the global arrays, sharded by ``shard_map``): q and
cache_lens hold the rank's rows of the batch, k and v also its slice of
the sequence, and the rank at coordinate j of the model axis holds
positions ``[j * S_local, (j + 1) * S_local)``.  Ranks of one model group
get the same (B_local, H, d) result.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def distributed_decode_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cache_lens: torch.Tensor,
                                 data_axis: str = "data",
                                 model_axis: str = "model",
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """q: (B_local, H, d); k/v: (B_local, S_local, H, d); cache_lens:
    (B_local,) valid KV lengths of the rank's batch rows (global positions).

    Matches ``kernels.ref.decode_attention_ref`` on the gathered arrays,
    with B split over ``data_axis`` and S over ``model_axis``.  Scores and
    the merge in fp32; returns q's dtype.
    """
    if data_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis '{data_axis}'")
    Sl = k.shape[1]
    return lse_merge_decode(q, k, v, cache_lens, mesh.get_group(model_axis),
                            mesh.get_local_rank(model_axis) * Sl, scale)


def lse_merge_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_lens: torch.Tensor, group, offset: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The merge itself, over ``group``: this rank's k/v hold positions
    ``[offset, offset + S_local)``; every rank of ``group`` gets the (B, H,
    d) result."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    Sl = k.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q, k).to(torch.float32) * sc
    pos = offset + torch.arange(Sl, device=q.device)
    valid = pos[None, :] < cache_lens.to(q.device)[:, None]  # (Bl, Sl)
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    # local partials; a rank whose whole slice is masked keeps m = -inf
    m = scores.amax(dim=-1)                                   # (Bl, H)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.where(torch.isfinite(scores),
                    torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)                                         # (Bl, H)
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    acc = torch.einsum("bhs,bshd->bhd", p.to(v.dtype), v).to(torch.float32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)
