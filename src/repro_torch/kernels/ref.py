"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its CUDA kernel.  The kernel wrappers
run them for tensors on the CPU (where the CPU tests reach them) and
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def spmm_blockell_compact_ref(row_offsets: torch.Tensor, cols: torch.Tensor,
                              blocks: torch.Tensor, x: torch.Tensor,
                              s_in: torch.Tensor, s_out: torch.Tensor,
                              x_diag: Optional[torch.Tensor] = None,
                              s_in_diag: Optional[torch.Tensor] = None, *,
                              bm: int, bk: int, add_diag: bool
                              ) -> torch.Tensor:
    """``s_out ⊙ (Σ_slots A_tile (s_in ⊙ x_tile) [+ s_in_diag ⊙ x_diag])``.

    row_offsets: (R + 1,) slot offsets per destination block; cols:
    (n_active,) source block per slot; blocks: (n_active, bm, bk) uint8 or
    float32 tiles; x: (n_src, d); s_in: (n_src,); s_out: (n_dst,);
    x_diag: (n_dst, d) and s_in_diag: (n_dst,) default to x and s_in.
    Returns (n_dst, d).  Rows of destination blocks with no slot, which the
    kernel leaves unwritten, come out as zeros here.
    """
    R = row_offsets.numel() - 1
    n_src, d = x.shape
    n_dst = s_out.shape[0]
    C = -(-n_src // bk)
    xs = x * s_in[:, None]
    xb = F.pad(xs, (0, 0, 0, C * bk - n_src)).reshape(C, bk, d)
    counts = torch.diff(row_offsets.long())
    rows = torch.repeat_interleave(torch.arange(R, device=x.device), counts)
    prod = torch.einsum("abk,akd->abd", blocks.to(torch.float32),
                        xb[cols.long()])
    acc = torch.zeros(R, bm, d, dtype=x.dtype, device=x.device)
    acc.index_add_(0, rows, prod)
    acc = acc.reshape(R * bm, d)
    if add_diag:
        xd = x if x_diag is None else x_diag
        sd = s_in if s_in_diag is None else s_in_diag
        self_term = xd[:n_dst] * sd[:n_dst, None]
        acc = acc + F.pad(self_term, (0, 0, 0, R * bm - n_dst))
    y = acc[:n_dst] * s_out[:, None]
    written = torch.repeat_interleave(counts > 0, bm)[:n_dst]
    return torch.where(written[:, None], y, torch.zeros_like(y))


def spmm_blockell_update_compact_ref(
        row_offsets: torch.Tensor, cols: torch.Tensor, blocks: torch.Tensor,
        x: torch.Tensor, s_in: torch.Tensor, s_out: torch.Tensor,
        w: torch.Tensor, bias: Optional[torch.Tensor] = None,
        w_self: Optional[torch.Tensor] = None,
        self_coeff: Optional[torch.Tensor] = None,
        x_self: Optional[torch.Tensor] = None,
        x_diag: Optional[torch.Tensor] = None,
        s_in_diag: Optional[torch.Tensor] = None, *, bm: int, bk: int,
        add_diag: bool, relu: bool = False) -> torch.Tensor:
    """The one-launch layer
    ``act((s_out ⊙ acc) @ w + c · (x_self @ w_self) + bias)`` with ``acc``
    the compact aggregation of :func:`spmm_blockell_compact_ref`.

    w and w_self: (d_in, d_out); bias: (d_out,); self_coeff: a 0-d tensor
    (c = 1 when absent); x_self: (n_dst, d_in), defaults to x.  Returns
    (n_dst, d_out).  Rows of destination blocks with no slot come out as
    zeros here; the kernel leaves them unwritten.
    """
    n_dst = s_out.shape[0]
    y = spmm_blockell_compact_ref(row_offsets, cols, blocks, x, s_in, s_out,
                                  x_diag, s_in_diag, bm=bm, bk=bk,
                                  add_diag=add_diag) @ w
    if w_self is not None:
        xs = (x if x_self is None else x_self)[:n_dst] @ w_self
        y = y + (xs if self_coeff is None else self_coeff * xs)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    written = torch.repeat_interleave(torch.diff(row_offsets.long()) > 0,
                                      bm)[:n_dst]
    return torch.where(written[:, None], y, torch.zeros_like(y))


def spmm_blockell_lists_ref(row_ptr: torch.Tensor, src: torch.Tensor,
                            coef: Optional[torch.Tensor], x: torch.Tensor,
                            s_in: torch.Tensor, s_out: torch.Tensor,
                            x_diag: Optional[torch.Tensor] = None,
                            s_in_diag: Optional[torch.Tensor] = None, *,
                            add_diag: bool) -> torch.Tensor:
    """:func:`spmm_blockell_compact_ref` over per-row entry lists: row v
    sums ``coef_e · s_in ⊙ x[src_e]`` over its entries ``[row_ptr[v],
    row_ptr[v + 1])`` (coef None: every one 1), the self term and s_out as
    the tile version applies them.  Returns (n_dst, d), every row written
    (a row with no entry holds its self term or zero)."""
    n_dst = s_out.shape[0]
    xs = x * s_in[:, None]
    msgs = xs[src.long()]
    if coef is not None:
        msgs = msgs * coef[:, None]
    rows = torch.repeat_interleave(torch.arange(n_dst, device=x.device),
                                   torch.diff(row_ptr.long()))
    acc = x.new_zeros((n_dst, x.shape[1])).index_add_(0, rows, msgs)
    if add_diag:
        xd = x if x_diag is None else x_diag
        sd = s_in if s_in_diag is None else s_in_diag
        acc = acc + xd[:n_dst] * sd[:n_dst, None]
    return acc * s_out[:, None]


def spmm_blockell_update_lists_ref(
        row_ptr: torch.Tensor, src: torch.Tensor,
        coef: Optional[torch.Tensor], x: torch.Tensor, s_in: torch.Tensor,
        s_out: torch.Tensor, w: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        w_self: Optional[torch.Tensor] = None,
        self_coeff: Optional[torch.Tensor] = None,
        x_self: Optional[torch.Tensor] = None,
        x_diag: Optional[torch.Tensor] = None,
        s_in_diag: Optional[torch.Tensor] = None, *, add_diag: bool,
        relu: bool = False) -> torch.Tensor:
    """:func:`spmm_blockell_update_compact_ref` over per-row entry lists
    (the aggregation of :func:`spmm_blockell_lists_ref`); every row
    written."""
    n_dst = s_out.shape[0]
    y = spmm_blockell_lists_ref(row_ptr, src, coef, x, s_in, s_out, x_diag,
                                s_in_diag, add_diag=add_diag) @ w
    if w_self is not None:
        xs = (x if x_self is None else x_self)[:n_dst] @ w_self
        y = y + (xs if self_coeff is None else self_coeff * xs)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


# ---------------------------------------------------------------------------
# the padded (R, W) slot grid
# ---------------------------------------------------------------------------
def spmm_blockell_ref(block_cols: torch.Tensor, blocks: torch.Tensor,
                      x: torch.Tensor, *, bm: int, bk: int,
                      n_dst: Optional[int] = None) -> torch.Tensor:
    """``y = A x`` over the padded slot grid: ``y[rows of r] = Σ_w
    A[r, w] x_tile(block_cols[r, w])``, slots with ``col < 0`` skipped.

    block_cols: (R, W) int; blocks: (R, W, bm, bk) uint8 or float32; x:
    (n_src, d).  Returns (n_dst, d), every row written; n_dst defaults to
    R * bm.  One batched product per slot column keeps the gathered tiles
    at (R, bk, d) instead of (R, W, bk, d)."""
    R, W = block_cols.shape
    n_src, d = x.shape
    C = -(-n_src // bk)
    xb = F.pad(x, (0, 0, 0, C * bk - n_src)).reshape(C, bk, d)
    cols = block_cols.long()
    y = x.new_zeros((R, bm, d))
    for w in range(W):
        c = cols[:, w]
        tiles = xb[c.clamp(min=0)] * (c >= 0).to(x.dtype)[:, None, None]
        y = y + torch.bmm(blocks[:, w].to(x.dtype), tiles)
    return y.reshape(R * bm, d)[:R * bm if n_dst is None else n_dst]


def spmm_blockell_fused_ref(block_cols: torch.Tensor, blocks: torch.Tensor,
                            x: torch.Tensor, s_in: torch.Tensor,
                            s_out: torch.Tensor, *, bm: int, bk: int,
                            add_diag: bool) -> torch.Tensor:
    """``s_out ⊙ (A (s_in ⊙ x) [+ s_in ⊙ x])`` over the padded slot grid.

    s_in: (n_src,); s_out: (n_dst,).  Returns (n_dst, d), every row
    written (rows of blocks with no active slot get the self term or
    zero)."""
    n_dst = s_out.shape[0]
    xs = x * s_in[:, None]
    y = spmm_blockell_ref(block_cols, blocks, xs, bm=bm, bk=bk, n_dst=n_dst)
    if add_diag:
        k = min(n_dst, x.shape[0])
        y = y + F.pad(xs[:k], (0, 0, 0, n_dst - k))
    return y * s_out[:, None]


def spmm_blockell_update_ref(
        block_cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
        s_in: torch.Tensor, s_out: torch.Tensor, w: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        w_self: Optional[torch.Tensor] = None,
        self_coeff: Optional[torch.Tensor] = None, *, bm: int, bk: int,
        add_diag: bool, relu: bool = False) -> torch.Tensor:
    """The padded one-launch layer
    ``act((s_out ⊙ acc) @ w + c · (x @ w_self) + bias)`` with ``acc`` the
    aggregation of :func:`spmm_blockell_fused_ref`; every row written."""
    n_dst = s_out.shape[0]
    y = spmm_blockell_fused_ref(block_cols, blocks, x, s_in, s_out, bm=bm,
                                bk=bk, add_diag=add_diag) @ w
    if w_self is not None:
        xs = x[:n_dst] @ w_self
        y = y + (xs if self_coeff is None else self_coeff * xs)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def spmm_edges_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Edge-list (COO) reference: ``y[v] = Σ_{e: dst_e = v} w_e x[src_e]``,
    (num_nodes, d)."""
    msgs = x[src.long()] * w[:, None]
    return torch.zeros((num_nodes, x.shape[1]), dtype=msgs.dtype,
                       device=x.device).index_add(0, dst.long(), msgs)


def embedding_bag_ref(ids: torch.Tensor, bag_ids: torch.Tensor,
                      weights: torch.Tensor, table: torch.Tensor,
                      num_bags: int) -> torch.Tensor:
    """``out[b] = Σ_{i: bag_ids[i] = b} weights[i] · table[ids[i]]``, the
    take + segment-sum of the reference's ``embedding_bag_ref``; (num_bags,
    d), an empty bag as zeros.  Any order of the entries."""
    rows = table[ids.long()] * weights[:, None].to(table.dtype)
    return torch.zeros((num_bags, table.shape[1]), dtype=table.dtype,
                       device=table.device).index_add(0, bag_ids.long(), rows)


def sddmm_ref(src: torch.Tensor, dst: torch.Tensor, q: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products ``s_e = <q[src_e], k[dst_e]>``."""
    return torch.sum(q[src.long()] * k[dst.long()], dim=-1)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """One query per (b, h) against an S-long KV cache, masked by
    ``cache_len``: ``softmax(q kᵀ / sqrt(d)) v`` over positions
    ``< cache_len[b]``.

    q: (B, H, d); k, v: (B, S, KV, d) with ``H % KV == 0`` (query head h
    reads KV head ``h // (H / KV)``; ``KV == H`` is the reference's
    contract); cache_len: (B,) integers.  Scores, softmax and products in
    fp32; returns (B, H, d) in q's dtype.  A row with ``cache_len <= 0``
    gives zeros, as the Pallas kernel does through its ``max(l, 1e-30)``
    (the reference's ``decode_attention_ref`` gives NaN there); a
    ``cache_len`` above S takes every position.
    """
    B, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    # each query head's KV head, expanded here so that a cache given
    # GQA-native and the same cache given expanded run the same arithmetic
    kx = k.to(torch.float32).repeat_interleave(H // KV, dim=2)
    vx = v.to(torch.float32).repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), kx)
    scores = scores / (d ** 0.5)
    valid = (torch.arange(S, device=q.device)[None, :]
             < cache_len.to(q.device)[:, None])            # (B, S)
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=1)[:, None, None], probs,
                        torch.zeros_like(probs))
    return torch.einsum("bhs,bshd->bhd", probs, vx).to(q.dtype)


def _list_rows(row_ptr: torch.Tensor) -> torch.Tensor:
    """The row of each entry of per-row lists."""
    n = row_ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   torch.diff(row_ptr.long()))


def gat_attention_ref(row_ptr: torch.Tensor, src: torch.Tensor,
                      z: torch.Tensor, s_src: torch.Tensor,
                      s_dst: torch.Tensor, *, negative_slope: float):
    """Edge-softmax attention over per-row entry lists.  For destination
    row v, head h and v's entries j (``src[row_ptr[v]:row_ptr[v + 1]]``):
    ``e_vj = LeakyReLU(s_dst[v, h] + s_src[j, h])``, ``α = softmax_j(e)``,
    ``out[v, h] = Σ_j α_vj z[j, h]`` and ``lse[v, h] = log Σ_j exp e_vj``.

    z: (n_src, H, F); s_src: (n_src, H); s_dst: (n_dst, H).  Returns
    ``(out (n_dst, H, F), lse (n_dst, H))``; a row with no entry gets 0 in
    both."""
    rows, j = _list_rows(row_ptr), src.long()
    n_dst, H = s_dst.shape
    e = F.leaky_relu(s_dst[rows] + s_src[j], negative_slope)
    m = s_dst.new_full((n_dst, H), float("-inf")).scatter_reduce_(
        0, rows[:, None].expand_as(e), e, "amax")
    p = torch.exp(e - m[rows])
    den = s_dst.new_zeros((n_dst, H)).index_add_(0, rows, p)
    out = z.new_zeros((n_dst, H, z.shape[2])).index_add_(
        0, rows, z[j] * p[:, :, None])
    has = den > 0
    out = out / torch.where(has, den, torch.ones_like(den))[:, :, None]
    lse = torch.where(has, m + torch.log(den), torch.zeros_like(den))
    return out, lse


def gat_attention_bwd_ref(row_ptr: torch.Tensor, row_ptr_t: torch.Tensor,
                          dst_t: torch.Tensor, fwd_pos: torch.Tensor,
                          z: torch.Tensor, s_src: torch.Tensor,
                          s_dst: torch.Tensor, lse: torch.Tensor,
                          row_dot: torch.Tensor, dout: torch.Tensor, *,
                          negative_slope: float):
    """The backward of :func:`gat_attention_ref`, walked as the kernels walk
    it.  Over the transposed lists (source j's entries ``dst_t[row_ptr_t[j]
    :row_ptr_t[j + 1]]`` are the rows i that list j), with α recomputed
    from the scores and ``lse``:

    * ``dz[j] = Σ_i α_ij dout[i]``;
    * ``de_ij = α_ij (dout[i]·z[j] − row_dot[i])``, ``row_dot = Σ_F dout ⊙
      out`` (each row's term, computed once a row);
    * ``dpre_ij = de_ij`` where ``s_dst[i] + s_src[j] > 0``, else
      ``negative_slope · de_ij``; ``ds_src[j] = Σ_i dpre_ij``;

    and ``ds_dst[i] = Σ_j dpre_ij`` over row i's forward entries, each
    ``dpre`` put at its forward place ``fwd_pos`` (the transposed entry's
    place among the forward lists' entries).  Returns ``(dz, ds_src,
    ds_dst)``."""
    cols, i = _list_rows(row_ptr_t), dst_t.long()
    pre = s_src[cols] + s_dst[i]
    alpha = torch.exp(F.leaky_relu(pre, negative_slope) - lse[i])
    g = dout[i]
    de = alpha * (torch.sum(g * z[cols], dim=-1) - row_dot[i])
    dpre = torch.where(pre > 0, de, de * negative_slope)
    dz = torch.zeros_like(z).index_add_(0, cols, g * alpha[:, :, None])
    ds_src = torch.zeros_like(s_src).index_add_(0, cols, dpre)
    at_fwd = torch.empty_like(dpre)
    at_fwd[fwd_pos.long()] = dpre
    ds_dst = torch.zeros_like(s_dst).index_add_(0, _list_rows(row_ptr),
                                                at_fwd)
    return dz, ds_src, ds_dst
