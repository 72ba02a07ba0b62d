"""GQA attention with RoPE: training, prefill and decode paths (the port of
``repro/nn/attention.py``).

  * ``flash_attention``: chunked online-softmax attention in plain PyTorch,
    a Python loop over KV chunks with the q chunks as a batch dimension;
    peak memory O(q_chunk x kv_chunk) per head instead of O(S^2).  The
    reference computes it outside any Pallas kernel too.
  * decode writes the new token's KV into the cache first, then attends
    over the cache with a position mask.  The port writes the cache **in
    place** (the reference's serving step donates its caches): at
    granite-8b's ``decode_32k`` with B = 8 the caches are 38.65 GB, and two
    copies do not fit one card.
  * ``decode_attention(..., attn="kernel")`` (the default) sends the
    attention core to ``kernels.ops.decode_attention``, the flash-decode
    kernel, on the GQA-native cache; ``attn="plain"`` is the reference's
    two einsums over the ``_expand_kv``-expanded cache, line for line.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..dist import spmd
from ..kernels import ops
from .layers import linear_apply, linear_init

ATTNS = ("kernel", "plain")


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, max_pos: int, theta: float = 10000.0,
               dtype=torch.float32, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin tables (max_pos, head_dim / 2): the angles in fp32,
    then cast to ``dtype``."""
    dev = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=dev)
    ang = torch.outer(t, inv)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute positions."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def gqa_init(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv: int, head_dim: int, device="cuda") -> dict:
    return {
        "wq": linear_init(generator, d_model, n_heads * head_dim, bias=False,
                          device=device),
        "wk": linear_init(generator, d_model, n_kv * head_dim, bias=False,
                          device=device),
        "wv": linear_init(generator, d_model, n_kv * head_dim, bias=False,
                          device=device),
        "wo": linear_init(generator, n_heads * head_dim, d_model, bias=False,
                          device=device),
    }


def _qkv(p, x, n_heads, n_kv, head_dim, cos, sin, positions):
    B, S, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = linear_apply(p["wk"], x).reshape(B, S, n_kv, head_dim)
    v = linear_apply(p["wv"], x).reshape(B, S, n_kv, head_dim)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    return q, k, v


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, n_kv, D) -> (B, S, n_kv*groups, D), materialized."""
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


# -------------------------------------------------- flash (chunked) core
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 512,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA-native online-softmax attention.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D) with H = KV * groups; the GQA
    expansion is a grouped q axis, never materialized.  ``q_offset`` is
    the position of q's first row (the causal and window masks use it):
    the rows of a longer sequence attend as they would within it.  Returns
    (B, Sq, H * D) in q's dtype.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    Skv = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    assert Sq % q_chunk == 0 and Skv % kv_chunk == 0
    scale = 1.0 / math.sqrt(D)

    qc = q.reshape(B, nq, q_chunk, KV, G, D)
    kc = k.reshape(B, nk, kv_chunk, KV, D)
    vc = v.reshape(B, nk, kv_chunk, KV, D)
    q_pos = (q_offset + torch.arange(Sq, device=q.device)).reshape(
        nq, q_chunk)

    m = torch.full((B, nq, KV, G, q_chunk), float("-inf"),
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nq, KV, G, q_chunk, D), dtype=torch.float32,
                      device=q.device)
    for kj in range(nk):
        k_blk, v_blk = kc[:, kj], vc[:, kj]          # (B, kv_chunk, KV, D)
        s = torch.einsum("bnqhgd,bkhd->bnhgqk", qc, k_blk
                         ).to(torch.float32) * scale
        k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
        if causal:
            mask = q_pos[:, :, None] >= k_pos[None, None, :]
            if window is not None:
                mask &= q_pos[:, :, None] < k_pos[None, None, :] + window
            s = s.masked_fill(~mask[None, :, None, None], float("-inf"))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]),
                        0.0)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bnhgqk,bkhd->bnhgqd", p.to(v_blk.dtype), v_blk
                          ).to(torch.float32)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B, nq, KV, G, qc, D)
    out = out.permute(0, 1, 4, 2, 3, 5)                 # (B, nq, qc, KV, G, D)
    return out.reshape(B, Sq, H * D).to(q.dtype)


# --------------------------------------------------------------- training
def causal_attention(p, x: torch.Tensor, n_heads: int, n_kv: int,
                     head_dim: int, cos: torch.Tensor, sin: torch.Tensor,
                     positions: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     q_chunk: int = 1024, kv_chunk: int = 512
                     ) -> torch.Tensor:
    """Training/prefill attention via the flash core."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, cos, sin, positions)
    out = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, window=window)
    return linear_apply(p["wo"], out)


def prefill_attention(p, x, n_heads, n_kv, head_dim, cos, sin,
                      window: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 512):
    """Prefill: flash attention that also returns the KV cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, cos, sin, positions)
    out = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, window=window)
    return linear_apply(p["wo"], out), (k, v)


# ----------------------------------------------------------------- decode
def insert_kv(cache: torch.Tensor, new: torch.Tensor, pos: int
              ) -> torch.Tensor:
    """cache: (B, L, n_kv, D); new: (B, 1, n_kv, D); pos: the step.  Writes
    ``new`` at ``pos`` **in place** and returns ``cache`` (the reference
    returns an updated copy and donates the old one).

    Raises ``IndexError`` for ``pos`` outside [0, L): the reference's
    dynamic slice clamps such a position (and wraps -1 to L - 1), which
    would silently overwrite a cached token.
    """
    L = cache.shape[1]
    if not 0 <= pos < L:
        raise IndexError(f"cache position {pos} is outside the cache's "
                         f"{L} rows")
    cache[:, pos:pos + 1] = new.to(cache.dtype)
    return cache


def decode_attention(p, x: torch.Tensor,
                     kv_cache: Tuple[torch.Tensor, torch.Tensor],
                     cache_len: int, n_heads: int, n_kv: int, head_dim: int,
                     cos: torch.Tensor, sin: torch.Tensor,
                     attn: str = "kernel"
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """One-token decode.  cache_len: the new token's position.

    Writes the new KV at ``cache_len`` (in place), then attends over
    positions [0, cache_len].  ``attn="kernel"``: the flash-decode kernel on
    the GQA-native cache, lengths ``cache_len + 1``; ``attn="plain"``: the
    reference's masked softmax over the expanded cache.  Returns (output,
    the (k, v) caches).
    """
    B, S, _ = x.shape
    assert S == 1
    k_cache, v_cache = kv_cache
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv, head_dim, cos, sin, positions)
    k_cache = insert_kv(k_cache, k_new, cache_len)
    v_cache = insert_kv(v_cache, v_new, cache_len)
    out = _attend(q, k_cache, v_cache, cache_len, n_heads, n_kv, head_dim,
                  attn)
    return linear_apply(p["wo"], out), (k_cache, v_cache)


def _attend(q, k_cache, v_cache, cache_len: int, n_heads: int, n_kv: int,
            head_dim: int, attn: str) -> torch.Tensor:
    """Decode's attention core over positions [0, cache_len] of the cache:
    (B, 1, H * D)."""
    B, L = q.shape[0], k_cache.shape[1]
    if attn == "kernel":
        lengths = torch.full((B,), cache_len + 1, dtype=torch.int32,
                             device=q.device)
        return ops.decode_attention(q[:, 0], k_cache, v_cache, lengths
                                    ).reshape(B, 1, -1)
    if attn == "plain":
        groups = n_heads // n_kv
        kc = _expand_kv(k_cache, groups)
        vc = _expand_kv(v_cache, groups)
        scale = 1.0 / math.sqrt(head_dim)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kc).to(torch.float32) * scale
        valid = torch.arange(L, device=q.device) <= cache_len
        s = s.masked_fill(~valid[None, None, None, :], float("-inf"))
        probs = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, vc).reshape(B, 1, -1)
    raise ValueError(f"unknown attn {attn!r} (choices: {ATTNS})")


# --------------------------------------------------------- the mesh path
# Tensor parallelism over ``model`` on rank-local tensors (``dist.spmd``):
# ``x`` is whole on every model rank and enters a column-parallel projection
# (its weight cut over ``model``, ``dist.sharding.lm_param_specs``) through
# ``copy``.  The reference's ``_mdl`` tests the flattened width only, so the
# columns need not split on heads nor the GQA groups on ranks; the core is
# cut by heads or by query rows as ``core_cut`` picks from the shapes, and
# runs whole only where neither divides the axis.  A row-parallel ``wo``
# takes the rank's columns of its input and all-reduces.  Each head and row
# of a cut core is the whole core's arithmetic.  With nothing cut (a model
# axis of one rank) these are ``_qkv`` and ``linear_apply`` exactly.


def core_cut(n_heads: int, seq: int, mesh, col_q: bool, row_o: bool,
             q_chunk: int = 1024) -> str:
    """How a prefill / training attention core is cut over ``model``:

    * ``"heads"`` where the head count divides the axis (``wq``'s columns
      and ``wo``'s rows are then cut on head boundaries): each rank attends
      with its own q heads and the KV heads they belong to;
    * ``"rows"`` where the sequence divides into whole q chunks of
      ``flash_attention`` a rank: each rank attends for its S / model query
      rows against the whole k / v;
    * ``"whole"`` elsewhere (and on a model axis of one rank).

    Shapes alone decide, so every rank picks the same."""
    n = mesh.shape.get("model", 1)
    if n == 1:
        return "whole"
    if col_q and row_o and n_heads % n == 0:
        return "heads"
    rows = seq // n
    if seq % n == 0 and (rows <= q_chunk or rows % q_chunk == 0):
        return "rows"
    return "whole"


def tp_qkv(p, x, n_heads, n_kv, head_dim, cos, sin, positions, mesh,
           col_q: bool, col_kv: bool, cut: str = "whole"):
    """q, k, v of the mesh path.  k / v are whole on every rank; q too,
    but under the ``"heads"`` cut, where it is the rank's own heads (its
    columns of ``wq``, not gathered).  Where the ranks' cores differ
    (``cut`` is not ``"whole"``), a gathered projection's backward sums
    the ranks' gradients before it takes the rank's block, and a whole one
    enters through ``copy``."""
    B, S, _ = x.shape
    xf = spmd.copy(x, mesh, "model") if (col_q or col_kv) else x
    differ = cut != "whole"

    def proj(name, n, col):
        if not col:
            y = linear_apply(p[name], x)
            if differ:
                y = spmd.copy(y, mesh, "model")
            return y.reshape(B, S, n, head_dim)
        y = linear_apply(p[name], xf)
        if name == "wq" and cut == "heads":
            return y.reshape(B, S, -1, head_dim)
        gather = spmd.gather_sum if differ else spmd.gather
        return gather(y, mesh, "model", -1).reshape(B, S, n, head_dim)
    q = apply_rope(proj("wq", n_heads, col_q), cos, sin, positions)
    k = apply_rope(proj("wk", n_kv, col_kv), cos, sin, positions)
    return q, k, proj("wv", n_kv, col_kv)


def tp_out(p, out: torch.Tensor, mesh, row_o: bool,
           mine: bool = False) -> torch.Tensor:
    """``wo`` of the mesh path; ``mine``: ``out`` is already the rank's
    columns of its input (the ``"heads"`` cut)."""
    if not row_o:
        return linear_apply(p["wo"], out)
    if not mine:
        out = spmd.split(out, mesh, "model", out.dim() - 1)
    return spmd.all_reduce(linear_apply(p["wo"], out), mesh, "model")


def _head_core(q, k, v, mesh, n_heads: int, n_kv: int, **kw):
    """The ``"heads"`` cut: q (B, S, H / model, D) the rank's heads, k / v
    (B, S, n_kv, D) whole; the core over the KV heads q's heads belong to
    (head h to ``h // (n_heads // n_kv)``), GQA-native where the rank's
    heads are whole groups or lie inside one group."""
    hr, groups = q.shape[2], n_heads // n_kv
    h0 = mesh.coord("model") * hr
    if hr % groups == 0 or groups % hr == 0:
        k, v = (t.narrow(2, h0 // groups, max(hr // groups, 1))
                for t in (k, v))
    else:
        idx = torch.arange(h0, h0 + hr, device=k.device) // groups
        k, v = (t.index_select(2, idx) for t in (k, v))
    return flash_attention(q, k, v, **kw)


def _row_core(q, k, v, mesh, **kw):
    """The ``"rows"`` cut: the core for the rank's S / model query rows
    against the whole k / v, the rows then all-gathered over ``model``."""
    rows = q.shape[1] // mesh.shape["model"]
    lo = mesh.coord("model") * rows
    out = flash_attention(q.narrow(1, lo, rows), k, v, q_offset=lo, **kw)
    return spmd.gather(out, mesh, "model", 1)


def tp_prefill_attention(p, x, n_heads, n_kv, head_dim, cos, sin, mesh,
                         col_q: bool, col_kv: bool, row_o: bool,
                         window: Optional[int] = None,
                         q_chunk: int = 1024, kv_chunk: int = 512):
    """``prefill_attention`` (and ``causal_attention``, the output alone)
    on the mesh path, its core cut as ``core_cut`` picks: the caches (B, S,
    n_kv, D) whole."""
    B, S, _ = x.shape
    cut = core_cut(n_heads, S, mesh, col_q, row_o, q_chunk)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = tp_qkv(p, x, n_heads, n_kv, head_dim, cos, sin, positions,
                     mesh, col_q, col_kv, cut)
    kw = dict(causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk, window=window)
    if cut == "heads":
        out = _head_core(q, k, v, mesh, n_heads, n_kv, **kw)
    elif cut == "rows":
        out = _row_core(q, k, v, mesh, **kw)
    else:
        out = flash_attention(q, k, v, **kw)
    return tp_out(p, out, mesh, row_o, mine=cut == "heads"), (k, v)


def tp_decode_attention(p, x, kv_cache, cache_len: int, n_heads: int,
                        n_kv: int, head_dim: int, cos, sin, mesh,
                        col_q: bool, col_kv: bool, row_o: bool,
                        seq_axes: tuple, attn: str = "kernel"):
    """``decode_attention`` on the mesh path.  The cache holds the rank's
    window of the sequence over ``seq_axes`` (``LMBundle._cache_spec``:
    ``model``, or every axis when the batch does not divide the batch
    axes): the new token's KV is written by the rank whose window holds
    ``cache_len``; with one window the core is ``decode_attention``'s (the
    kernel on the card), else each rank reduces its window for every head
    and the LSE merge of ``dist.attention`` combines them."""
    from ..dist.attention import lse_merge_decode
    B = x.shape[0]
    k_cache, v_cache = kv_cache
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = tp_qkv(p, x, n_heads, n_kv, head_dim, cos, sin,
                             positions, mesh, col_q, col_kv)
    Sl = k_cache.shape[1]
    off = mesh.index(seq_axes) * Sl
    if off <= cache_len < off + Sl:
        insert_kv(k_cache, k_new, cache_len - off)
        insert_kv(v_cache, v_new, cache_len - off)
    group = mesh.group(seq_axes)
    if group is None:
        out = _attend(q, k_cache, v_cache, cache_len, n_heads, n_kv,
                      head_dim, attn)
    else:
        groups = n_heads // n_kv
        lens = torch.full((B,), cache_len + 1, dtype=torch.int32,
                          device=x.device)
        out = lse_merge_decode(q[:, 0], _expand_kv(k_cache, groups),
                               _expand_kv(v_cache, groups), lens, group,
                               off).reshape(B, 1, -1)
    return tp_out(p, out, mesh, row_o), (k_cache, v_cache)
