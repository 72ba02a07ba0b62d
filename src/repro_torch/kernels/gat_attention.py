"""GAT's edge-softmax attention over per-row entry lists, for Hopper: the
wrappers of ``csrc/gat_attention.cu`` (forward) and
``csrc/gat_attention_bwd.cu`` (backward).  The TPU package has no such
kernel: its GAT runs segment ops (``repro/models/gat.py``).

Per destination row v and head h, over v's entries j:
``e_vj = LeakyReLU(s_dst[v, h] + s_src[j, h])``, ``out[v, h] = Σ_j
softmax_j(e)_vj z[j, h]``, and ``lse[v, h]``, the log of the softmax's sum,
which the backward takes in place of any per-entry tensor.  The lists are
:class:`~.spmm_blockell.Lists` from :func:`~.spmm_blockell.list_arrays`
(hubs and the walk's order as the block-ELL list walk takes them) over a
``core.blocksparse.AttentionLists``: the forward lists, and for the
backward the transposed lists with each entry's forward place.

On a CUDA tensor each wrapper launches its kernels (built on first use) or
raises; on a CPU tensor it runs the plain version in ``ref.py``.  Each
wrapper's ``launches`` counts its calls on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import gat_attention_bwd_ref, gat_attention_ref
from .spmm_blockell import Lists, _check, _raise_on

_F32 = (torch.float32,)
_I32 = (torch.int32,)
# the backward sums each row's heads in registers (csrc kMaxHeads)
MAX_HEADS = 8


def _kernel_fn(name: str):
    """The ctypes entry point of ``csrc/<name>.cu``."""
    arity = {"gat_attention": (9, 4), "gat_attention_bwd": (16, 5)}[name]
    return _build.entry(name, *arity, tail=(ctypes.c_float,))


def _check_lists(name: str, lists: Lists, n_rows: int, dev) -> None:
    _check(f"{name}.row_ptr", lists.row_ptr, _I32, 1, dev)
    _check(f"{name}.src", lists.src, _I32, 1, dev)
    _check(f"{name}.hubs", lists.hubs, _I32, 1, dev)
    if lists.order is not None:
        _check(f"{name}.order", lists.order, _I32, 1, dev)
    if lists.coef is not None:
        raise ValueError(f"{name}: attention lists carry no coefficients")
    if lists.row_ptr.shape[0] != n_rows + 1:
        raise ValueError(f"{name}.row_ptr has {lists.row_ptr.shape[0] - 1} "
                         f"rows, expected {n_rows}")


def _check_scores(z, s_src, s_dst):
    dev = z.device
    _check("z", z, _F32, 3, dev)
    _check("s_src", s_src, _F32, 2, dev)
    _check("s_dst", s_dst, _F32, 2, dev)
    n, H, F = z.shape
    if tuple(s_src.shape) != (n, H):
        raise ValueError(f"s_src must be {(n, H)}, got {tuple(s_src.shape)}")
    if s_dst.shape[1] != H:
        raise ValueError(f"s_dst has {s_dst.shape[1]} heads, z has {H}")
    if F == 0 or H == 0:
        raise ValueError("z has no heads or no columns")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gat_attention(lists: Lists, z: torch.Tensor, s_src: torch.Tensor,
                  s_dst: torch.Tensor, *, negative_slope: float = 0.2):
    """``(out (n_dst, H, F), lse (n_dst, H))`` of the attention over the
    forward ``lists`` (n_dst rows of sources into z's n_src rows); z:
    (n_src, H, F), s_src: (n_src, H), s_dst: (n_dst, H), float32."""
    _check_scores(z, s_src, s_dst)
    n_dst, H = s_dst.shape
    _check_lists("lists", lists, n_dst, z.device)
    if z.device.type == "cpu":
        return gat_attention_ref(lists.row_ptr, lists.src, z, s_src, s_dst,
                                 negative_slope=negative_slope)
    F = z.shape[2]
    out = torch.empty((n_dst, H, F), dtype=torch.float32, device=z.device)
    lse = torch.empty((n_dst, H), dtype=torch.float32, device=z.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(z.device):
        err = _kernel_fn("gat_attention")(
            lists.row_ptr.data_ptr(), lists.src.data_ptr(),
            lists.hubs.data_ptr(), ptr(lists.order), z.data_ptr(),
            s_src.data_ptr(), s_dst.data_ptr(), out.data_ptr(),
            lse.data_ptr(), lists.hubs.shape[0], n_dst, H, F,
            float(negative_slope), _stream(z.device))
    _raise_on(err, "gat_attention")
    gat_attention.launches += 1
    return out, lse


gat_attention.launches = 0


def gat_attention_bwd(lists: Lists, lists_t: Lists, fwd_pos: torch.Tensor,
                      z: torch.Tensor, s_src: torch.Tensor,
                      s_dst: torch.Tensor, lse: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, *,
                      negative_slope: float = 0.2):
    """``(dz, ds_src, ds_dst)`` of :func:`gat_attention` given ``dout``:
    ``lists`` the forward lists, ``lists_t`` the transposed ones (row j
    lists the rows that list j; their ``src`` holds those rows) and
    ``fwd_pos`` each transposed entry's place among the forward entries.
    Each row's term ``Σ_F dout ⊙ out`` is computed once here."""
    _check_scores(z, s_src, s_dst)
    dev = z.device
    n_src, H, F = z.shape
    n_dst = s_dst.shape[0]
    _check_lists("lists", lists, n_dst, dev)
    _check_lists("lists_t", lists_t, n_src, dev)
    _check("fwd_pos", fwd_pos, _I32, 1, dev)
    for name, t, shape in (("lse", lse, (n_dst, H)),
                           ("out", out, (n_dst, H, F)),
                           ("dout", dout, (n_dst, H, F))):
        _check(name, t, _F32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    nnz = lists.src.shape[0]
    if lists_t.src.shape[0] != nnz or fwd_pos.shape[0] != nnz:
        raise ValueError("the two directions' lists differ in entries")
    row_dot = torch.sum(dout * out, dim=-1)
    if dev.type == "cpu":
        return gat_attention_bwd_ref(
            lists.row_ptr, lists_t.row_ptr, lists_t.src, fwd_pos, z, s_src,
            s_dst, lse, row_dot, dout, negative_slope=negative_slope)
    if H > MAX_HEADS:
        raise ValueError(f"the backward kernel takes at most {MAX_HEADS} "
                         f"heads, got {H}")
    dz = torch.empty_like(z)
    ds_src = torch.empty_like(s_src)
    ds_dst = torch.empty_like(s_dst)
    scratch = torch.empty((nnz, H), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _kernel_fn("gat_attention_bwd")(
            lists.row_ptr.data_ptr(), lists_t.row_ptr.data_ptr(),
            lists_t.src.data_ptr(), lists_t.hubs.data_ptr(),
            ptr(lists_t.order), fwd_pos.data_ptr(), z.data_ptr(),
            s_src.data_ptr(), s_dst.data_ptr(), lse.data_ptr(),
            row_dot.data_ptr(), dout.data_ptr(), dz.data_ptr(),
            ds_src.data_ptr(), ds_dst.data_ptr(), scratch.data_ptr(),
            lists_t.hubs.shape[0], n_src, n_dst, H, F,
            float(negative_slope), _stream(dev))
    _raise_on(err, "gat_attention_bwd")
    gat_attention_bwd.launches += 1
    return dz, ds_src, ds_dst


gat_attention_bwd.launches = 0
