"""Block-ELL SpMM for Hopper: the wrapper of ``csrc/spmm_blockell_compact.cu``.

``spmm_blockell_compact`` is the port of the Pallas TPU kernel of the same
name (``repro/kernels/spmm_blockell.py``): the fused
``s_out ⊙ (A (s_in ⊙ x) [+ s_in ⊙ x])`` over only the active row-major
slots of a block-ELL compaction.  On a CUDA tensor it launches the
hand-written kernel (built on first use, see ``_build``) or raises; on a
CPU tensor it runs the plain version in ``ref.py``.  There is no fallback
from the one to the other.

The port drops the TPU layout padding: x keeps its own row count and width
(no 128-lane d, no C*bk rows), s_in / s_out are 1-D, and the kernel walks
each destination block's slots through ``row_offsets`` instead of relying
on a sequential grid.  ``spmm_blockell_compact.launches`` counts kernel
launches (a plain integer; the plain version does not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import spmm_blockell_compact_ref

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("spmm_blockell_compact").spmm_blockell_compact
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name: str, t: torch.Tensor, dtypes, ndim: int,
           device: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spmm_blockell_compact(row_offsets: torch.Tensor, cols: torch.Tensor,
                          blocks: torch.Tensor, x: torch.Tensor,
                          s_in: torch.Tensor, s_out: torch.Tensor,
                          x_diag: Optional[torch.Tensor] = None,
                          s_in_diag: Optional[torch.Tensor] = None, *,
                          bm: int, bk: int, add_diag: bool) -> torch.Tensor:
    """Slot-compacted fused SpMM; returns (n_dst, d) float32.

    row_offsets: (R + 1,) int32 with R = ceil(n_dst / bm); cols:
    (n_active,) int32 source blocks, sorted row-major; blocks:
    (n_active, bm, bk) uint8 (exact 0/1 bitmask) or float32; x: (n_src, d)
    float32; s_in: (n_src,); s_out: (n_dst,).  With ``add_diag`` (square
    blocks only) the self term ``s_in_diag ⊙ x_diag`` seeds each row; they
    default to s_in and x.  Offsets and block ids come from a
    ``BlockCompaction``, which keeps them in range.  Rows of destination
    blocks with no active slot are left unwritten by the kernel.
    """
    dev = x.device
    f32 = (torch.float32,)
    i32 = (torch.int32,)
    _check("x", x, f32, 2, dev)
    _check("row_offsets", row_offsets, i32, 1, dev)
    _check("cols", cols, i32, 1, dev)
    _check("blocks", blocks, (torch.uint8, torch.float32), 3, dev)
    _check("s_in", s_in, f32, 1, dev)
    _check("s_out", s_out, f32, 1, dev)
    n_src, d = x.shape
    n_dst = s_out.shape[0]
    n_active = cols.shape[0]
    R = row_offsets.shape[0] - 1
    if n_active == 0:
        raise ValueError("empty compaction; caller handles n_active == 0")
    if tuple(blocks.shape) != (n_active, bm, bk):
        raise ValueError(f"blocks must be ({n_active}, {bm}, {bk}), got "
                         f"{tuple(blocks.shape)}")
    if s_in.shape[0] != n_src:
        raise ValueError(f"s_in has {s_in.shape[0]} rows, x has {n_src}")
    if R != max(-(-n_dst // bm), 1):
        raise ValueError(f"row_offsets has {R} row blocks; {n_dst} rows at "
                         f"bm={bm} need {max(-(-n_dst // bm), 1)}")
    if d == 0:
        raise ValueError("x has no feature columns")
    if add_diag:
        if bm != bk:
            raise ValueError("add_diag requires square blocks (bm == bk)")
        x_diag = x if x_diag is None else x_diag
        s_in_diag = s_in if s_in_diag is None else s_in_diag
        _check("x_diag", x_diag, f32, 2, dev)
        _check("s_in_diag", s_in_diag, f32, 1, dev)
        if x_diag.shape[0] < n_dst or x_diag.shape[1] != d \
                or s_in_diag.shape[0] < n_dst:
            raise ValueError(f"x_diag / s_in_diag must cover {n_dst} rows "
                             f"of width {d}")
    if dev.type == "cpu":
        return spmm_blockell_compact_ref(
            row_offsets, cols, blocks, x, s_in, s_out, x_diag, s_in_diag,
            bm=bm, bk=bk, add_diag=add_diag)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    fn = _kernel_fn()
    y = torch.empty((n_dst, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(row_offsets.data_ptr(), cols.data_ptr(), blocks.data_ptr(),
                 x.data_ptr(), s_in.data_ptr(), s_out.data_ptr(),
                 x_diag.data_ptr() if add_diag else None,
                 s_in_diag.data_ptr() if add_diag else None,
                 y.data_ptr(), int(blocks.dtype == torch.uint8), R, n_src,
                 n_dst, bm, bk, d, int(add_diag), stream)
    if err:
        raise RuntimeError(f"spmm_blockell_compact launch failed: "
                           f"cudaError {err}")
    spmm_blockell_compact.launches += 1
    return y


spmm_blockell_compact.launches = 0
