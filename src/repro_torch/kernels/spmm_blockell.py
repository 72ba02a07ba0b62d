"""Block-ELL kernels for Hopper: the wrappers of ``csrc/*.cu``.

Each is the port of the Pallas TPU kernel of the same name
(``repro/kernels/spmm_blockell.py``).  ``spmm_blockell_compact``: the fused
``s_out ⊙ (A (s_in ⊙ x) [+ s_in ⊙ x])`` over only the active row-major
slots of a block-ELL compaction.  ``spmm_blockell_update_compact``: the
one-launch layer, the same aggregation followed, in the same launch, by
``@ W [+ c · x_self @ W_self] + b`` and an optional ReLU.
Both compact wrappers also take ``lists=`` (a :class:`Lists`) in place of
the tiles: per destination row, the entries a walk over its tiles would
find (``core.blocksparse.row_lists``), which their kernels' list walk
reads directly (``csrc/spmm_blockell_lists.cu``,
``csrc/spmm_blockell_update_lists.cu``); a call counts once on the same
``launches``, with its hub pass where the lists have hubs.
``spmm_blockell``, ``spmm_blockell_fused`` and ``spmm_blockell_update``:
the padded twins over the (R, W) slot table, padding slots (``col < 0``)
skipped and every row written.
On a CUDA tensor each wrapper launches its hand-written kernel (built on
first use, see ``_build``) or raises; on a CPU tensor it runs the plain
version in ``ref.py``.  There is no fallback from the one to the other.

The port drops the TPU layout padding: x keeps its own row count and width
(no 128-lane d, no C*bk rows), W keeps (d_in, d_out), the scales are 1-D,
and the kernels walk each destination block's slots (through
``row_offsets``, or along ``block_cols[r]``) instead of relying on a
sequential grid.  Each wrapper's
``launches`` attribute counts its kernel launches (a plain integer; the
plain version does not count).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .ref import (spmm_blockell_compact_ref, spmm_blockell_fused_ref,
                  spmm_blockell_lists_ref, spmm_blockell_ref,
                  spmm_blockell_update_compact_ref,
                  spmm_blockell_update_lists_ref, spmm_blockell_update_ref)

# the list walk's geometry: a row of more entries than HUB_ENTRIES is a hub,
# which the walk sums with a CUDA block of its own before the walk
# (csrc/blockell_hubs.cuh; the scan's kCap, csrc/blockell_scan.cuh); the
# spmm list walk takes WALK_ROWS consecutive rows a CUDA block
# (csrc/blockell_spmm.cuh kWarps), in the order of the longest row first
# where one of them holds more than LONG_ROW entries
HUB_ENTRIES = 512
WALK_ROWS = 4
LONG_ROW = 64


class Lists(NamedTuple):
    """Per-row entry lists on the device, as the list walk takes them: the
    arrays :func:`list_arrays` builds on the host, copied to the device
    (:meth:`of`).  ``hubs`` has no default: a walk that met a hub it was
    not told of would read scratch that does not exist."""
    row_ptr: torch.Tensor                  # (n_dst + 1,) int32
    src: torch.Tensor                      # (nnz,) int32
    hubs: torch.Tensor                     # rows of > HUB_ENTRIES, ascending
    coef: Optional[torch.Tensor] = None    # (nnz,) float32; None: every 1
    order: Optional[torch.Tensor] = None   # spmm walk's blocks of WALK_ROWS
                                           # rows, longest row first

    @classmethod
    def of(cls, a: Dict[str, torch.Tensor]) -> "Lists":
        """The lists of a dict holding :func:`list_arrays`' keys."""
        return cls(a["row_ptr"], a["src"], a["hubs"], a.get("coef"),
                   a.get("order"))


def list_arrays(row_ptr: np.ndarray, src: np.ndarray,
                coef: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Per-row entry lists (``row_ptr``, ``src``, ``coef`` where not every
    coefficient is 1: the arrays of a ``core.blocksparse.RowLists``) with
    how the list walk takes their rows: ``hubs``, the rows of more than
    ``HUB_ENTRIES`` entries (summed apart, by a CUDA block each; empty if
    none), and, where a row of the rest holds more than ``LONG_ROW``,
    ``order``, the walk's blocks of ``WALK_ROWS`` rows longest row first (a
    long row started last would end the launch alone).  Neither changes a
    sum's order."""
    out = {"row_ptr": row_ptr, "src": src}
    if coef is not None:
        out["coef"] = coef
    n_rows = np.diff(row_ptr)
    out["hubs"] = np.flatnonzero(n_rows > HUB_ENTRIES).astype(np.int32)
    walked = np.where(n_rows > HUB_ENTRIES, 0, n_rows)
    blocks = np.zeros(-(-walked.size // WALK_ROWS) * WALK_ROWS, np.int64)
    blocks[:walked.size] = walked
    longest = blocks.reshape(-1, WALK_ROWS).max(axis=1, initial=0)
    if longest.max(initial=0) > LONG_ROW:
        out["order"] = np.argsort(-longest, kind="stable").astype(np.int32)
    return out


_F32 = (torch.float32,)
_I32 = (torch.int32,)
# name -> (pointer arguments, int arguments) of its C entry point
_ARITY = {"spmm_blockell_compact": (9, 8),
          "spmm_blockell_update_compact": (14, 10),
          "spmm_blockell_lists": (12, 5),
          "spmm_blockell_update_lists": (16, 7),
          "spmm_blockell": (4, 8),
          "spmm_blockell_fused": (6, 9),
          "spmm_blockell_update": (10, 11)}


def _kernel_fn(name: str):
    """The ctypes entry point of ``csrc/<name>.cu``."""
    return _build.entry(name, *_ARITY[name])


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


def _check_aggregation(row_offsets, cols, blocks, x, s_in, s_out, x_diag,
                       s_in_diag, bm: int, bk: int, add_diag: bool,
                       lists: Optional[Lists] = None):
    """The checks both kernels share, over tiles or ``lists``; returns
    ``(R, x_diag, s_in_diag)`` with the self-term operands defaulted to x
    and s_in (R: tile row blocks, n_dst + 1 row pointers less one)."""
    dev = x.device
    _check("x", x, _F32, 2, dev)
    _check("s_in", s_in, _F32, 1, dev)
    _check("s_out", s_out, _F32, 1, dev)
    n_src, d = x.shape
    n_dst = s_out.shape[0]
    if lists is None:
        _check("row_offsets", row_offsets, _I32, 1, dev)
        _check("cols", cols, _I32, 1, dev)
        _check("blocks", blocks, (torch.uint8, torch.float32), 3, dev)
        n_active = cols.shape[0]
        R = row_offsets.shape[0] - 1
        if n_active == 0:
            raise ValueError("empty compaction; caller handles n_active == 0")
        if tuple(blocks.shape) != (n_active, bm, bk):
            raise ValueError(f"blocks must be ({n_active}, {bm}, {bk}), got "
                             f"{tuple(blocks.shape)}")
        if R != max(-(-n_dst // bm), 1):
            raise ValueError(f"row_offsets has {R} row blocks; {n_dst} rows "
                             f"at bm={bm} need {max(-(-n_dst // bm), 1)}")
    else:
        if not (row_offsets is None and cols is None and blocks is None):
            raise ValueError("pass tiles or lists, not both")
        row_ptr, src, hubs, coef, order = lists
        _check("row_ptr", row_ptr, _I32, 1, dev)
        _check("src", src, _I32, 1, dev)
        if not torch.is_tensor(hubs):
            raise ValueError("lists without hubs (list_arrays finds them)")
        _check("hubs", hubs, _I32, 1, dev)
        if order is not None:
            _check("order", order, _I32, 1, dev)
        if coef is not None:
            _check("coef", coef, _F32, 1, dev)
            if coef.shape != src.shape:
                raise ValueError(f"coef has {coef.shape[0]} entries, src "
                                 f"has {src.shape[0]}")
        R = row_ptr.shape[0] - 1
        if R != n_dst:
            raise ValueError(f"row_ptr has {R} rows, s_out has {n_dst}")
    if s_in.shape[0] != n_src:
        raise ValueError(f"s_in has {s_in.shape[0]} rows, x has {n_src}")
    if d == 0:
        raise ValueError("x has no feature columns")
    if add_diag:
        if bm != bk:
            raise ValueError("add_diag requires square blocks (bm == bk)")
        x_diag = x if x_diag is None else x_diag
        s_in_diag = s_in if s_in_diag is None else s_in_diag
        _check("x_diag", x_diag, _F32, 2, dev)
        _check("s_in_diag", s_in_diag, _F32, 1, dev)
        if x_diag.shape[0] < n_dst or x_diag.shape[1] != d \
                or s_in_diag.shape[0] < n_dst:
            raise ValueError(f"x_diag / s_in_diag must cover {n_dst} rows "
                             f"of width {d}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return R, x_diag, s_in_diag


def _check_epilogue(x, w, bias, w_self, self_coeff, bm: int, bk: int
                    ) -> int:
    """The checks of the layer kernels' W epilogue; returns d_out."""
    dev = x.device
    d_in = x.shape[1]
    _check("w", w, _F32, 2, dev)
    if w.shape[0] != d_in:
        raise ValueError(f"w has {w.shape[0]} rows, x has {d_in} columns")
    d_out = w.shape[1]
    if d_out == 0:
        raise ValueError("w has no output columns")
    if bias is not None:
        _check("bias", bias, _F32, 1, dev)
        if bias.shape[0] != d_out:
            raise ValueError(f"bias has {bias.shape[0]} entries, w has "
                             f"{d_out} columns")
    if w_self is None:
        if self_coeff is not None:
            raise ValueError("self_coeff needs w_self")
    else:
        if bm != bk:
            raise ValueError("w_self requires square blocks (bm == bk)")
        _check("w_self", w_self, _F32, 2, dev)
        if w_self.shape != w.shape:
            raise ValueError(f"w_self must be {tuple(w.shape)}, got "
                             f"{tuple(w_self.shape)}")
        if self_coeff is not None:
            _check("self_coeff", self_coeff, _F32, 0, dev)
    return d_out


def _check_padded(block_cols, blocks, x, bm: int, bk: int, n_dst: int):
    """The checks the padded kernels share; returns ``(R, W)``."""
    dev = x.device
    _check("x", x, _F32, 2, dev)
    _check("block_cols", block_cols, _I32, 2, dev)
    _check("blocks", blocks, (torch.uint8, torch.float32), 4, dev)
    R, W = block_cols.shape
    if tuple(blocks.shape) != (R, W, bm, bk):
        raise ValueError(f"blocks must be ({R}, {W}, {bm}, {bk}), got "
                         f"{tuple(blocks.shape)}")
    if R != max(-(-n_dst // bm), 1):
        raise ValueError(f"block_cols has {R} row blocks; {n_dst} rows at "
                         f"bm={bm} need {max(-(-n_dst // bm), 1)}")
    if x.shape[1] == 0:
        raise ValueError("x has no feature columns")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return R, W


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _lists_args(lists: Lists, d: int, order: bool):
    """The list walk's pointer arguments (row_ptr, src, coef, hubs, with
    ``order`` the order, and (n_hubs, d) of scratch for the hubs' sums),
    n_hubs and the scratch."""
    n_hubs = lists.hubs.shape[0]
    acc = (torch.empty((n_hubs, d), dtype=torch.float32,
                       device=lists.src.device) if n_hubs else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = (lists.row_ptr.data_ptr(), lists.src.data_ptr(), ptr(lists.coef),
            lists.hubs.data_ptr()) + ((ptr(lists.order),) if order else ())
    return ptrs + (ptr(acc),), n_hubs, acc


def spmm_blockell_compact(row_offsets: Optional[torch.Tensor],
                          cols: Optional[torch.Tensor],
                          blocks: Optional[torch.Tensor], x: torch.Tensor,
                          s_in: torch.Tensor, s_out: torch.Tensor,
                          x_diag: Optional[torch.Tensor] = None,
                          s_in_diag: Optional[torch.Tensor] = None, *,
                          bm: int, bk: int, add_diag: bool,
                          lists: Optional[Lists] = None) -> torch.Tensor:
    """Slot-compacted fused SpMM; returns (n_dst, d) float32.

    row_offsets: (R + 1,) int32 with R = ceil(n_dst / bm); cols:
    (n_active,) int32 source blocks, sorted row-major; blocks:
    (n_active, bm, bk) uint8 (exact 0/1 bitmask) or float32; x: (n_src, d)
    float32; s_in: (n_src,); s_out: (n_dst,).  With ``add_diag`` (square
    blocks only) the self term ``s_in_diag ⊙ x_diag`` seeds each row; they
    default to s_in and x.  Offsets and block ids come from a
    ``BlockCompaction``, which keeps them in range.  Rows of destination
    blocks with no active slot are left unwritten by the kernel.

    ``lists`` (a :class:`Lists`) replaces the tiles (row_offsets, cols and
    blocks then None): the arrays of :func:`list_arrays` over a
    ``core.blocksparse.RowLists``, which keeps them in range.  The list
    walk writes every row, a row with no entry its self term or zero.
    """
    R, x_diag, s_in_diag = _check_aggregation(
        row_offsets, cols, blocks, x, s_in, s_out, x_diag, s_in_diag, bm, bk,
        add_diag, lists)
    if x.device.type == "cpu":
        if lists is not None:
            return spmm_blockell_lists_ref(
                lists.row_ptr, lists.src, lists.coef, x, s_in, s_out, x_diag,
                s_in_diag, add_diag=add_diag)
        return spmm_blockell_compact_ref(
            row_offsets, cols, blocks, x, s_in, s_out, x_diag, s_in_diag,
            bm=bm, bk=bk, add_diag=add_diag)
    n_src, d = x.shape
    n_dst = s_out.shape[0]
    y = torch.empty((n_dst, d), dtype=torch.float32, device=x.device)
    xd, sd = ((x_diag.data_ptr(), s_in_diag.data_ptr()) if add_diag
              else (None, None))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if lists is None:
            err = _kernel_fn("spmm_blockell_compact")(
                row_offsets.data_ptr(), cols.data_ptr(), blocks.data_ptr(),
                x.data_ptr(), s_in.data_ptr(), s_out.data_ptr(), xd, sd,
                y.data_ptr(), int(blocks.dtype == torch.uint8), R, n_src,
                n_dst, bm, bk, d, int(add_diag), stream)
        else:
            ptrs, n_hubs, _hub_acc = _lists_args(lists, d, order=True)
            err = _kernel_fn("spmm_blockell_lists")(
                *ptrs, x.data_ptr(), s_in.data_ptr(), s_out.data_ptr(), xd,
                sd, y.data_ptr(), n_hubs, n_src, n_dst, d, int(add_diag),
                stream)
    _raise_on(err, "spmm_blockell_compact")
    spmm_blockell_compact.launches += 1
    return y


spmm_blockell_compact.launches = 0


def spmm_blockell_update_compact(
        row_offsets: Optional[torch.Tensor], cols: Optional[torch.Tensor],
        blocks: Optional[torch.Tensor],
        x: torch.Tensor, s_in: torch.Tensor, s_out: torch.Tensor,
        w: torch.Tensor, bias: Optional[torch.Tensor] = None,
        w_self: Optional[torch.Tensor] = None,
        self_coeff: Optional[torch.Tensor] = None,
        x_self: Optional[torch.Tensor] = None,
        x_diag: Optional[torch.Tensor] = None,
        s_in_diag: Optional[torch.Tensor] = None, *, bm: int, bk: int,
        add_diag: bool, relu: bool = False,
        lists: Optional[Lists] = None) -> torch.Tensor:
    """Slot-compacted fused LAYER; returns (n_dst, d_out) float32.

    The aggregation of :func:`spmm_blockell_compact` at width d_in, then in
    the same launch ``(s_out ⊙ acc) @ w + c · (x_self @ w_self) + bias`` and
    ReLU when ``relu``.  w: (d_in, d_out); bias: (d_out,) or None; w_self:
    (d_in, d_out) or None and may be ``w`` itself; self_coeff: a 0-d float32
    tensor on x's device (c = 1 when None; needs w_self); x_self:
    (>= n_dst, d_in), defaults to x (needs w_self).  The self term needs
    square blocks.  Rows of destination blocks with no active slot are left
    unwritten by the kernel.  ``lists`` replaces the tiles as in
    :func:`spmm_blockell_compact`; the list walk writes every row.
    """
    R, x_diag, s_in_diag = _check_aggregation(
        row_offsets, cols, blocks, x, s_in, s_out, x_diag, s_in_diag, bm, bk,
        add_diag, lists)
    dev = x.device
    n_src, d_in = x.shape
    n_dst = s_out.shape[0]
    if w_self is None and x_self is not None:
        raise ValueError("x_self needs w_self")
    d_out = _check_epilogue(x, w, bias, w_self, self_coeff, bm, bk)
    if w_self is not None:
        x_self = x if x_self is None else x_self
        _check("x_self", x_self, _F32, 2, dev)
        if x_self.shape[0] < n_dst or x_self.shape[1] != d_in:
            raise ValueError(f"x_self must cover {n_dst} rows of width "
                             f"{d_in}")
    if dev.type == "cpu":
        if lists is not None:
            return spmm_blockell_update_lists_ref(
                lists.row_ptr, lists.src, lists.coef, x, s_in, s_out, w, bias,
                w_self, self_coeff, x_self, x_diag, s_in_diag,
                add_diag=add_diag, relu=relu)
        return spmm_blockell_update_compact_ref(
            row_offsets, cols, blocks, x, s_in, s_out, w, bias, w_self,
            self_coeff, x_self, x_diag, s_in_diag, bm=bm, bk=bk,
            add_diag=add_diag, relu=relu)
    ptr = lambda t: None if t is None else t.data_ptr()
    y = torch.empty((n_dst, d_out), dtype=torch.float32, device=dev)
    operands = (x.data_ptr(), s_in.data_ptr(), s_out.data_ptr(), w.data_ptr(),
                ptr(bias), ptr(w_self), ptr(self_coeff), ptr(x_self),
                ptr(x_diag), ptr(s_in_diag), y.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lists is None:
            err = _kernel_fn("spmm_blockell_update_compact")(
                row_offsets.data_ptr(), cols.data_ptr(), blocks.data_ptr(),
                *operands, int(blocks.dtype == torch.uint8), R, n_src, n_dst,
                bm, bk, d_in, d_out, int(add_diag), int(relu), stream)
        else:
            ptrs, n_hubs, _hub_acc = _lists_args(lists, d_in, order=False)
            err = _kernel_fn("spmm_blockell_update_lists")(
                *ptrs, *operands, n_hubs, n_src, n_dst, d_in, d_out,
                int(add_diag), int(relu), stream)
    _raise_on(err, "spmm_blockell_update_compact")
    spmm_blockell_update_compact.launches += 1
    return y


spmm_blockell_update_compact.launches = 0


# ---------------------------------------------------------------------------
# the padded (R, W) slot grid
# ---------------------------------------------------------------------------
def spmm_blockell(block_cols: torch.Tensor, blocks: torch.Tensor,
                  x: torch.Tensor, *, bm: int, bk: int,
                  n_dst: Optional[int] = None) -> torch.Tensor:
    """Padded ``y = A x``; returns (n_dst, d) float32, every row written.

    block_cols: (R, W) int32 source blocks, -1 for a padding slot (ids come
    from a ``BlockEll``, which keeps them below ceil(n_src / bk)); blocks:
    (R, W, bm, bk) uint8 or float32; x: (n_src, d) float32; n_dst defaults
    to R * bm.
    """
    R = block_cols.shape[0]
    n_dst = R * bm if n_dst is None else n_dst
    R, W = _check_padded(block_cols, blocks, x, bm, bk, n_dst)
    if x.device.type == "cpu":
        return spmm_blockell_ref(block_cols, blocks, x, bm=bm, bk=bk,
                                 n_dst=n_dst)
    n_src, d = x.shape
    fn = _kernel_fn("spmm_blockell")
    y = torch.empty((n_dst, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                 y.data_ptr(), int(blocks.dtype == torch.uint8), R, W, n_src,
                 n_dst, bm, bk, d, stream)
    _raise_on(err, "spmm_blockell")
    spmm_blockell.launches += 1
    return y


spmm_blockell.launches = 0


def spmm_blockell_fused(block_cols: torch.Tensor, blocks: torch.Tensor,
                        x: torch.Tensor, s_in: torch.Tensor,
                        s_out: torch.Tensor, *, bm: int, bk: int,
                        add_diag: bool) -> torch.Tensor:
    """Padded fused SpMM ``s_out ⊙ (A (s_in ⊙ x) [+ s_in ⊙ x])``; returns
    (n_dst, d) float32 with n_dst = len(s_out), every row written (rows of
    blocks with no active slot get the self term or zero).

    As :func:`spmm_blockell` plus s_in: (n_src,) and s_out: (n_dst,).  The
    self term needs square blocks.
    """
    n_dst = s_out.shape[0]
    R, W = _check_padded(block_cols, blocks, x, bm, bk, n_dst)
    dev = x.device
    _check("s_in", s_in, _F32, 1, dev)
    _check("s_out", s_out, _F32, 1, dev)
    n_src, d = x.shape
    if s_in.shape[0] != n_src:
        raise ValueError(f"s_in has {s_in.shape[0]} rows, x has {n_src}")
    if add_diag and bm != bk:
        raise ValueError("add_diag requires square blocks (bm == bk)")
    if dev.type == "cpu":
        return spmm_blockell_fused_ref(block_cols, blocks, x, s_in, s_out,
                                       bm=bm, bk=bk, add_diag=add_diag)
    fn = _kernel_fn("spmm_blockell_fused")
    y = torch.empty((n_dst, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                 s_in.data_ptr(), s_out.data_ptr(), y.data_ptr(),
                 int(blocks.dtype == torch.uint8), R, W, n_src, n_dst, bm,
                 bk, d, int(add_diag), stream)
    _raise_on(err, "spmm_blockell_fused")
    spmm_blockell_fused.launches += 1
    return y


spmm_blockell_fused.launches = 0


def spmm_blockell_update(
        block_cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
        s_in: torch.Tensor, s_out: torch.Tensor, w: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        w_self: Optional[torch.Tensor] = None,
        self_coeff: Optional[torch.Tensor] = None, *, bm: int, bk: int,
        add_diag: bool, relu: bool = False) -> torch.Tensor:
    """Padded fused LAYER; returns (n_dst, d_out) float32, every row
    written.

    The aggregation of :func:`spmm_blockell_fused` at width d_in, then in
    the same launch ``(s_out ⊙ acc) @ w + c · (x @ w_self) + bias`` and
    ReLU when ``relu``.  w: (d_in, d_out); bias: (d_out,) or None; w_self:
    (d_in, d_out) or None and may be ``w`` itself; self_coeff: a 0-d
    float32 tensor on x's device (c = 1 when None; needs w_self).  The self
    and diagonal terms need square blocks and read x's first n_dst rows.
    """
    n_dst = s_out.shape[0]
    R, W = _check_padded(block_cols, blocks, x, bm, bk, n_dst)
    dev = x.device
    _check("s_in", s_in, _F32, 1, dev)
    _check("s_out", s_out, _F32, 1, dev)
    n_src, d_in = x.shape
    if s_in.shape[0] != n_src:
        raise ValueError(f"s_in has {s_in.shape[0]} rows, x has {n_src}")
    d_out = _check_epilogue(x, w, bias, w_self, self_coeff, bm, bk)
    if add_diag or w_self is not None:
        if bm != bk:
            raise ValueError("add_diag requires square blocks (bm == bk)")
        if n_src < n_dst:
            raise ValueError(f"the self term reads {n_dst} rows of x, which "
                             f"has {n_src}")
    if dev.type == "cpu":
        return spmm_blockell_update_ref(
            block_cols, blocks, x, s_in, s_out, w, bias, w_self, self_coeff,
            bm=bm, bk=bk, add_diag=add_diag, relu=relu)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _kernel_fn("spmm_blockell_update")
    y = torch.empty((n_dst, d_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                 s_in.data_ptr(), s_out.data_ptr(), w.data_ptr(), ptr(bias),
                 ptr(w_self), ptr(self_coeff), y.data_ptr(),
                 int(blocks.dtype == torch.uint8), R, W, n_src, n_dst, bm,
                 bk, d_in, d_out, int(add_diag), int(relu), stream)
    _raise_on(err, "spmm_blockell_update")
    spmm_blockell_update.launches += 1
    return y


spmm_blockell_update.launches = 0
