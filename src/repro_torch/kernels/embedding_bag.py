"""EmbeddingBag kernel for Hopper: the wrapper of ``csrc/embedding_bag.cu``.

The port of the Pallas TPU kernel ``repro/kernels/embedding_bag.py``:
``out[b] = Σ_{i: bag_ids[i] = b} weights[i] · table[ids[i]]`` over entries
sorted by bag.  It takes the TPU kernel's contract, a bag id per entry and
the bag count, and writes every bag, an empty one as zeros; the table keeps
its own width (no 128-lane padding).  Each warp owns a range of output
rows: lane groups over float4 columns (d % 4 == 0, aligned), or a lane per
entry with segmented shuffle sums (any other width); a mostly empty output
is zeroed by a streaming pass first (see the source).

On a CUDA tensor the wrapper launches the hand-written kernel (built on
first use, see ``_build``) or raises; on a CPU tensor it runs the plain
version, ``ref.embedding_bag_ref``.  There is no fallback from the one to
the other.  ``embedding_bag.launches`` counts wrapper calls that launch
(a plain integer; the plain version does not count); a call with a zero
pass makes two kernel launches and counts one.
``kernels.ops.embedding_bag`` is the public entry point: it sorts by bag
and differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import embedding_bag_ref
from .spmm_blockell import _check, _raise_on


def _kernel_fn():
    """The ctypes entry point of ``csrc/embedding_bag.cu``."""
    return _build.entry("embedding_bag", 5, 3)


def plan(n_entries: int, num_bags: int, table: torch.Tensor,
         out: torch.Tensor) -> dict:
    """The launch shape the kernel takes for these operands: its mapping
    (``"rows"``: lane groups over float4 columns, where d % 4 == 0 and table
    and out are 16-byte aligned; ``"lanes"``: a lane per entry), rows per
    warp, warps, the lanes mapping's tile rows and width, whether it
    streams its stores, and whether a zero pass comes first (the rows
    mapping of a sparse output)."""
    fn = _build.load("embedding_bag").embedding_bag_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_longlong * 7)()
    with torch.cuda.device(table.device):
        err = fn(n_entries, num_bags, table.shape[1], table.data_ptr(),
                 out.data_ptr(), res)
    _raise_on(err, "embedding_bag_plan")
    rows, *rest = res
    return {"mapping": "rows" if rows else "lanes",
            **dict(zip(("rows_per_warp", "warps", "tile_rows", "tile_width",
                        "stream", "zero_pass"), rest))}


def embedding_bag(ids: torch.Tensor, bag_ids: torch.Tensor,
                  weights: torch.Tensor, table: torch.Tensor,
                  num_bags: int) -> torch.Tensor:
    """Weighted bag sums; returns (num_bags, d) float32, every row written.

    ids: (L,) int32 rows of ``table``; bag_ids: (L,) int32, non-decreasing,
    each in ``[0, num_bags)``; weights: (L,) float32; table: (V, d) float32
    with V < 2**31.  The ranges and the order are not checked here
    (``ops.embedding_bag`` checks the ranges and sorts).
    """
    dev = table.device
    _check("table", table, (torch.float32,), 2, dev)
    _check("ids", ids, (torch.int32,), 1, dev)
    _check("bag_ids", bag_ids, (torch.int32,), 1, dev)
    _check("weights", weights, (torch.float32,), 1, dev)
    V, d = table.shape
    L = ids.shape[0]
    if num_bags < 0:
        raise ValueError(f"num_bags must be >= 0, got {num_bags}")
    if weights.shape != ids.shape or bag_ids.shape != ids.shape:
        raise ValueError(f"ids, bag_ids and weights have {L}, "
                         f"{bag_ids.shape[0]} and {weights.shape[0]} entries")
    if d == 0:
        raise ValueError("table has no columns")
    if max(V, L, num_bags) > _build.INT32_MAX:
        raise ValueError("the kernel takes int32 rows, ids and bags: "
                         f"V={V}, L={L}, num_bags={num_bags}")
    if dev.type == "cpu":
        return embedding_bag_ref(ids, bag_ids, weights, table, num_bags)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((num_bags, d), dtype=torch.float32, device=dev)
    if num_bags == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ids.data_ptr(), bag_ids.data_ptr(), weights.data_ptr(),
                 table.data_ptr(), out.data_ptr(), L, num_bags, d, stream)
    _raise_on(err, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
