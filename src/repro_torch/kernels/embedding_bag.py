"""EmbeddingBag kernel for Hopper: the wrapper of ``csrc/embedding_bag.cu``.

The port of the Pallas TPU kernel ``repro/kernels/embedding_bag.py``:
``out[b] = Σ_{offsets[b] <= i < offsets[b+1]} weights[i] · table[ids[i]]``
over ids sorted by bag.  The TPU kernel takes one bag id per entry and
revisits the bag's output block from one grid step to the next; the port
takes the bags' offsets (one warp per 32 bags walks them, see the source)
and writes every bag, an empty one as zeros.  The table keeps its own
width (no 128-lane padding).

On a CUDA tensor the wrapper launches the hand-written kernel (built on
first use, see ``_build``) or raises; on a CPU tensor it runs the plain
version, ``ref.embedding_bag_ref``.  There is no fallback from the one to
the other.  ``embedding_bag.launches`` counts kernel launches (a plain
integer; the plain version does not count).  ``kernels.ops.embedding_bag``
is the public entry point: it sorts, builds the offsets and differentiates.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import embedding_bag_ref
from .spmm_blockell import _check, _raise_on


def _kernel_fn():
    """The ctypes entry point of ``csrc/embedding_bag.cu``."""
    return _build.entry("embedding_bag", 5, 2)


def embedding_bag(offsets: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Weighted bag sums; returns (num_bags, d) float32, every row written.

    offsets: (num_bags + 1,) int32, non-decreasing from 0 to L; ids: (L,)
    int32 rows of ``table``, bag b's ids at ``offsets[b]:offsets[b+1]``;
    weights: (L,) float32; table: (V, d) float32 with V < 2**31.  The ids
    must lie in ``[0, V)`` (``ops.embedding_bag`` checks them).
    """
    dev = table.device
    _check("table", table, (torch.float32,), 2, dev)
    _check("offsets", offsets, (torch.int32,), 1, dev)
    _check("ids", ids, (torch.int32,), 1, dev)
    _check("weights", weights, (torch.float32,), 1, dev)
    V, d = table.shape
    num_bags = offsets.shape[0] - 1
    if num_bags < 0:
        raise ValueError("offsets needs num_bags + 1 >= 1 entries")
    if weights.shape != ids.shape:
        raise ValueError(f"weights has {weights.shape[0]} entries, ids "
                         f"{ids.shape[0]}")
    if d == 0:
        raise ValueError("table has no columns")
    if max(V, ids.shape[0], num_bags) > _build.INT32_MAX:
        raise ValueError("the kernel takes int32 rows, ids and bags: "
                         f"V={V}, L={ids.shape[0]}, num_bags={num_bags}")
    if dev.type == "cpu":
        bag_ids = torch.repeat_interleave(
            torch.arange(num_bags), torch.diff(offsets.long()))
        return embedding_bag_ref(ids, bag_ids, weights, table, num_bags)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((num_bags, d), dtype=torch.float32, device=dev)
    if num_bags == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(offsets.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                 table.data_ptr(), out.data_ptr(), num_bags, d, stream)
    _raise_on(err, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
