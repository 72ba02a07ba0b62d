"""SDDMM kernel for Hopper: the wrapper of ``csrc/sddmm.cu``.

The port of the Pallas TPU kernel ``repro/kernels/sddmm.py``: per-edge dot
products ``out[e] = <q[src[e]], k[dst[e]]>`` (GAT-style edge scores).  The
TPU kernel runs one edge per grid step over q and k padded to 128 lanes;
the port takes any edge count and width (lane groups matched to d, a few
edges a warp, see the source).

On a CUDA tensor the wrapper launches the hand-written kernel (built on
first use, see ``_build``) or raises; on a CPU tensor it runs the plain
version, ``ref.sddmm_ref``.  ``sddmm.launches`` counts kernel launches.
``kernels.ops.sddmm`` is the public entry point.  Neither has a backward
(nor has the reference's kernel).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import sddmm_ref
from .spmm_blockell import _check, _raise_on


def _kernel_fn():
    """The ctypes entry point of ``csrc/sddmm.cu``."""
    return _build.entry("sddmm", 5, 2)


def sddmm(src: torch.Tensor, dst: torch.Tensor, q: torch.Tensor,
          k: torch.Tensor) -> torch.Tensor:
    """Per-edge scores; returns (E,) float32.

    src, dst: (E,) int32 rows of q and k (``ops.sddmm`` checks the range);
    q: (N, d) and k: (M, d) float32.
    """
    dev = q.device
    _check("q", q, (torch.float32,), 2, dev)
    _check("k", k, (torch.float32,), 2, dev)
    _check("src", src, (torch.int32,), 1, dev)
    _check("dst", dst, (torch.int32,), 1, dev)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"q is {q.shape[1]} wide, k {k.shape[1]}")
    if src.shape != dst.shape:
        raise ValueError(f"src has {src.shape[0]} edges, dst {dst.shape[0]}")
    if src.shape[0] > _build.INT32_MAX:
        raise ValueError(f"{src.shape[0]} edges exceed the int32 count")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        raise NotImplementedError("sddmm has no backward")
    if dev.type == "cpu":
        return sddmm_ref(src, dst, q, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(src.shape[0], dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), q.data_ptr(), k.data_ptr(),
                 out.data_ptr(), src.shape[0], q.shape[1], stream)
    _raise_on(err, "sddmm")
    sddmm.launches += 1
    return out


sddmm.launches = 0
