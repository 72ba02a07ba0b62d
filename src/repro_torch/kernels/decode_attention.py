"""Flash-decode attention kernel for Hopper: the wrapper of
``csrc/decode_attention.cu``.

The port of the Pallas TPU kernel ``repro/kernels/decode_attention.py``:
one query per (b, h) against an S-long KV cache, ``softmax(q kᵀ / sqrt(d))
v`` over the positions ``< cache_len[b]``.  The TPU kernel walks S as a
sequential grid axis carrying (m, l, acc); the port splits S into chunks
reduced in parallel and merged by a second pass (see the source), reads
k and v GQA-native, (B, S, KV, d) with ``H % KV == 0``, and takes any S
(no multiple of a block).  A row with ``cache_len <= 0`` gives zeros.

On a CUDA tensor the wrapper launches the hand-written kernel (built on
first use, see ``_build``) or raises; on a CPU tensor it runs the plain
version, ``ref.decode_attention_ref``.  There is no fallback from the one
to the other.  ``decode_attention.launches`` counts calls that launched:
one per call, whether the kernel ran in one pass or in two (split and
merge).  ``kernels.ops.decode_attention`` is the public entry point.
Neither has a backward (nor has the reference's kernel).
"""
from __future__ import annotations

import ctypes
import functools
import math
import torch

from . import _build
from .ref import decode_attention_ref
from .spmm_blockell import _raise_on

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256


def _kernel_fn():
    """The ctypes entry point of ``csrc/decode_attention.cu``: 6 pointers,
    10 ints, 6 strides, the scale, the stream."""
    return _build.entry("decode_attention", 6, 10,
                        [ctypes.c_longlong] * 6 + [ctypes.c_float])


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, KV: int, G: int, d: int, dtype: torch.dtype,
         vec_bytes: int, dev: torch.device) -> dict:
    """The launch shape on ``dev``, as the source's
    ``decode_attention_plan`` picks it from its shared-memory layout and
    the occupancy of pass 1: positions per tile, the chunk count and
    length, and the fp32 workspace's length."""
    fn = _build.load("decode_attention").decode_attention_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(dev):
        err = fn(B, S, KV, G, d, _DTYPES[dtype], vec_bytes, out)
    if err:
        raise RuntimeError(f"decode_attention_plan failed: cudaError {err}")
    if out[0] == 0:
        raise ValueError(f"G={G} query heads of d={d} per KV head do not fit "
                         "one CTA's shared memory")
    return dict(zip(("tile", "n_split", "chunk", "ws"), out))


def _vec_bytes(esize: int, d: int, k: torch.Tensor, v: torch.Tensor) -> int:
    """The widest load (16, 8, 4 or 2 bytes, at least one element) that
    divides a row, every k/v stride and both base addresses."""
    for vb in (16, 8, 4, 2):
        if vb < esize:
            break
        ok = (d * esize) % vb == 0
        for t in (k, v):
            ok &= t.data_ptr() % vb == 0
            ok &= all((s * esize) % vb == 0 for s in t.stride()[:3])
        if ok:
            return vb
    raise ValueError("k and v rows are not aligned to their element size")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Masked one-query attention; returns (B, H, d) in q's dtype.

    q: (B, H, d) contiguous; k, v: (B, S, KV, d) with unit stride over d
    (any strides over b, s and the head: a layer's view of a stacked cache
    is taken as it is); q, k, v all float32 or all bfloat16, d <= 256,
    ``H % KV == 0``; cache_len: (B,) int32, the valid positions per row
    (<= 0: a zero row; > S: all of S).
    """
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q is on {dev}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, KV, d), got "
                             f"{tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over d")
    if cache_len.dtype != torch.int32 or cache_len.device != dev:
        raise TypeError(f"cache_len must be int32 on {dev}, got "
                        f"{cache_len.dtype} on {cache_len.device}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, H, d), got "
                         f"{tuple(q.shape)}")
    B, H, d = q.shape
    _, S, KV, dk = k.shape
    if k.shape != v.shape or k.shape[0] != B or dk != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if cache_len.shape != (B,):
        raise ValueError(f"cache_len must be ({B},), got "
                         f"{tuple(cache_len.shape)}")
    if not 0 < d <= MAX_D or S == 0:
        raise ValueError(f"the kernel takes 1 <= d <= {MAX_D} and S >= 1, "
                         f"got d={d}, S={S}")
    if max(B, KV) > 65535 or max(S, B * H) > _build.INT32_MAX:
        raise ValueError(f"B={B}, KV={KV}, S={S}, H={H} exceed the grid")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("decode_attention has no backward")
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, cache_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    vb = _vec_bytes(q.element_size(), d, k, v)
    p = plan(B, S, KV, H // KV, d, q.dtype, vb, dev)
    ws = torch.empty(p["ws"], dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 cache_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 B, S, H, KV, d, _DTYPES[q.dtype], p["n_split"], p["chunk"],
                 p["tile"], vb, *k.stride()[:3], *v.stride()[:3],
                 1.0 / math.sqrt(d), stream)
    _raise_on(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
