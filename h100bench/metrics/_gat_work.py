"""The work a full-graph GAT training step needs, counted from the graph's
size and the model's widths alone (no plan, hub split or kernel choice
enters), and the program's attention kernel names that the readers time.

A layer maps ``d_in`` to ``H`` heads of ``F`` over ``n`` nodes and ``E'``
attended entries (the edges, plus one self loop a node where the model
takes them):

* dense products, as ``_gnn_work`` counts them (each ``2 m k n`` FLOPs,
  reading both operands and writing the result once, fp32): the forward
  ``(n, d_in, H F)``, the weight's gradient, and for every layer but the
  first the input's gradient;
* the attention, one forward and one backward pass a layer, each the
  larger of its FLOPs at 67 TFLOP/s and its least bytes at 3.35 TB/s.
  Forward: ``2 E' H F`` for the weighted sum plus
  :data:`SCORE_FLOPS_FWD` an entry and head (the score's add, the
  LeakyReLU, the running max, the exponential's shift and the sum); it
  reads z and the two per-node scores once, writes out and lse once, and
  reads 4 B an entry and 4 B a row pointer of lists.  Backward: ``4 E' H
  F`` (the dot of dout with z and the sum into dz) plus
  :data:`SCORE_FLOPS_BWD` an entry and head; it reads z, dout, lse, the
  two scores and each row's ``dout · out`` once, writes dz and the two
  scores' gradients once, and reads the lists as the forward does.
"""
from __future__ import annotations

from typing import List, Tuple

from ..harness import peaks
from ._gnn_work import FP32

# per entry and head: add, LeakyReLU (compare, multiply), max, subtract,
# exponential, add
SCORE_FLOPS_FWD = 7
# per entry and head: the forward's score and exponential (5), the row
# term's subtract and multiply, the LeakyReLU's slope, and the two sums
SCORE_FLOPS_BWD = 10
LIST_BYTES = 4           # an entry's index, and a row pointer

# the program's attention kernels: the CUDA namespaces of its forward and
# backward
FORWARD_KERNELS = ("gat::fwd::",)
BACKWARD_KERNELS = ("gat::bwd::",)


def is_forward(name: str) -> bool:
    return any(k in name for k in FORWARD_KERNELS)


def is_backward(name: str) -> bool:
    return any(k in name for k in BACKWARD_KERNELS)


def is_attention(name: str) -> bool:
    return is_forward(name) or is_backward(name)


def applies(ctx) -> bool:
    return ctx.shape.get("family") == "gat_full"


def layers(shape: dict) -> List[Tuple[int, int, int]]:
    """``(d_in, H, F)`` of each layer: hidden layers concatenate their
    heads."""
    dims, heads = shape["dims"], shape["heads"]
    return [(dims[0] if i == 0 else dims[i] * heads[i - 1], h, f)
            for i, (h, f) in enumerate(zip(heads, dims[1:]))]


def entries(shape: dict) -> int:
    """The attended entries E'."""
    n = shape["num_nodes"]
    return shape["num_edges"] + (n if shape.get("self_loops") else 0)


def dense_products(shape: dict) -> List[Tuple[int, int, int]]:
    n = shape["num_nodes"]
    out = []
    for i, (d_in, h, f) in enumerate(layers(shape)):
        out += [(n, d_in, h * f), (d_in, n, h * f)]
        if i > 0:
            out.append((n, h * f, d_in))
    return out


def dense_flops(shape: dict) -> float:
    return float(sum(2 * m * k * n for m, k, n in dense_products(shape)))


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / peaks.PEAK_FLOPS_FP32, nbytes / peaks.HBM_BW)


def attention_flops(shape: dict, backward: bool) -> float:
    e = entries(shape)
    per_col, per_entry = ((4, SCORE_FLOPS_BWD) if backward
                          else (2, SCORE_FLOPS_FWD))
    return float(sum(per_col * e * h * f + per_entry * e * h
                     for _, h, f in layers(shape)))


def attention_bytes(shape: dict, backward: bool) -> List[float]:
    """The least bytes of each layer's pass."""
    n, e = shape["num_nodes"], entries(shape)
    lists = LIST_BYTES * (e + n + 1)
    out = []
    for _, h, f in layers(shape):
        rows = (3 if backward else 2) * n * h * f
        node = (6 if backward else 3) * n * h
        out.append(FP32 * (rows + node) + lists)
    return out


def attention_bound_s(shape: dict, backward: bool) -> float:
    """The least time of the step's attention passes in one direction, one
    after the other."""
    e = entries(shape)
    per_col, per_entry = ((4, SCORE_FLOPS_BWD) if backward
                          else (2, SCORE_FLOPS_FWD))
    return sum(_bound(per_col * e * h * f + per_entry * e * h, nbytes)
               for (_, h, f), nbytes in zip(layers(shape),
                                            attention_bytes(shape, backward)))


def model_flops(shape: dict) -> float:
    """Dense products plus both directions of the attention."""
    return (dense_flops(shape) + attention_flops(shape, False)
            + attention_flops(shape, True))
