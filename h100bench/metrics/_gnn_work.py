"""The work a full-graph GNN training step needs, counted from the
graph's size and the model's widths alone (no plan, tile or layout enters),
and the program's kernel names that the readers time.

Per layer ``d_in -> d_out`` over ``n`` nodes and ``e`` edges:

* dense products (each ``2 m k n`` FLOPs, reading both operands and
  writing the result once, fp32): the forward products (GCN one, SAGE's
  two weights two), each weight's gradient, and, for every layer but the
  first (the features need no gradient), the input's gradient through
  each weight;
* aggregations: one forward and one transposed a layer, each at the
  narrower of the layer's two widths (the product moves to whichever side
  is narrower), each reading its input rows, writing its output rows,
  reading every edge once (two int32 ids) and the two per-node scale
  vectors once; ``2 e d`` FLOPs each.
"""
from __future__ import annotations

from typing import List, Tuple

from ..harness import peaks

FP32 = 4
EDGE_BYTES = 8

# the program's block-ELL kernels: the CUDA namespace of every one.  The
# fused aggregate-and-update kernels (``blockell::update::``) are timed
# here alone: their walk over the tiles takes their time, and a product
# they run inside them is the dense layer's work left untimed there
AGGREGATE_KERNELS = ("blockell::",)
# the kernels that run the weight products: cuBLAS's
DENSE_KERNELS = ("gemm", "gemv", "splitkreduce")


def is_aggregate(name: str) -> bool:
    return any(k in name for k in AGGREGATE_KERNELS)


def is_dense(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in DENSE_KERNELS)


def _layers(shape: dict) -> List[Tuple[int, int, int]]:
    """(index, d_in, d_out) per layer."""
    dims = shape["dims"]
    return [(i, a, b) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def dense_products(shape: dict) -> List[Tuple[int, int, int]]:
    """(m, k, n) of every dense product a step needs."""
    n = shape["num_nodes"]
    weights = 2 if shape["model"] == "sage" else 1
    out = []
    for i, d_in, d_out in _layers(shape):
        out += [(n, d_in, d_out)] * weights          # forward
        out += [(d_in, n, d_out)] * weights          # dW
        if i > 0:
            out += [(n, d_out, d_in)] * weights      # dx
    return out


def aggregation_widths(shape: dict) -> List[int]:
    """The width of every aggregation a step needs."""
    return [min(d_in, d_out) for _, d_in, d_out in _layers(shape)
            for _ in ("forward", "transposed")]


def dense_flops(shape: dict) -> float:
    return float(sum(2 * m * k * n for m, k, n in dense_products(shape)))


def dense_bound_s(shape: dict) -> float:
    """The least time of the step's dense products, one after the other."""
    return sum(max(2 * m * k * n / peaks.PEAK_FLOPS_FP32,
                   FP32 * (m * k + k * n + m * n) / peaks.HBM_BW)
               for m, k, n in dense_products(shape))


def aggregate_bytes(n: int, e: int, d: int) -> int:
    return FP32 * (2 * n * d + 2 * n) + EDGE_BYTES * e


def aggregate_bound_s(shape: dict) -> float:
    """The least time of the step's aggregations, one after the other."""
    n, e = shape["num_nodes"], shape["num_edges"]
    return sum(max(2 * e * d / peaks.PEAK_FLOPS_FP32,
                   aggregate_bytes(n, e, d) / peaks.HBM_BW)
               for d in aggregation_widths(shape))


def model_flops(shape: dict) -> float:
    """Dense products plus ``2 e d`` for each aggregation."""
    e = shape["num_edges"]
    return dense_flops(shape) + sum(2.0 * e * d
                                    for d in aggregation_widths(shape))


def applies(ctx) -> bool:
    return ctx.shape.get("family") == "gnn_full"
