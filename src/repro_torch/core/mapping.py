"""Hierarchical task mapping (paper §IV-D); numpy copy of
``repro/core/mapping.py``.

Graph-level mapping: consecutive windows of the reordered execution order
are assigned to PEs (simulated PEs of the cache model) — data reuse stays
inside a window, task parallelism across windows, no inter-PE dependency.

Node-level mapping: tile the (n, d_in) x (d_in, d_out) update matmul onto
the paper's MAC array (4x8 MACs, 2 KB register file), or into 128-aligned
matrix-unit tiles (``mxu=True``, the reference's TPU tiling, kept as a
model).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..graph.structure import Graph
from ..graph.partition import window_partition, Partition


@dataclasses.dataclass(frozen=True)
class GraphLevelMapping:
    """Assignment of reordered node windows to PEs."""

    parts: Partition
    window: int          # nodes per PE window (task granularity)
    num_pes: int

    def pe_of(self, node: np.ndarray) -> np.ndarray:
        return self.parts.part_of(node)


def map_graph_level(g: Graph, num_pes: int) -> GraphLevelMapping:
    parts = window_partition(g.num_nodes, num_pes)
    return GraphLevelMapping(parts=parts, window=int(parts.sizes().max()),
                             num_pes=num_pes)


@dataclasses.dataclass(frozen=True)
class NodeLevelTiling:
    """MAC-array / MXU tiling for the update matmul (paper Fig. 6b)."""

    tile_m: int   # nodes per tile
    tile_k: int   # input-feature tile
    tile_n: int   # output-feature tile

    def flops(self, n: int, d_in: int, d_out: int) -> int:
        return 2 * n * d_in * d_out


def map_node_level(d_in: int, d_out: int, mac_rows: int = 4, mac_cols: int = 8,
                   rf_bytes: int = 2048, mxu: bool = False) -> NodeLevelTiling:
    """Pick tiles: ASIC mode uses the paper's 4x8 MAC + 2KB RF; mxu mode uses
    128-aligned MXU tiles."""
    if mxu:
        return NodeLevelTiling(tile_m=128, tile_k=min(128, _ceil128(d_in)),
                               tile_n=min(128, _ceil128(d_out)))
    # ASIC: hold one input tile row + partials in RF
    tile_k = max(1, min(d_in, rf_bytes // 4 // 2 // max(mac_cols, 1)))
    return NodeLevelTiling(tile_m=mac_rows, tile_k=tile_k, tile_n=mac_cols)


def _ceil128(x: int) -> int:
    return max(128, ((x + 127) // 128) * 128)


def pe_edge_lists(g: Graph, mapping: GraphLevelMapping
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-PE (src, dst) edge lists in destination execution order —
    the access streams fed to the cache simulator."""
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src, dst = g.src[valid], g.dst[valid]
    pe = mapping.pe_of(dst)
    out = []
    for p in range(mapping.num_pes):
        sel = pe == p
        s, d = src[sel], dst[sel]
        order = np.lexsort((s, d))  # row-major traversal within the window
        out.append((s[order], d[order]))
    return out
