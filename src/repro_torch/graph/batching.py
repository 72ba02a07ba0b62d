"""Batched small graphs (the paper's COLLAB/BZR/IMDB/DD regime), numpy copy
of ``repro/graph/batching.py``.

Small graphs are packed into one disjoint-union supergraph with static
shapes: node and edge capacities are per-graph maxima × batch.
``graph_ids`` gives each node slot its graph, for the graph-level readout
of graph classification (``models.sage_gin.gin_apply(..., graph_ids)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .structure import Graph


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    src: np.ndarray          # (B*Emax,) int32 into packed node space
    dst: np.ndarray
    edge_mask: np.ndarray    # (B*Emax,) bool
    node_mask: np.ndarray    # (B*Nmax,) bool
    graph_ids: np.ndarray    # (B*Nmax,) int32 graph id per node slot
    num_graphs: int
    nodes_per_graph: int
    edges_per_graph: int

    @property
    def num_nodes(self) -> int:
        return int(self.node_mask.shape[0])


def pack(graphs: Sequence[Graph], nodes_per_graph: Optional[int] = None,
         edges_per_graph: Optional[int] = None) -> Tuple[GraphBatch, np.ndarray]:
    """Pack graphs into a padded disjoint union.

    Returns (batch, feat) where feat is the packed (B*Nmax, d) feature matrix
    (zeros when graphs carry no features or at padding slots).
    """
    B = len(graphs)
    nmax = nodes_per_graph or max(g.num_nodes for g in graphs)
    emax = edges_per_graph or max(g.num_edges for g in graphs)
    d = next((g.node_feat.shape[1] for g in graphs if g.node_feat is not None),
             1)

    src = np.zeros(B * emax, np.int32)
    dst = np.zeros(B * emax, np.int32)
    emask = np.zeros(B * emax, bool)
    nmask = np.zeros(B * nmax, bool)
    gid = np.zeros(B * nmax, np.int32)
    feat = np.zeros((B * nmax, d), np.float32)
    for b, g in enumerate(graphs):
        if g.num_nodes > nmax or g.num_edges > emax:
            raise ValueError("graph exceeds packing capacity")
        no, eo = b * nmax, b * emax
        e = g.num_edges
        src[eo:eo + e] = g.src + no
        dst[eo:eo + e] = g.dst + no
        emask[eo:eo + e] = (g.edge_mask if g.edge_mask is not None
                            else np.ones(e, bool))
        nmask[no:no + g.num_nodes] = True
        gid[no:no + nmax] = b
        if g.node_feat is not None:
            feat[no:no + g.num_nodes] = g.node_feat
    return GraphBatch(src=src, dst=dst, edge_mask=emask, node_mask=nmask,
                      graph_ids=gid, num_graphs=B, nodes_per_graph=nmax,
                      edges_per_graph=emax), feat


def readout_segments(batch: GraphBatch) -> np.ndarray:
    """Graph id per node slot, padding slots pointed at their own graph
    (they carry zero features, so sums are unaffected)."""
    return batch.graph_ids
