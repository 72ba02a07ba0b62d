"""Graph data structures (numpy copy of ``repro/graph/structure.py``).

A static-shape COO edge list plus a destination-major CSR view.  Kept as a
copy so the port never imports ``repro``; the tests hold every array it
produces byte-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A single (possibly padded) graph.

    Attributes:
      src: (E,) int32 source node ids.
      dst: (E,) int32 destination node ids.  Message passing flows src -> dst.
      num_nodes: static node count (includes padding nodes if any).
      edge_mask: (E,) bool, False for padding edges.  None means all-valid.
      edge_weight: (E,) float32 optional.
      node_feat: (N, d) float32 optional features.
      labels: (N,) int32 optional node labels.
      train_mask: (N,) bool optional.
    """

    src: np.ndarray
    dst: np.ndarray
    num_nodes: int
    edge_mask: Optional[np.ndarray] = None
    edge_weight: Optional[np.ndarray] = None
    node_feat: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    train_mask: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_valid_edges(self) -> int:
        if self.edge_mask is None:
            return self.num_edges
        return int(self.edge_mask.sum())

    def csr(self) -> "CSR":
        """Destination-major CSR view (rows = destinations, cols = sources)."""
        order = np.argsort(self.dst, kind="stable")
        src = self.src[order]
        dst = self.dst[order]
        if self.edge_mask is not None:
            keep = self.edge_mask[order]
            src, dst = src[keep], dst[keep]
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, dst + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(indptr=indptr, indices=src.astype(np.int32),
                   num_nodes=self.num_nodes)

    def in_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        if self.edge_mask is not None:
            np.add.at(deg, self.dst[self.edge_mask], 1)
        else:
            np.add.at(deg, self.dst, 1)
        return deg

    def out_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        if self.edge_mask is not None:
            np.add.at(deg, self.src[self.edge_mask], 1)
        else:
            np.add.at(deg, self.src, 1)
        return deg

    def permute(self, perm: np.ndarray) -> "Graph":
        """Relabel nodes: ``perm[k]`` = old id of the node that runs k-th."""
        assert perm.shape[0] == self.num_nodes
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.num_nodes, dtype=perm.dtype)
        remap = lambda a: inv[a].astype(np.int32) if a is not None else None
        return dataclasses.replace(
            self,
            src=remap(self.src),
            dst=remap(self.dst),
            node_feat=self.node_feat[perm] if self.node_feat is not None else None,
            labels=self.labels[perm] if self.labels is not None else None,
            train_mask=self.train_mask[perm] if self.train_mask is not None else None,
        )

    def with_sym_norm(self) -> "Graph":
        """Attach GCN symmetric normalization coefficients 1/sqrt(d_u d_v)
        (degrees count the self loop)."""
        deg = np.maximum(self.in_degrees() + 1, 1).astype(np.float64)
        w = 1.0 / np.sqrt(deg[self.src] * deg[self.dst])
        if self.edge_mask is not None:
            w = np.where(self.edge_mask, w, 0.0)
        return dataclasses.replace(self, edge_weight=w.astype(np.float32))

    def pad_edges(self, capacity: int) -> "Graph":
        """Pad the edge list to ``capacity`` with masked (0 -> 0) edges."""
        e = self.num_edges
        if e > capacity:
            raise ValueError(f"edge count {e} exceeds capacity {capacity}")
        pad = capacity - e
        mk = lambda a, fill: np.concatenate([a, np.full(pad, fill, a.dtype)])
        mask = (self.edge_mask if self.edge_mask is not None
                else np.ones(e, bool))
        return dataclasses.replace(
            self, src=mk(self.src, 0), dst=mk(self.dst, 0),
            edge_mask=mk(mask, False),
            edge_weight=(mk(self.edge_weight, 0.0)
                         if self.edge_weight is not None else None))

    def validate(self) -> None:
        if self.src.dtype not in (np.int32, np.int64):
            raise ValueError(f"edge ids must be int32/int64, got {self.src.dtype}")
        if self.src.shape != self.dst.shape:
            raise ValueError("src and dst must have the same shape")
        for name, a in (("src", self.src), ("dst", self.dst)):
            if a.min(initial=0) < 0 or a.max(initial=0) >= self.num_nodes:
                raise ValueError(f"{name} ids out of range [0, {self.num_nodes})")


@dataclasses.dataclass(frozen=True)
class CSR:
    """Destination-major compressed sparse rows."""

    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,) source ids, grouped by destination row
    num_nodes: int

    def row(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)


def from_dense(adj: np.ndarray, **kw) -> Graph:
    """A graph of a dense adjacency whose row v lists v's in-neighbors
    (row = destination)."""
    dst, src = np.nonzero(adj)
    return Graph(src=src.astype(np.int32), dst=dst.astype(np.int32),
                 num_nodes=adj.shape[0], **kw)


def to_dense(g: Graph) -> np.ndarray:
    """The (N, N) float32 adjacency, ``adj[dst, src]`` summing the edges'
    weights (1 without ``edge_weight``; 0 for a masked edge)."""
    adj = np.zeros((g.num_nodes, g.num_nodes), dtype=np.float32)
    w = (g.edge_weight if g.edge_weight is not None
         else np.ones(g.num_edges, np.float32))
    if g.edge_mask is not None:
        w = np.where(g.edge_mask, w, 0.0)
    np.add.at(adj, (g.dst, g.src), w)
    return adj
