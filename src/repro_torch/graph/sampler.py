"""Neighborhood expanders for the serving engine (numpy copy of
``repro/graph/sampler.py``).

``FullNeighborhood`` expands every in-edge, so a served block aggregates
exactly the edges the offline full-graph forward does (the oracle check is
exact); ``NeighborSampler`` draws a fixed fanout with replacement for
approximate serving.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .structure import Graph, CSR


class NeighborSampler:
    """Uniform-with-replacement fanout sampler over CSR."""

    def __init__(self, g: Graph, fanouts: Sequence[int], seed: int = 0):
        self.g = g
        self.csr: CSR = g.csr()
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)
        self._deg = self.csr.row_lengths()

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(B,) -> (B, fanout) sampled in-neighbors (self if isolated)."""
        deg = self._deg[nodes]
        offs = (self.rng.random((nodes.shape[0], fanout)) *
                np.maximum(deg, 1)[:, None]).astype(np.int64)
        base = self.csr.indptr[nodes][:, None]
        idx = base + offs
        flat = self.csr.indices[np.minimum(idx, self.csr.indices.shape[0] - 1)]
        flat = np.where(deg[:, None] == 0, nodes[:, None], flat)
        return flat.astype(np.int32)

    def expand(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One-hop fanout expansion as flat (src, dst) global-id edge lists:
        each node draws exactly ``fanouts[0]`` in-neighbors."""
        nodes = np.asarray(nodes, dtype=np.int32)
        fanout = self.fanouts[0]
        src = self._sample_neighbors(nodes, fanout).reshape(-1)
        dst = np.repeat(nodes, fanout)
        return src, dst


class FullNeighborhood:
    """Exact one-hop expander: *all* in-neighbors of each node."""

    def __init__(self, g: Graph):
        self.g = g
        self.csr: CSR = g.csr()

    def expand(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B,) node ids -> flat (src, dst) covering every in-edge of each."""
        nodes = np.asarray(nodes, dtype=np.int32)
        ptr = self.csr.indptr
        starts = ptr[nodes]
        counts = (ptr[nodes + 1] - starts).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            return (np.empty(0, np.int32), np.empty(0, np.int32))
        base = np.repeat(starts, counts)
        local = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        src = self.csr.indices[base + local].astype(np.int32)
        dst = np.repeat(nodes, counts).astype(np.int32)
        return src, dst
