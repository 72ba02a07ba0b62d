"""Fanout neighbor sampling (GraphSAGE-style) for minibatch training, and
the serving engine's neighborhood expanders (numpy copy of
``repro/graph/sampler.py``).

``NeighborSampler`` draws exactly ``fanout[l]`` in-neighbors per node with
replacement (an isolated node samples itself), so a sampled block's edge
lists have static shapes: ``sample`` builds an L-hop ``MiniBatch`` of
``SampledBlock``s rooted at seed nodes, ``batches`` streams them over random
seed draws, ``expand`` is the serving engine's one-hop fanout step.  Its
random draws come in the reference's order from one numpy ``default_rng``,
so every array is byte-equal to the reference's for the same seed.
``FullNeighborhood`` expands every in-edge, so a served block aggregates
exactly the edges the offline full-graph forward does (the oracle check is
exact).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .structure import Graph, CSR


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One layer of a sampled computation block.

    dst_nodes: (B,) global ids of destination nodes of this layer.
    src_nodes: (B*fanout,) global ids of sampled sources, ``fanout``
      consecutive entries per destination.
    """

    dst_nodes: np.ndarray
    src_nodes: np.ndarray
    fanout: int

    @property
    def num_dst(self) -> int:
        return int(self.dst_nodes.shape[0])


@dataclasses.dataclass(frozen=True)
class MiniBatch:
    """L-layer sampled dependency: blocks[0] is the outermost (input) layer."""

    blocks: List[SampledBlock]
    seeds: np.ndarray
    input_nodes: np.ndarray      # sorted unique ids whose features are gathered
    # per-block edge lists with endpoints renumbered into input_nodes order:
    edge_src: List[np.ndarray]
    edge_dst: List[np.ndarray]
    layer_sizes: List[int]


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

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        """Sample an L-hop block structure rooted at ``seeds``.

        Layer L-1 (closest to the seeds) uses fanouts[-1]; the frontier
        expands backwards so ``blocks[0]`` consumes raw input features.
        Edge endpoints are renumbered into ``input_nodes`` (sorted, and
        holding every destination) by binary search.
        """
        seeds = np.asarray(seeds, dtype=np.int32)
        dst = seeds
        layers: List[Tuple[np.ndarray, np.ndarray]] = []  # (dst, src2d)
        for fanout in reversed(self.fanouts):
            src = self._sample_neighbors(dst, fanout)
            layers.append((dst, src))
            dst = np.unique(np.concatenate([dst, src.reshape(-1)]))
        layers.reverse()

        input_nodes = dst  # frontier after the last expansion
        rank = lambda ids: np.searchsorted(input_nodes, ids).astype(np.int32)
        blocks: List[SampledBlock] = []
        edge_src: List[np.ndarray] = []
        edge_dst: List[np.ndarray] = []
        layer_sizes = [int(input_nodes.shape[0])]
        for (d, s2d) in layers:
            fanout = s2d.shape[1]
            blocks.append(SampledBlock(dst_nodes=d, src_nodes=s2d.reshape(-1),
                                       fanout=fanout))
            edge_src.append(rank(s2d.reshape(-1)))
            edge_dst.append(rank(np.repeat(d, fanout)))
            layer_sizes.append(int(d.shape[0]))
        return MiniBatch(blocks=blocks, seeds=seeds, input_nodes=input_nodes,
                         edge_src=edge_src, edge_dst=edge_dst,
                         layer_sizes=layer_sizes)

    def expand(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One-hop fanout expansion as flat (src, dst) global-id edge lists:
        each node draws exactly ``fanouts[0]`` in-neighbors."""
        nodes = np.asarray(nodes, dtype=np.int32)
        fanout = self.fanouts[0]
        src = self._sample_neighbors(nodes, fanout).reshape(-1)
        dst = np.repeat(nodes, fanout)
        return src, dst

    def batches(self, batch_nodes: int, num_batches: int):
        """Yield minibatches over random seed draws (training stream)."""
        n = self.g.num_nodes
        for _ in range(num_batches):
            seeds = self.rng.choice(n, size=batch_nodes, replace=n < batch_nodes)
            yield self.sample(seeds.astype(np.int32))


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


def static_block_shapes(batch_nodes: int, fanouts: Sequence[int],
                        feat_dim: int) -> dict:
    """Worst-case static shapes for a sampled minibatch.

    With replacement sampling, layer sizes are exact products; unique-ing can
    only shrink them, so the product bound is the static capacity.
    """
    sizes = [batch_nodes]
    for f in reversed(list(fanouts)):
        sizes.append(sizes[-1] * f)
    sizes.reverse()  # sizes[0] = input frontier capacity
    fl = list(fanouts)
    return {
        "input_nodes": sizes[0],
        "layer_sizes": sizes,
        "feat": (sizes[0], feat_dim),
        "edges_per_layer": [sizes[i + 1] * fl[i] for i in range(len(fl))],
    }
