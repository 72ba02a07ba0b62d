"""Device partitioning of graphs: the paper's graph-level mapping at mesh
scale (numpy copy of ``repro/graph/partition.py``).

The paper assigns consecutive *windows* of the reordered traversal order to
PEs (§IV-D1); ``core.mapping`` builds its graph-level mapping on these.  At
mesh scale the "PE" is a rank: the (reordered) node range is split into
``num_parts`` contiguous windows, one per rank on the data axis.  Cut edges
(src window != dst window) need remote features, the *halo*; LSH
reordering clusters communities into contiguous windows, so the cut-edge
count (the halo exchange's bytes) drops.  :class:`HaloPlan` is what
``repro_torch.dist`` exchanges; every array it holds is byte-equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .structure import Graph


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous-window node partition.

    boundaries[p] .. boundaries[p+1] is the node range owned by part p
    (node ids refer to the *current* graph order, i.e. run after `permute`).
    """

    boundaries: np.ndarray  # (P+1,)
    num_parts: int

    def part_of(self, node: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.boundaries, node, side="right") - 1

    def sizes(self) -> np.ndarray:
        return np.diff(self.boundaries)


def window_partition(num_nodes: int, num_parts: int) -> Partition:
    """Equal contiguous windows (the first ``num_nodes % num_parts`` parts
    take one node more)."""
    base = num_nodes // num_parts
    sizes = np.full(num_parts, base, dtype=np.int64)
    sizes[: num_nodes - base * num_parts] += 1
    boundaries = np.concatenate([[0], np.cumsum(sizes)])
    return Partition(boundaries=boundaries, num_parts=num_parts)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static-shape halo exchange plan for one partitioned graph.

    For each part p, ``halo_src[p]`` lists the remote node ids (global, padded
    with 0 and masked) whose features p must receive before local aggregation.
    ``edge_src/edge_dst`` are per-part edge lists with sources renumbered
    into [0, local_n + halo_n): owned nodes first, then halo slots.
    """

    parts: Partition
    halo_src: np.ndarray      # (P, H) int32 global ids of needed remote nodes
    halo_mask: np.ndarray     # (P, H) bool
    edge_src: np.ndarray      # (P, Emax) int32 local-index sources
    edge_dst: np.ndarray      # (P, Emax) int32 local dst (0-based within part)
    edge_mask: np.ndarray     # (P, Emax) bool
    edge_weight: np.ndarray   # (P, Emax) float32
    cut_edges: int
    total_edges: int

    @property
    def halo_capacity(self) -> int:
        return int(self.halo_src.shape[1])

    @property
    def halo_fraction(self) -> float:
        return self.cut_edges / max(self.total_edges, 1)


def build_halo_plan(g: Graph, num_parts: int,
                    halo_capacity: int | None = None,
                    edge_capacity: int | None = None) -> HaloPlan:
    """Partition ``g`` by contiguous windows and build the halo plan.

    Shapes are padded to the max across parts (every rank runs the same
    shapes).  ``halo_capacity``/``edge_capacity`` can be fixed externally
    (e.g. to a budget that the reordered graph is known to satisfy).
    A remote source's halo slot is its rank in the part's sorted halo ids
    (``np.searchsorted``; the reference looks it up edge by edge in a dict).
    """
    parts = window_partition(g.num_nodes, num_parts)
    src_part = parts.part_of(g.src)
    dst_part = parts.part_of(g.dst)
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    w = g.edge_weight if g.edge_weight is not None else np.ones(g.num_edges, np.float32)

    halo_lists: List[np.ndarray] = []
    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    e_w: List[np.ndarray] = []
    cut = 0
    for p in range(num_parts):
        own = (dst_part == p) & valid
        s, d, ww = g.src[own], g.dst[own], w[own]
        sp = src_part[own]
        lo = parts.boundaries[p]
        local_n = parts.boundaries[p + 1] - lo
        remote = sp != p
        cut += int(remote.sum())
        halo_ids = np.unique(s[remote])
        local_src = np.where(remote,
                             local_n + np.searchsorted(halo_ids, s)
                             .astype(np.int64),
                             s - lo)
        halo_lists.append(halo_ids)
        e_src.append(local_src)
        e_dst.append(d - lo)
        e_w.append(ww)

    H = halo_capacity or max((h.shape[0] for h in halo_lists), default=1) or 1
    E = edge_capacity or max((e.shape[0] for e in e_src), default=1) or 1
    P = num_parts
    halo_src = np.zeros((P, H), np.int32)
    halo_mask = np.zeros((P, H), bool)
    es = np.zeros((P, E), np.int32)
    ed = np.zeros((P, E), np.int32)
    em = np.zeros((P, E), bool)
    ew = np.zeros((P, E), np.float32)
    for p in range(P):
        h = halo_lists[p]
        if h.shape[0] > H:
            raise ValueError(f"halo overflow: part {p} needs {h.shape[0]} > {H}")
        if e_src[p].shape[0] > E:
            raise ValueError(f"edge overflow: part {p} needs {e_src[p].shape[0]} > {E}")
        halo_src[p, : h.shape[0]] = h
        halo_mask[p, : h.shape[0]] = True
        n_e = e_src[p].shape[0]
        es[p, :n_e] = e_src[p]
        ed[p, :n_e] = e_dst[p]
        em[p, :n_e] = True
        ew[p, :n_e] = e_w[p]
    return HaloPlan(parts=parts, halo_src=halo_src, halo_mask=halo_mask,
                    edge_src=es, edge_dst=ed, edge_mask=em, edge_weight=ew,
                    cut_edges=cut, total_edges=int(valid.sum()))


def uniform_local_n(parts: Partition) -> int:
    """The common window size when all windows are equal: the shape every
    rank of the mesh must hold.  Raises for ragged partitions; pad the graph
    to a multiple of ``num_parts`` first (``dist.gnn.pad_graph_nodes``)."""
    sizes = parts.sizes()
    if sizes.size == 0 or not (sizes == sizes[0]).all():
        raise ValueError(
            f"ragged partition (windows {sizes.min()}..{sizes.max()}); "
            f"pad num_nodes to a multiple of {parts.num_parts}")
    return int(sizes[0])


def cut_edges(g: Graph, num_parts: int) -> int:
    """Cheap cut-edge count for a contiguous-window partition of ``g``."""
    parts = window_partition(g.num_nodes, num_parts)
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    return int(((parts.part_of(g.src) != parts.part_of(g.dst)) & valid).sum())
