"""Shared node-set exploration = G-C computation reuse (paper §IV-A2);
numpy copy of ``repro/core/shared_set.py``.

After reordering, adjacent destinations in the execution order share large
neighbor sets.  For each destination buddy pair (2j, 2j+1) the aggregate of
their SHARED neighbor set is computed once and consumed twice:

  shared build:   SA[j]  = (+)_{u in N(2j) AND N(2j+1)} x_u
  consume:        a[d]   = SA[d>>1]  (+)  (+)_{u in N(d) minus shared} x_u

Detection is vectorized: sort edges by (src, dst); an edge pair
((u,2j), (u,2j+1)) adjacent in that order <=> u is shared by the buddy
destinations.  Savings: |S_j| - 1 reductions and |S_j| feature loads per
pair (the second consume hits the G-C cache).

``build_shared_plan(levels=1)`` is the paper's granularity-2 scheme;
``levels>1`` recurses the same rewrite on the shared edge lists
(destination blocks of 4, 8, ... sharing sets), exact for any commutative,
associative aggregator.  The tests hold every plan array byte-equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..graph.structure import Graph


@dataclasses.dataclass(frozen=True)
class SharedSetPlan:
    """Static-shape shared-set execution plan.

    level_src[l] / level_block[l]: the level-(l+1) shared edge list — source u
    feeds the shared aggregate of destination block (dst >> (l+1)).
    residual_src/residual_dst: level-0 edges (not shared at any level).
    An original edge lands in exactly ONE list, so summing all levels plus the
    residual reconstructs every row exactly.
    """

    residual_src: np.ndarray
    residual_dst: np.ndarray
    level_src: Tuple[np.ndarray, ...]
    level_block: Tuple[np.ndarray, ...]
    num_nodes: int
    original_edges: int

    @property
    def num_levels(self) -> int:
        return len(self.level_src)

    @property
    def shared_edges(self) -> int:
        return sum(int(s.shape[0]) for s in self.level_src)

    @property
    def consume_adds(self) -> int:
        """Each destination folds in one SA value per level-(l+1) block that
        has shared content: distinct blocks x 2^(l+1) destinations."""
        total = 0
        for l, blk in enumerate(self.level_block):
            if blk.shape[0]:
                total += int(np.unique(blk).shape[0]) * 2 ** (l + 1)
        return total

    @property
    def effective_reductions(self) -> int:
        """builds (one reduction per shared edge) + residual + consumes."""
        return (int(self.residual_src.shape[0]) + self.shared_edges
                + self.consume_adds)

    @property
    def reduction_ratio(self) -> float:
        """Fraction of aggregation reductions eliminated (the paper's CR win):
        every level-l shared edge replaces 2^l original edges."""
        return 1.0 - self.effective_reductions / max(self.original_edges, 1)

    @property
    def shared_fraction(self) -> float:
        """Fraction of original edges covered by shared sets."""
        covered = 0
        for l, s in enumerate(self.level_src):
            covered += int(s.shape[0]) * 2 ** (l + 1)
        return covered / max(self.original_edges, 1)


def _buddy_detect(primary: np.ndarray, secondary: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by (primary, secondary); mark edge pairs where secondary values
    are dyadic buddies (2k, 2k+1) under the same primary.  Returns
    (lead_mask, order) in sorted coordinates."""
    order = np.lexsort((secondary, primary))
    p, s = primary[order], secondary[order]
    both = np.zeros(s.shape[0], bool)
    if s.shape[0] > 1:
        both[:-1] = ((p[1:] == p[:-1]) & ((s[:-1] >> 1) == (s[1:] >> 1))
                     & (s[1:] == s[:-1] + 1))
    second = np.zeros(s.shape[0], bool)
    second[1:] = both[:-1]
    lead = both & ~second
    return lead, order


def build_shared_plan(g: Graph, levels: int = 1) -> SharedSetPlan:
    """Mine shared neighbor sets of destination buddy blocks.

    levels=1 reproduces the paper (§IV-A2, granularity two); levels>1 recurses
    on shared lists (beyond-paper).
    """
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    E0 = src.shape[0]

    level_src: List[np.ndarray] = []
    level_block: List[np.ndarray] = []
    cur_src, cur_dst = src, dst
    res_src, res_dst = src, dst
    for l in range(levels):
        lead, order = _buddy_detect(cur_src, cur_dst)
        s, d = cur_src[order], cur_dst[order]
        second = np.zeros(s.shape[0], bool)
        second[1:] = lead[:-1]
        residual = ~lead & ~second
        if l == 0:
            res_src, res_dst = s[residual], d[residual]
        else:
            # non-promoted edges remain at the previous level
            level_src[l - 1] = s[residual]
            level_block[l - 1] = d[residual]
        promoted_s, promoted_b = s[lead], d[lead] >> 1
        level_src.append(promoted_s)
        level_block.append(promoted_b)
        cur_src, cur_dst = promoted_s, promoted_b
        if cur_src.shape[0] == 0:
            break
    return SharedSetPlan(
        residual_src=res_src.astype(np.int32),
        residual_dst=res_dst.astype(np.int32),
        level_src=tuple(a.astype(np.int32) for a in level_src),
        level_block=tuple(a.astype(np.int32) for a in level_block),
        num_nodes=g.num_nodes,
        original_edges=E0,
    )
