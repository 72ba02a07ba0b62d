"""G-D / G-C cache simulation (paper §IV-B2, the Fig. 9 traffic); numpy
copy of ``repro/core/cache_model.py``.

Exact LRU simulation of the per-PE private caches over the aggregation
access stream produced by the hierarchical mapping:

* G-D cache: keys = source node ids (one feature vector each).
* G-C cache: keys = pair ids (one partial-aggregate vector each).

Off-chip traffic = misses x feature-vector bytes (the paper's Fig. 9c,d
metric: aggregation-stage off-chip memory access volume).  These are host
models of the paper's accelerator, not measurements of any device.

``LRUCache`` has two modes over one eviction machinery: presence-only
(``access``/``insert``) for the simulators here, value-bearing
(``get``/``put``) for the serving embedding cache (``serve/cache.py``).
The tests hold every count equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..graph.structure import Graph
from .mapping import GraphLevelMapping, map_graph_level, pe_edge_lists
from .shared_set import SharedSetPlan

_MISS = object()   # get() sentinel: distinguishes "absent" from cached None


class LRUCache:
    """Exact LRU with integer keys; counts hits/misses/evictions."""

    __slots__ = ("capacity", "store", "hits", "misses", "evictions")

    MISS = _MISS

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self.store: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.store)

    def __contains__(self, key: int) -> bool:
        return key in self.store

    # ------------------------------------------------------ presence API
    def access(self, key: int) -> bool:
        """Touch ``key``: True on a hit; a miss inserts it (evicting the
        least recent entry when full)."""
        st = self.store
        if key in st:
            st.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        st[key] = None
        if len(st) > self.capacity:
            st.popitem(last=False)
            self.evictions += 1
        return False

    def insert(self, key: int) -> None:
        """Insert/refresh ``key`` (no hit/miss accounting)."""
        st = self.store
        if key in st:
            st.move_to_end(key)
            return
        st[key] = None
        if len(st) > self.capacity:
            st.popitem(last=False)
            self.evictions += 1

    # -------------------------------------------------------- value API
    def get(self, key: int):
        """Return the stored value (refreshing recency) or ``LRUCache.MISS``."""
        st = self.store
        if key in st:
            st.move_to_end(key)
            self.hits += 1
            return st[key]
        self.misses += 1
        return _MISS

    def put(self, key: int, value) -> None:
        """Insert/refresh ``key`` with ``value`` (no hit/miss accounting)."""
        st = self.store
        if key in st:
            st[key] = value
            st.move_to_end(key)
            return
        st[key] = value
        if len(st) > self.capacity:
            st.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """Aggregation-stage traffic for one schedule."""

    feature_loads: int        # off-chip feature-vector loads (G-D misses)
    pair_hits: int            # G-C hits (reductions eliminated at runtime)
    total_accesses: int
    offchip_bytes: int
    hit_rate: float
    reductions_performed: int

    def reduction_vs(self, base: "TrafficReport") -> float:
        return 1.0 - self.offchip_bytes / max(base.offchip_bytes, 1)


def simulate_gd(g: Graph, num_pes: int, cache_bytes: int, feat_dim: int,
                bytes_per_el: int = 4,
                mapping: Optional[GraphLevelMapping] = None) -> TrafficReport:
    """G-D-only schedule (paper's Index-order or LR depending on the graph's
    current node order)."""
    vec_bytes = feat_dim * bytes_per_el
    cap = max(cache_bytes // vec_bytes, 1)
    mapping = mapping or map_graph_level(g, num_pes)
    loads = 0
    total = 0
    for (src, _dst) in pe_edge_lists(g, mapping):
        cache = LRUCache(cap)
        for u in src.tolist():
            if not cache.access(u):
                loads += 1
        total += src.shape[0]
    return TrafficReport(feature_loads=loads, pair_hits=0, total_accesses=total,
                         offchip_bytes=loads * vec_bytes,
                         hit_rate=1.0 - loads / max(total, 1),
                         reductions_performed=total)


def simulate_gd_gc(g: Graph, plan: SharedSetPlan, num_pes: int,
                   gd_bytes: int, gc_bytes: int, feat_dim: int,
                   bytes_per_el: int = 4) -> TrafficReport:
    """LR&CR schedule (paper §IV-B2 working flow).

    Destinations run in execution order; for each, residual sources consult
    the G-D cache.  The shared aggregate of the destination's buddy block is
    looked up in the G-C cache; a miss rebuilds it from G-D accesses (charged
    as feature loads + reductions), a hit eliminates the whole shared set's
    loads and reductions.  Simulates the paper-faithful single level.
    """
    assert plan.num_levels >= 1
    vec_bytes = feat_dim * bytes_per_el
    gd_cap = max(gd_bytes // vec_bytes, 1)
    gc_cap = max(gc_bytes // vec_bytes, 1)
    mapping = map_graph_level(g, num_pes)

    # group residual edges by dst, level-1 shared edges by block
    rs, rd = plan.residual_src, plan.residual_dst
    r_order = np.argsort(rd, kind="stable")
    rs, rd = rs[r_order], rd[r_order]
    r_ptr = np.searchsorted(rd, np.arange(plan.num_nodes + 1))
    ss, sb = plan.level_src[0], plan.level_block[0]
    s_order = np.argsort(sb, kind="stable")
    ss, sb = ss[s_order], sb[s_order]
    nblk = (plan.num_nodes >> 1) + 1
    s_ptr = np.searchsorted(sb, np.arange(nblk + 1))

    loads = 0
    gc_hits = 0
    reductions = 0
    total = 0
    for p in range(mapping.num_pes):
        lo, hi = mapping.parts.boundaries[p], mapping.parts.boundaries[p + 1]
        gd = LRUCache(gd_cap)
        gc = LRUCache(gc_cap)
        for d in range(int(lo), int(hi)):
            for u in rs[r_ptr[d]:r_ptr[d + 1]].tolist():
                total += 1
                reductions += 1
                if not gd.access(u):
                    loads += 1
            b = d >> 1
            shared = ss[s_ptr[b]:s_ptr[b + 1]]
            if shared.shape[0] == 0:
                continue
            total += 1
            reductions += 1          # consume SA into the accumulator
            if gc.access(b):
                gc_hits += 1
            else:
                for u in shared.tolist():
                    reductions += 1  # rebuild SA
                    if not gd.access(u):
                        loads += 1
    return TrafficReport(feature_loads=loads, pair_hits=gc_hits,
                         total_accesses=total,
                         offchip_bytes=loads * vec_bytes,
                         hit_rate=1.0 - loads / max(total, 1),
                         reductions_performed=reductions)


def schedule_comparison(g_index: Graph, g_lr: Graph, plan_lr: SharedSetPlan,
                        num_pes: int = 64, gd_bytes: int = 64 * 1024,
                        gc_bytes: int = 64 * 1024, feat_dim: int = 128
                        ) -> dict:
    """Paper Fig. 9 experiment: Index-order vs LR vs LR&CR on one dataset.

    g_index: graph in original order; g_lr: after lsh_reorder; plan_lr: pair
    plan mined on g_lr.  Rubik's config splits the 128KB private cache evenly
    between G-D and G-C when CR is on (paper Table II).
    """
    base = simulate_gd(g_index, num_pes, gd_bytes + gc_bytes, feat_dim)
    lr = simulate_gd(g_lr, num_pes, gd_bytes + gc_bytes, feat_dim)
    lrcr = simulate_gd_gc(g_lr, plan_lr, num_pes, gd_bytes, gc_bytes, feat_dim)
    return {
        "index": base,
        "lr": lr,
        "lrcr": lrcr,
        "lr_traffic_reduction": lr.reduction_vs(base),
        "lrcr_traffic_reduction": lrcr.reduction_vs(base),
        "lrcr_extra_reduction_vs_lr": lrcr.reduction_vs(lr),
    }
