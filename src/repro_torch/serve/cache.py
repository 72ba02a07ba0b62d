"""Runtime node-embedding cache — the paper's §IV-B2 cache, online (host-side
copy of ``repro/serve/cache.py``).

The offline simulators in ``core.cache_model`` replay an access stream over a
presence-only LRU to *predict* traffic; here the same ``LRUCache`` (shared
implementation) stores real vectors and *serves* them.  The paper's two cache
roles map onto layers of the serving model:

* layer 0 — the G-D analog: raw node feature vectors, backed by the feature
  store.  Like the hardware cache it models, it is **line-granular**: a miss
  fetches an aligned block of ``line_size`` consecutive rows *of the node
  order the cache was built with* (DMA-burst / feature-store-page
  granularity).  This is where reordering pays: under ``lsh_reorder`` a line
  is dense with nodes that share neighborhoods, so one miss prefetches the
  rest of the frontier; under index order (shuffled ids) a line is filled
  with unrelated rows that are never touched again.
* layer l>0 — the G-C analog: computed layer-l embeddings, per-node LRU
  (partial results cannot be "fetched", only remembered; a hit elides the
  whole aggregation subtree below that node).

``warm()`` preloads entries along an execution order (normally the same
``lsh_reorder`` permutation) so reorder windows start resident instead of
faulting in line by line.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..core.cache_model import LRUCache


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Aggregate counters across all layers of an EmbeddingCache."""

    hits: int
    misses: int
    evictions: int
    bytes_served: int      # hit bytes that never left the backing store
    bytes_missed: int      # bytes fetched/computed on misses (line-inflated)
    per_layer: Dict[int, Dict[str, int]]

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)


class EmbeddingCache:
    """Per-layer cache of node vectors with byte accounting.

    ``capacity_bytes`` is split across layers proportionally to ``split``
    (even by default, mirroring the paper's even G-D/G-C split of the 128KB
    private cache, Table II).  Layer 0 is line-granular over ``order`` (the
    execution order; identity when omitted); deeper layers are per-node.
    """

    def __init__(self, layer_dims: Sequence[int], capacity_bytes: int,
                 order: Optional[np.ndarray] = None, line_size: int = 16,
                 num_nodes: Optional[int] = None, dtype=np.float32,
                 split: Optional[Sequence[float]] = None):
        self.layer_dims = [int(d) for d in layer_dims]
        self.dtype = np.dtype(dtype)
        n = len(self.layer_dims)
        if split is None:
            split = [1.0 / n] * n
        assert len(split) == n
        self.line_size = max(int(line_size), 1)
        self.vec_bytes = [d * self.dtype.itemsize for d in self.layer_dims]
        # layer-0 capacity counts lines; deeper layers count single vectors
        entry_bytes = [self.vec_bytes[0] * self.line_size] + self.vec_bytes[1:]
        self.layers = [
            LRUCache(max(int(capacity_bytes * s) // eb, 1))
            for s, eb in zip(split, entry_bytes)
        ]
        if order is None:
            self._pos = None          # position == node id (index order)
        else:
            order = np.asarray(order, dtype=np.int64)
            self._pos = np.empty_like(order)
            self._pos[order] = np.arange(order.shape[0])
        self._order = order
        self._num_nodes = (order.shape[0] if order is not None
                           else num_nodes)
        if self.line_size > 1 and self._num_nodes is None:
            raise ValueError("line_size > 1 needs an order or num_nodes to "
                             "clamp line fetches at the table boundary")

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def capacity_entries(self, layer: int) -> int:
        """Vectors ``layer`` can hold (layer 0 counts lines of
        ``line_size``)."""
        cap = self.layers[layer].capacity
        return cap * self.line_size if layer == 0 else cap

    def _line_of(self, nodes: np.ndarray) -> np.ndarray:
        pos = nodes if self._pos is None else self._pos[nodes]
        return pos // self.line_size

    def _line_nodes(self, line: int) -> np.ndarray:
        """Global ids of the rows an aligned line fetch brings in."""
        lo = line * self.line_size
        hi = lo + self.line_size
        if self._num_nodes is not None:
            hi = min(hi, self._num_nodes)
        if self._order is not None:
            return self._order[lo:hi]
        return np.arange(lo, hi)

    # ------------------------------------------------------- layer-0 fetch
    def fetch_base(self, nodes: np.ndarray,
                   loader: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Serve layer-0 vectors through the line cache.

        ``loader(ids) -> (len(ids), d0)`` is the backing feature store; it is
        only called for whole missed lines.  Returns the requested rows.
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        lru = self.layers[0]
        out = np.empty((nodes.shape[0], self.layer_dims[0]), self.dtype)
        lines = self._line_of(nodes)
        # Sweep in execution order (line-sorted): the aggregation walks the
        # reorder, so each line is touched exactly once per call even when
        # the working set exceeds capacity — the paper's reuse-distance
        # argument applied to the probe stream itself.  Stats are counted
        # once per distinct line per call (hit == a whole store fetch
        # avoided); the probes a fresh line serves within the same call are
        # not "reuse", they're the burst itself.
        order = np.argsort(lines, kind="stable")
        cur_line = None
        entry = None
        for i in order:
            u, ln = int(nodes[i]), int(lines[i])
            if ln != cur_line:
                cur_line = ln
                entry = lru.get(ln)
                if entry is LRUCache.MISS:
                    ids = self._line_nodes(ln)
                    vals = np.asarray(loader(ids), dtype=self.dtype)
                    entry = {int(v): vals[j] for j, v in enumerate(ids)}
                    lru.put(ln, entry)
            out[i] = entry[u]
        return out

    # ---------------------------------------------- deeper layers (per node)
    def lookup(self, layer: int, nodes: np.ndarray):
        """Batch lookup: (hit_mask, values) with values[i]=None on miss."""
        assert layer >= 1, "layer 0 is served via fetch_base"
        lru = self.layers[layer]
        vals = [lru.get(int(u)) for u in nodes]
        mask = np.array([v is not LRUCache.MISS for v in vals], dtype=bool)
        return mask, [None if v is LRUCache.MISS else v for v in vals]

    def put_many(self, layer: int, nodes: np.ndarray, mat: np.ndarray) -> None:
        assert layer >= 1
        lru = self.layers[layer]
        mat = np.asarray(mat, dtype=self.dtype)
        for i, u in enumerate(nodes):
            lru.put(int(u), mat[i])

    # -------------------------------------------------------------- warming
    def warm(self, layer: int, order: np.ndarray, values: np.ndarray,
             budget_entries: Optional[int] = None) -> int:
        """Preload ``values[order[k]]`` along an execution order.

        Layer 0 warms whole lines (the lines covering the order prefix);
        deeper layers warm per-node.  Only the first ``min(budget, capacity)``
        entries are inserted, in *reverse*, so position 0 of the order ends
        most-recently-used: under traffic pressure LRU sheds the tail of the
        warmed window first.  Returns the number of node entries warmed.
        """
        lru = self.layers[layer]
        if layer == 0:
            n_lines = lru.capacity if budget_entries is None else \
                min(-(-int(budget_entries) // self.line_size), lru.capacity)
            order = np.asarray(order)
            # first-occurrence line ids along the warm order (np.unique would
            # re-sort, breaking the head-MRU promise when the warm order is
            # not the cache's construction order), capped at capacity so the
            # head never self-evicts
            all_lines = self._line_of(order)
            _, first = np.unique(all_lines, return_index=True)
            lines = all_lines[np.sort(first)][:n_lines]
            warmed = 0
            for ln in lines[::-1]:
                ids = self._line_nodes(int(ln))
                entry = {int(v): np.asarray(values[int(v)], self.dtype)
                         for v in ids}
                lru.put(int(ln), entry)
                warmed += len(ids)
            return warmed
        cap = lru.capacity
        take = cap if budget_entries is None else min(int(budget_entries), cap)
        window = np.asarray(order)[:take]
        for u in window[::-1]:
            lru.put(int(u), np.asarray(values[int(u)], dtype=self.dtype))
        return int(window.shape[0])

    # ---------------------------------------------------------------- stats
    def stats(self) -> CacheStats:
        per = {}
        hits = misses = ev = b_hit = b_miss = 0
        for l, (lru, vb) in enumerate(zip(self.layers, self.vec_bytes)):
            miss_bytes = lru.misses * vb * (self.line_size if l == 0 else 1)
            per[l] = {"hits": lru.hits, "misses": lru.misses,
                      "evictions": lru.evictions, "entries": len(lru),
                      "capacity": lru.capacity, "vec_bytes": vb,
                      "miss_bytes": miss_bytes}
            hits += lru.hits
            misses += lru.misses
            ev += lru.evictions
            b_hit += lru.hits * vb
            b_miss += miss_bytes
        return CacheStats(hits=hits, misses=misses, evictions=ev,
                          bytes_served=b_hit, bytes_missed=b_miss,
                          per_layer=per)

    def reset_stats(self) -> None:
        """Zero every layer's hit, miss and eviction counts (the entries
        stay)."""
        for lru in self.layers:
            lru.hits = lru.misses = lru.evictions = 0
