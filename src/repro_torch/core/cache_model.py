"""Exact LRU cache (numpy-free copy of ``repro/core/cache_model.LRUCache``).

The serving embedding cache stores real per-node vectors in it; the
offline G-D/G-C traffic simulators of the reference are not ported.
"""
from __future__ import annotations

from collections import OrderedDict

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
