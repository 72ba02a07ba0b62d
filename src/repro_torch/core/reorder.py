"""Graph reordering (numpy copy of the parts of ``repro/core/reorder.py``
the serving slice runs).

Both return an *execution order* ``perm`` with ``perm[k]`` = old id of the
node run k-th.  ``lsh_reorder_jax`` (the on-line reorder) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..graph.structure import Graph


def minhash_reorder(g: Graph, num_hashes: int = 8, seed: int = 0) -> np.ndarray:
    """MinHash signatures over neighbor sets, lexicographic sort."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    sig = np.full((n, num_hashes), np.iinfo(np.uint64).max, dtype=np.uint64)
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src, dst = g.src[valid], g.dst[valid]
    for h in range(num_hashes):
        a = rng.integers(1, 1 << 61, dtype=np.uint64) | np.uint64(1)
        b = rng.integers(1, 1 << 61, dtype=np.uint64)
        hv = (a * src.astype(np.uint64) + b)  # universal-ish hash, mod 2^64
        np.minimum.at(sig[:, h], dst, hv)
    order = np.lexsort(tuple(sig[:, h] for h in reversed(range(num_hashes))))
    return order.astype(np.int64)


def identity_order(g: Graph) -> np.ndarray:
    """The "index order" baseline."""
    return np.arange(g.num_nodes, dtype=np.int64)
