"""Graph reordering (numpy copy of ``repro/core/reorder.py``): the paper's
LSH over adjacency rows (§IV-A) and its baselines.

* ``lsh_reorder``     — SimHash (signed random projection, the paper's
                        "random projection" formulation) over sparse
                        adjacency rows; nodes sorted by (bucket, degree).
* ``minhash_reorder`` — MinHash banding (Jaccard-similarity LSH).
* ``degree_reorder``  — the lightweight degree-sort baseline.
* ``bfs_reorder``     — BFS/RCM-style locality baseline.

All return an *execution order* ``perm`` with ``perm[k]`` = old id of the
node run k-th; apply with ``Graph.permute(perm)``.  Reordering never changes
the graph, only the order.  The tests hold every permutation byte-equal to
the reference's.  ``lsh_reorder_jax`` (the on-line reorder) is not ported
yet (ROADMAP §1 item 8b).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph.structure import Graph


# --------------------------------------------------------------------------
# SimHash LSH (paper's random-projection formulation)
# --------------------------------------------------------------------------
def _simhash_codes(g: Graph, num_bits: int, seed: int,
                   weight_by_degree: bool = True) -> np.ndarray:
    """Project each adjacency row (a sparse 0/1 vector over sources) onto
    ``num_bits`` random hyperplanes; the sign pattern is the bucket code.

    Sparse trick: row_v . r  =  sum_{u in N(v)} r[u]  — a segment-sum over the
    edge list, O(E * num_bits) with no dense adjacency materialization.
    """
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    r = rng.standard_normal((n, num_bits)).astype(np.float32)
    if weight_by_degree:
        # damp hub sources so megahubs don't collapse all buckets (REDDIT)
        deg = np.maximum(g.out_degrees(), 1).astype(np.float32)
        r /= np.sqrt(deg)[:, None]
    proj = np.zeros((n, num_bits), np.float32)
    valid = g.edge_mask if g.edge_mask is not None else slice(None)
    np.add.at(proj, g.dst[valid], r[g.src[valid]])
    return (proj > 0).astype(np.uint64)


def _codes_to_keys(codes: np.ndarray) -> np.ndarray:
    """(N, B) bits -> (N,) uint64 bucket keys (B <= 64)."""
    b = codes.shape[1]
    weights = (1 << np.arange(b, dtype=np.uint64))
    return (codes * weights[None, :]).sum(axis=1, dtype=np.uint64)


def lsh_reorder(g: Graph, num_bits: int = 16, seed: int = 0,
                tiebreak_degree: bool = True) -> np.ndarray:
    """Paper's LSH-based reordering: SimHash rows -> sort by bucket code.

    Gray-code-order the buckets so adjacent buckets differ in one hyperplane
    (smoother transitions than raw binary order); within a bucket sort by
    degree so hubs cluster (their features stay resident longest).
    """
    codes = _simhash_codes(g, num_bits, seed)
    keys = _codes_to_keys(codes)
    gray = keys ^ (keys >> np.uint64(1))
    if tiebreak_degree:
        deg = g.in_degrees()
        order = np.lexsort((-deg, gray))
    else:
        order = np.argsort(gray, kind="stable")
    return order.astype(np.int64)


# --------------------------------------------------------------------------
# MinHash banding (Jaccard LSH)
# --------------------------------------------------------------------------
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


# --------------------------------------------------------------------------
# Baselines
# --------------------------------------------------------------------------
def identity_order(g: Graph) -> np.ndarray:
    """The "index order" baseline."""
    return np.arange(g.num_nodes, dtype=np.int64)


def degree_reorder(g: Graph, descending: bool = True) -> np.ndarray:
    deg = g.in_degrees() + g.out_degrees()
    return np.argsort(-deg if descending else deg, kind="stable").astype(np.int64)


def bfs_reorder(g: Graph, start: Optional[int] = None) -> np.ndarray:
    """BFS order from the max-degree node (RCM-flavored locality baseline).

    Frontier-at-a-time expansion over the CSR: one vectorized slice-gather
    pulls every frontier node's neighbor list at once, then a stable
    first-occurrence dedupe (``np.unique(return_index)``) reproduces the
    per-node queue's visitation order exactly (``_bfs_reorder_queue``; the
    tests assert the same permutation).
    """
    csr = g.csr()
    indptr, indices = csr.indptr, csr.indices
    n = g.num_nodes
    visited = np.zeros(n, bool)
    chunks = []
    pos = 0
    cursor = 0            # amortized next-unvisited scan across components
    root = int(np.argmax(g.in_degrees())) if start is None else int(start)
    while pos < n:
        frontier = np.array([root], np.int64)
        visited[root] = True
        while frontier.size:
            chunks.append(frontier)
            pos += frontier.size
            starts, ends = indptr[frontier], indptr[frontier + 1]
            counts = ends - starts
            total = int(counts.sum())
            if total == 0:
                break
            # gather indices[starts[i]:ends[i]] for all i, concatenated
            offs = np.repeat(starts - np.concatenate(
                ([0], np.cumsum(counts)[:-1])), counts)
            nbrs = indices[np.arange(total, dtype=np.int64) + offs]
            cand = nbrs[~visited[nbrs]]
            # first-occurrence dedupe preserving queue order
            _, first = np.unique(cand, return_index=True)
            frontier = cand[np.sort(first)].astype(np.int64)
            visited[frontier] = True
        if pos == n:
            break
        while visited[cursor]:
            cursor += 1
        root = cursor                             # next component
    return np.concatenate(chunks).astype(np.int64)


def _bfs_reorder_queue(g: Graph, start: Optional[int] = None) -> np.ndarray:
    """Scalar per-node-queue BFS: the implementation :func:`bfs_reorder`
    must match, kept for the parity tests."""
    csr = g.csr()
    n = g.num_nodes
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    deg = g.in_degrees()
    seeds = [int(np.argmax(deg)) if start is None else start]
    head = 0
    queue: list = []
    for s in range(n):
        root = seeds[0] if s == 0 else None
        if root is None:
            if pos == n:
                break
            unv = np.flatnonzero(~visited)
            if unv.size == 0:
                break
            root = int(unv[0])
        if visited[root]:
            continue
        queue.append(root)
        visited[root] = True
        while head < len(queue):
            v = queue[head]
            head += 1
            order[pos] = v
            pos += 1
            for u in csr.row(v):
                if not visited[u]:
                    visited[u] = True
                    queue.append(int(u))
    return order


# --------------------------------------------------------------------------
# Quality metrics
# --------------------------------------------------------------------------
def mean_reuse_distance(g: Graph, sample: int = 200_000, seed: int = 0) -> float:
    """Average |position(dst_i) - position(dst_j)| between consecutive uses of
    the same source — the temporal-reuse-distance proxy the paper optimizes.

    Computed on the *current* node order; lower is better.
    """
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src, dst = g.src[valid], g.dst[valid]
    if src.shape[0] > sample:
        rng = np.random.default_rng(seed)
        keep_src = rng.choice(np.unique(src), size=min(sample // 8, np.unique(src).size),
                              replace=False)
        m = np.isin(src, keep_src)
        src, dst = src[m], dst[m]
    order = np.lexsort((dst, src))
    s, d = src[order], dst[order]
    same = s[1:] == s[:-1]
    gaps = np.abs(d[1:] - d[:-1])[same]
    return float(gaps.mean()) if gaps.size else 0.0


def bandwidth(g: Graph) -> float:
    """Mean |src - dst| distance — adjacency 'bandwidth' after ordering."""
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    return float(np.abs(g.src[valid].astype(np.int64) -
                        g.dst[valid].astype(np.int64)).mean())


REORDERINGS = {
    "index": identity_order,
    "lsh": lsh_reorder,
    "minhash": minhash_reorder,
    "degree": degree_reorder,
    "bfs": bfs_reorder,
}
