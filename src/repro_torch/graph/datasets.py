"""Synthetic graphs shaped like the paper's datasets (numpy copy of
``repro/graph/datasets.py``): Cora, the Table I stand-ins CITESEER-S
and REDDIT, ogbn-products at any scale, and NequIP's molecule batches.

The generator draws from one numpy ``default_rng(seed)`` stream, so its
output is byte-equal to the reference's for the same spec (the tests assert
it).  Community (SBM-style) structure on a power-law degree profile, node ids
shuffled at the end so reordering is not handed its answer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .structure import Graph

# name: (num_graphs, avg_V, avg_E, feat_dim, classes)  — paper Table I
PAPER_TABLE_I = {
    "COLLAB":      (5000, 74, 2458, 492, 3),
    "BZR":         (405, 36, 38, 53, 2),
    "IMDB-BINARY": (1000, 20, 97, 136, 2),
    "DD":          (1178, 284, 716, 89, 2),
    "CITESEER-S":  (1, 227_320, 814_134, 3703, 41),
    "REDDIT":      (1, 232_965, 114_615_892, 602, 6),
}


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    num_edges: int
    feat_dim: int
    num_classes: int
    community: float = 0.8  # fraction of edges kept intra-community
    num_communities: Optional[int] = None
    seed: int = 0


def spec_for_paper(name: str, scale: float = 1.0, seed: int = 0) -> DatasetSpec:
    """Spec matching paper Table I, optionally scaled down: nodes and edges
    by ``scale``, features by ``min(4 scale, 1)``."""
    _, v, e, d, c = PAPER_TABLE_I[name]
    return DatasetSpec(
        name=name,
        num_nodes=max(int(v * scale), 16),
        num_edges=max(int(e * scale), 32),
        feat_dim=max(int(d * min(scale * 4, 1.0)), 8),
        num_classes=c,
        seed=seed,
    )


def _power_law_degrees(n: int, m: int, rng: np.random.Generator,
                       alpha: float = 2.1) -> np.ndarray:
    """Draw a degree sequence with a power-law tail summing to ~m."""
    raw = rng.pareto(alpha - 1.0, size=n) + 1.0
    deg = np.maximum(1, np.round(raw * (m / raw.sum()))).astype(np.int64)
    diff = m - int(deg.sum())
    if diff > 0:
        idx = rng.integers(0, n, size=diff)
        np.add.at(deg, idx, 1)
    elif diff < 0:
        order = np.argsort(-deg)
        for i in order:
            take = min(deg[i] - 1, -diff)
            deg[i] -= take
            diff += take
            if diff >= 0:
                break
    return deg


def synthesize(spec: DatasetSpec) -> Graph:
    """Community (SBM-ish) + power-law graph with features and labels."""
    rng = np.random.default_rng(spec.seed)
    n, m = spec.num_nodes, spec.num_edges
    k = spec.num_communities or max(2, int(np.sqrt(n / 4)))
    comm = rng.integers(0, k, size=n)
    comm_members: Dict[int, np.ndarray] = {c: np.flatnonzero(comm == c)
                                           for c in range(k)}
    deg = _power_law_degrees(n, m, rng)
    base_src = np.repeat(np.arange(n, dtype=np.int64), deg)[:m]

    def sample_edges(src: np.ndarray) -> tuple:
        dst = rng.integers(0, n, size=src.shape[0])
        intra = rng.random(src.shape[0]) < spec.community
        for c in range(k):
            members = comm_members[c]
            if members.size == 0:
                continue
            sel = np.flatnonzero(intra & (comm[src] == c))
            if sel.size:
                dst[sel] = rng.choice(members, size=sel.size)
        loops = src == dst
        dst[loops] = (dst[loops] + 1 + rng.integers(0, n - 1, loops.sum())) % n
        return src, dst

    # simple-graph assembly: dedup + top-up rounds
    src, dst = sample_edges(base_src)
    keys = src * n + dst
    _, first = np.unique(keys, return_index=True)
    src, dst = src[np.sort(first)], dst[np.sort(first)]
    for _ in range(6):
        deficit = m - src.shape[0]
        if deficit <= 0:
            break
        extra_owner = rng.choice(base_src, size=int(deficit * 1.5))
        es, ed = sample_edges(extra_owner)
        src = np.concatenate([src, es])
        dst = np.concatenate([dst, ed])
        keys = src * n + dst
        _, first = np.unique(keys, return_index=True)
        src, dst = src[np.sort(first)], dst[np.sort(first)]
    src, dst = src[:m], dst[:m]

    feat = rng.standard_normal((n, spec.feat_dim)).astype(np.float32)
    labels = comm % spec.num_classes
    centers = rng.standard_normal((spec.num_classes, spec.feat_dim)
                                  ).astype(np.float32)
    feat += 0.5 * centers[labels]
    train_mask = rng.random(n) < 0.7

    shuffle = rng.permutation(n)
    g = Graph(src=src.astype(np.int32), dst=dst.astype(np.int32), num_nodes=n,
              node_feat=feat, labels=labels.astype(np.int32),
              train_mask=train_mask)
    g = g.permute(shuffle)
    g.validate()
    return g


def cora_like(seed: int = 0) -> Graph:
    """Cora-shaped graph: 2708 nodes, 10556 edges, 1433 feats, 7 classes."""
    return synthesize(DatasetSpec("cora", 2708, 10556, 1433, 7, seed=seed))


def reddit_like(scale: float = 1.0, seed: int = 0) -> Graph:
    return synthesize(spec_for_paper("REDDIT", scale=scale, seed=seed))


def citeseer_s_like(scale: float = 1.0, seed: int = 0) -> Graph:
    return synthesize(spec_for_paper("CITESEER-S", scale=scale, seed=seed))


def products_like(scale: float = 1.0, seed: int = 0) -> Graph:
    """ogbn-products-shaped: 2,449,029 nodes / 61,859,140 edges / 100 feats,
    47 classes (scaled by ``scale``)."""
    return synthesize(DatasetSpec(
        "ogb_products", max(int(2_449_029 * scale), 64),
        max(int(61_859_140 * scale), 128), 100, 47, seed=seed))


def molecules_like(batch: int = 128, n_nodes: int = 30, n_edges: int = 64,
                   seed: int = 0) -> list:
    """A batch of small molecule-like graphs with 3D coordinates (NequIP):
    ``[(Graph, pos (n_nodes, 3) float32, atomic numbers (n_nodes,) int32),
    ...]``, each graph's edges its ``n_edges`` nearest ordered pairs."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(batch):
        pos = rng.standard_normal((n_nodes, 3)).astype(np.float32) * 2.0
        # connect near pairs until n_edges reached (cutoff-style)
        d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        flat = np.argsort(d2, axis=None)[: n_edges]
        dst, src = np.unravel_index(flat, d2.shape)
        z = rng.integers(1, 10, size=n_nodes).astype(np.int32)
        graphs.append((Graph(src=src.astype(np.int32),
                             dst=dst.astype(np.int32), num_nodes=n_nodes),
                       pos, z))
    return graphs
