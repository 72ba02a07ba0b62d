"""The benchmark's own graph generator: a frozen copy of the port's
Table I synthesizer (``repro_torch/graph/datasets.py::synthesize``).

Community structure on a power-law degree profile: each node draws a
community; an edge stays inside its source's community with probability
``community``; labels come from the community; a ``train_fraction`` mask
is drawn; and node ids are shuffled at the end so that a reordering has
real work to do.  Three departures from the port's copy: the graph is one
dataset, drawn from :data:`GRAPH_SEED` and the same for every run seed (a
graph drawn from the run's seed changed the work from seed to seed: the
heavy tail of its degrees made one seed's step a third slower than
another's on the card, and MinHash's order, which follows the ids, moved
the active tiles, the step time and the peak by about 1%); the
per-community loop is one vectorised draw; and the features are not drawn
on the host.  :func:`make_features` draws them on the device from the
run's seed, in the same form (class centre times ``center_scale`` plus
standard normal noise), so that the 3.4 GB matrix of a CITESEER-S-sized
graph costs no host time.

The program and the reference receive the same arrays.
"""
from __future__ import annotations

import numpy as np
import torch

# the features' stream, kept apart from the weights' (see drivers)
FEATURE_STREAM = 1
# the seed of the graph, the same in every run
GRAPH_SEED = 0


def seed_bits(seed: int) -> int:
    """Any whole number (negative ones too) as a non-negative 63-bit seed."""
    return int(seed) & (2 ** 63 - 1)


def stream_seed(seed: int, stream: int) -> int:
    """A seed for a device generator, one stream of ``seed`` among others:
    different streams and different seeds never share one."""
    ss = np.random.SeedSequence([seed_bits(seed), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _power_law_degrees(n: int, m: int, rng: np.random.Generator,
                       alpha: float) -> np.ndarray:
    """A degree sequence with a power-law tail summing to ``m``."""
    raw = rng.pareto(alpha - 1.0, size=n) + 1.0
    deg = np.maximum(1, np.round(raw * (m / raw.sum()))).astype(np.int64)
    diff = m - int(deg.sum())
    if diff > 0:
        np.add.at(deg, rng.integers(0, n, size=diff), 1)
    elif diff < 0:
        for i in np.argsort(-deg):
            take = min(deg[i] - 1, -diff)
            deg[i] -= take
            diff += take
            if diff >= 0:
                break
    return deg


def synthesize(graph: dict) -> dict:
    """The topology, labels and training mask of ``graph`` (a
    configuration's ``graph`` entry), drawn from :data:`GRAPH_SEED`: a dict
    of numpy arrays ``src``, ``dst`` (int32, edges flow src -> dst, no
    duplicates, no self loops), ``labels`` (int64), ``train_mask`` (bool)
    and ``num_nodes``."""
    rng = np.random.default_rng(GRAPH_SEED)
    n, m = int(graph["num_nodes"]), int(graph["num_edges"])
    deg = _power_law_degrees(n, m, rng, float(graph["degree_alpha"]))
    k = max(2, int(np.sqrt(n / 4)))
    comm = rng.integers(0, k, size=n)
    members = np.argsort(comm, kind="stable")
    counts = np.bincount(comm, minlength=k)
    starts = np.cumsum(counts) - counts
    base_src = np.repeat(np.arange(n, dtype=np.int64), deg)[:m]

    def sample_edges(src: np.ndarray):
        dst = rng.integers(0, n, size=src.shape[0])
        intra = np.flatnonzero(rng.random(src.shape[0]) < graph["community"])
        # an intra edge's target is a member of its source's community,
        # which holds the source itself, so no community drawn is empty
        c = comm[src[intra]]
        dst[intra] = members[starts[c] + rng.integers(0, counts[c])]
        loops = src == dst
        dst[loops] = (dst[loops] + 1 + rng.integers(0, n - 1, loops.sum())) % n
        return src, dst

    def dedup(src, dst):
        _, first = np.unique(src * n + dst, return_index=True)
        first.sort()
        return src[first], dst[first]

    src, dst = dedup(*sample_edges(base_src))
    for _ in range(6):
        deficit = m - src.shape[0]
        if deficit <= 0:
            break
        es, ed = sample_edges(rng.choice(base_src, size=int(deficit * 1.5)))
        src, dst = dedup(np.concatenate([src, es]), np.concatenate([dst, ed]))
    src, dst = src[:m], dst[:m]

    labels = comm % int(graph["num_classes"])
    train_mask = rng.random(n) < float(graph["train_fraction"])
    perm = rng.permutation(n)           # perm[k]: old id of new node k
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return {"src": inv[src].astype(np.int32), "dst": inv[dst].astype(np.int32),
            "labels": labels[perm].astype(np.int64),
            "train_mask": train_mask[perm], "num_nodes": n}


def make_features(graph: dict, labels: torch.Tensor, seed: int,
                  device: torch.device, rows_per_call: int = 1 << 16
                  ) -> torch.Tensor:
    """The (num_nodes, feat_dim) float32 features on ``device``: standard
    normal noise plus ``center_scale`` times the class centre of each
    node's label, drawn by a generator on the device from ``seed``."""
    n, f = labels.shape[0], int(graph["feat_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, FEATURE_STREAM))
    centers = torch.randn((int(graph["num_classes"]), f), generator=gen,
                          device=device)
    x = torch.randn((n, f), generator=gen, device=device)
    scale = float(graph["center_scale"])
    for lo in range(0, n, rows_per_call):
        hi = min(n, lo + rows_per_call)
        x[lo:hi].add_(centers[labels[lo:hi]], alpha=scale)
    return x
