"""Training data (the ``recsys_batches`` and ``gnn_epoch_batches`` of
``repro/train/data.py``): synthetic click logs, deterministic per (seed,
step), and sampled GNN minibatches, both numpy and byte-equal to the
reference's.  The loss function moves them to the device."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .fault import deterministic_batch_seed


def gnn_epoch_batches(sampler, batch_nodes: int, steps: int, seed: int = 0):
    """``steps`` minibatches of ``batch_nodes`` seeds from a
    ``graph.NeighborSampler`` (its own generator draws them; ``seed`` is
    unused, as in the reference)."""
    return sampler.batches(batch_nodes, steps)


def minibatch_tensors(g, mb, device="cuda") -> dict:
    """A sampled ``MiniBatch`` of graph ``g`` as the tensors
    ``models.sage_block_apply`` and a seed-row loss take: the input
    frontier's features ``x``, the blocks' renumbered edge lists, the seeds'
    rows of the frontier and their labels (as the reference's example builds
    its batch)."""
    t = lambda a: torch.as_tensor(a).to(device)
    return {"x": t(g.node_feat[mb.input_nodes]),
            "blocks": [{"src": t(s.astype(np.int64)),
                        "dst": t(d.astype(np.int64))}
                       for s, d in zip(mb.edge_src, mb.edge_dst)],
            "seed_rows": t(np.searchsorted(mb.input_nodes, mb.seeds)),
            "labels": t(g.labels[mb.seeds].astype(np.int64))}


def recsys_batches(cfg, batch: int, seed: int = 0, start_step: int = 0
                   ) -> Iterator[dict]:
    step = start_step
    while True:
        rng = np.random.default_rng(deterministic_batch_seed(seed, step, 0))
        ids = rng.integers(0, cfg.rows_per_field,
                           size=(batch, cfg.n_sparse)).astype(np.int32)
        dense = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
        # weak ground-truth signal so training converges measurably
        w = rng.standard_normal(cfg.n_dense).astype(np.float32)
        labels = (dense @ w + 0.1 * rng.standard_normal(batch) > 0
                  ).astype(np.float32)
        yield {"sparse": ids, "dense": dense, "labels": labels, "step": step}
        step += 1
