"""Synthetic click logs for recsys training (the ``recsys_batches`` of
``repro/train/data.py``): numpy, deterministic per (seed, step), byte-equal
to the reference's batches.  The loss function moves them to the device."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .fault import deterministic_batch_seed


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
