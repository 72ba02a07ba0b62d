"""Training data (the port of ``repro/train/data.py``): a synthetic token
stream (LM), synthetic click logs (recsys), both deterministic per (seed,
step) and numpy, byte-equal to the reference's; sampled GNN minibatches;
and a background prefetcher that moves the next batch to the device while
the current step runs.  Without the prefetcher the loss function moves a
batch to the device."""
from __future__ import annotations

import threading
from queue import Queue
from typing import Iterator, Optional

import numpy as np
import torch

from .fault import deterministic_batch_seed


def lm_token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                     start_step: int = 0) -> Iterator[dict]:
    """Zipf-ish synthetic token stream; targets = inputs shifted by one."""
    step = start_step
    while True:
        rng = np.random.default_rng(deterministic_batch_seed(seed, step, 0))
        raw = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        toks = (raw % vocab).astype(np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:], "step": step}
        step += 1


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


class Prefetcher:
    """Background prefetch: up to ``depth`` batches ahead, each array entry
    of a batch (numpy or tensor) moved to ``device`` on a worker thread
    while the current step runs; other entries pass as they are.  Without a
    device it only runs the source iterator ahead.

    On a CUDA device the worker pins each array and copies it with
    ``non_blocking=True`` on a side stream, then records an event.  So the
    copy may still be in flight when the batch is handed out: ``__next__``
    makes the consumer's current stream wait on that event before it
    returns the batch, and marks each tensor as used by that stream
    (``record_stream``), so the allocator cannot reuse its memory before
    the consumer's work on it is done.  An error of the source iterator or
    of a copy is raised by the ``__next__`` that reaches it."""

    def __init__(self, it: Iterator, device=None, depth: int = 2):
        self.it = it
        self.device = None if device is None else torch.device(device)
        self.q: Queue = Queue(maxsize=depth)
        cuda = self.device is not None and self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.error: Optional[Exception] = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _move(self, v):
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            return v
        t = torch.as_tensor(v)
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _put(self, batch):
        event = None
        if self.device is not None:
            if self.stream is None:
                batch = {k: self._move(v) for k, v in batch.items()}
            else:
                with torch.cuda.stream(self.stream):
                    batch = {k: self._move(v) for k, v in batch.items()}
                    event = torch.cuda.Event()
                    event.record(self.stream)
        self.q.put((batch, event))

    def _run(self):
        try:
            for batch in self.it:
                self._put(batch)
        except Exception as e:      # raised on the consumer's thread
            self.error = e
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            self.q.put(None)        # every later call stops too
            if self.error is not None:
                raise self.error
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
        return batch
