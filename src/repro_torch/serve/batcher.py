"""Dynamic micro-batching of single-node inference requests (host-side copy
of ``repro/serve/batcher.py``).

The batcher coalesces pending requests and flushes a *bucket* when it fills
or when the oldest pending request has waited ``max_wait`` seconds.  Flushed
buckets are padded to the next power of two (duplicating the last live id, a
mask marks live rows) exactly as in the reference, so the two engines batch
a trace identically.

Time is explicit everywhere (``t`` arguments, no wall-clock reads), so the
batcher is deterministic under simulated traces and trivially testable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import obs


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request for a single node (user/item/vertex) id."""

    req_id: int
    node_id: int
    t_arrival: float


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A flushed bucket: ``node_ids`` is pow2-padded, ``valid`` marks rows."""

    requests: List[Request]
    node_ids: np.ndarray          # (pow2,) int32, padded with last live id
    valid: np.ndarray             # (pow2,) bool
    t_flush: float
    reason: str                   # "full" | "deadline" | "drain"

    @property
    def num_live(self) -> int:
        return len(self.requests)

    @property
    def bucket_size(self) -> int:
        return int(self.node_ids.shape[0])


def pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= n (optionally clamped to ``cap``)."""
    b = 1 << max(int(n) - 1, 0).bit_length()
    return min(b, cap) if cap is not None else b


class MicroBatcher:
    """Deadline/size-triggered request coalescing.

    ``max_queue`` bounds the pending queue: :meth:`try_submit` sheds (refuses)
    arrivals once the bound is reached instead of queueing without limit —
    the admission-control half of the serve SLO story (:class:`repro_torch.
    serve.ServeSLO`).  The default (``None``) keeps the queue unbounded and
    :meth:`submit` unconditional.
    """

    def __init__(self, max_batch: int = 64, max_wait: float = 2e-3,
                 max_queue: Optional[int] = None):
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError("max_batch must be a power of two "
                             "(bucket discipline)")
        self.max_batch = max_batch
        self.max_wait = float(max_wait)
        self.max_queue = max_queue
        self.pending: List[Request] = []
        self.depth_hwm = 0            # deepest the queue ever got
        self.shed = 0                 # arrivals refused by try_submit

    def _flush(self, t: float, reason: str) -> MicroBatch:
        obs.counter("serve.flush", reason=reason).inc()
        obs.histogram("serve.flush_size", lo=1.0, hi=1e5,
                      per_decade=20).observe(float(len(self.pending)))
        reqs, self.pending = self.pending, []
        obs.gauge("serve.queue_depth").set(0)
        ids = np.array([r.node_id for r in reqs], dtype=np.int32)
        b = pow2_bucket(ids.shape[0], self.max_batch)
        pad = b - ids.shape[0]
        node_ids = np.concatenate([ids, np.full(pad, ids[-1], np.int32)])
        valid = np.zeros(b, dtype=bool)
        valid[:ids.shape[0]] = True
        return MicroBatch(requests=reqs, node_ids=node_ids, valid=valid,
                          t_flush=t, reason=reason)

    def submit(self, req: Request) -> Optional[MicroBatch]:
        """Add a request at its arrival time; returns a batch if now full."""
        self.pending.append(req)
        if len(self.pending) > self.depth_hwm:
            self.depth_hwm = len(self.pending)
            obs.gauge("serve.queue_depth_hwm").set(self.depth_hwm)
        obs.gauge("serve.queue_depth").set(len(self.pending))
        if len(self.pending) >= self.max_batch:
            return self._flush(req.t_arrival, "full")
        return None

    @property
    def queue_full(self) -> bool:
        return (self.max_queue is not None
                and len(self.pending) >= self.max_queue)

    def try_submit(self, req: Request):
        """Admission-controlled submit: ``(admitted, batch)``.

        Sheds the request (returns ``(False, None)``, counts ``serve.shed``)
        when the bounded queue is full; otherwise behaves like
        :meth:`submit`."""
        if self.queue_full:
            self.shed += 1
            obs.counter("serve.shed", reason="queue_full").inc()
            return False, None
        return True, self.submit(req)

    def due(self) -> Optional[float]:
        """Deadline of the oldest pending request (None when queue empty)."""
        if not self.pending:
            return None
        return self.pending[0].t_arrival + self.max_wait

    def poll(self, t: float) -> Optional[MicroBatch]:
        """Flush if the oldest pending request's deadline has passed."""
        if self.pending and t - self.pending[0].t_arrival >= self.max_wait:
            return self._flush(t, "deadline")
        return None

    def drain(self, t: float) -> Optional[MicroBatch]:
        """Flush whatever is left (end of stream)."""
        if self.pending:
            return self._flush(t, "drain")
        return None


# --------------------------------------------------------------- traffic
def zipfian_trace(num_nodes: int, num_requests: int, a: float = 1.1,
                  rate: float = 5000.0, seed: int = 0,
                  permute: bool = True) -> List[Request]:
    """Zipf(a) request popularity over a fixed random relabeling of nodes.

    ``permute=True`` decouples popularity rank from node id (and therefore
    from any node *order* — neither index- nor reorder-warming gets the
    answer for free).  Arrivals are Poisson at ``rate`` req/s.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    p = ranks ** (-float(a))
    p /= p.sum()
    perm = rng.permutation(num_nodes) if permute else np.arange(num_nodes)
    picks = perm[rng.choice(num_nodes, size=num_requests, p=p)]
    gaps = rng.exponential(1.0 / rate, size=num_requests)
    t = np.cumsum(gaps)
    return [Request(req_id=i, node_id=int(picks[i]), t_arrival=float(t[i]))
            for i in range(num_requests)]
