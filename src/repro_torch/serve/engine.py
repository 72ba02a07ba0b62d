"""The online request path: batcher -> cache -> sampled forward -> cache
(host-side copy of ``repro/serve/engine.py``; the session runs the
per-layer forward on the device).

Per flushed micro-batch the engine:

1. dedupes the requested node ids;
2. looks the survivors up in the final-layer embedding cache — hits are
   served without touching the graph;
3. builds the L-hop dependency block for the misses top-down, *pruning* every
   subtree whose root embedding is already cached at that layer (the runtime
   form of the paper's G-C rule: one cached partial eliminates the whole
   shared set's loads and reductions);
4. gathers leaf features only for nodes no cache layer could serve;
5. runs the per-layer forward bottom-up and inserts every computed embedding
   back into its layer's cache.

With the ``FullNeighborhood`` expander and global degrees the computed rows
equal the offline full-graph forward exactly, so the engine can assert an
oracle check on every served request.  Latency bookkeeping combines the
trace's simulated arrival/flush clock with measured compute wall-time
(queueing backpressure between batches is not modeled).

**SLO mode** (pass a :class:`ServeSLO`): the engine switches to a fully
deterministic service model on the trace clock — batch completion times come
from a modeled compute cost (``cost_per_batch_s`` + ``cost_per_miss_s`` per
computed seed) chained through a ``busy_until`` backpressure clock, so
overload actually backs the engine up, and every shed/degrade decision (and
therefore every counter) is a pure function of the trace.  Each arrival is
validated (malformed ids are *rejected*, never crash the engine) and
admission-controlled: when the bounded queue is full or the modeled backlog
would blow the request's deadline budget, the engine answers **degraded**
from the final-layer cache with an explicit ``stale`` flag — or *sheds*
explicitly when the cache cannot help.  Every response is exact or flagged;
nothing times out silently.  Real wall-time per batch is still measured,
but only into a gauge (``serve.batch_wall_ms``) so timing noise never
touches the deterministic accounting.

Latency state is a **streaming log-bucket histogram**
(:class:`repro_torch.obs.Histogram` — fixed bucket count, so memory stays bounded
no matter how long the trace is), not a per-request list; the report's
p50/p99 come from log-interpolated bucket quantiles with relative error
bounded by one bucket ratio (~2.3%).  Pass ``keep_records=True`` to also
retain the per-request :class:`RequestRecord` list for debugging.  When
:mod:`repro_torch.obs` is enabled the engine additionally mirrors its counters
into the global registry and opens a span per batch stage (dedupe → embed →
oracle) plus one per request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import obs
from .batcher import MicroBatch, MicroBatcher, Request
from .cache import CacheStats, EmbeddingCache


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """The serve-path service-level objective (and its deterministic cost
    model).

    ``deadline_s`` is the per-request latency budget: an arrival whose
    modeled completion would exceed it is answered degraded (stale cache) or
    shed, never left to time out.  ``max_queue`` bounds the pending queue
    (admission control).  ``cost_per_batch_s``/``cost_per_miss_s`` are the
    modeled compute cost of one flushed batch and of each cache-missing seed
    it computes — charged on the trace clock through the engine's
    ``busy_until``, so backpressure, shedding, and every counter are
    deterministic functions of the trace (chaos drills replay them
    bit-for-bit)."""

    deadline_s: float = 0.05
    max_queue: int = 256
    cost_per_batch_s: float = 2e-3
    cost_per_miss_s: float = 1e-4
    degrade: bool = True          # answer stale from cache before shedding


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    req_id: int
    node_id: int
    latency: float            # seconds: flush wait + batch compute
    t_done: float             # completion time on the trace clock
    oracle_err: float
    outcome: str = "exact"    # "exact" | "degraded" | "shed" | "rejected"
    stale: bool = False       # True only for degraded (cache-served) answers


@dataclasses.dataclass(frozen=True)
class ServeReport:
    num_requests: int
    num_batches: int
    p50_ms: float
    p99_ms: float
    req_per_s: float
    max_oracle_err: float
    cache: Optional[CacheStats]
    num_degraded: int = 0
    num_shed: int = 0
    num_rejected: int = 0

    @property
    def hit_rate(self) -> float:
        return self.cache.hit_rate if self.cache is not None else 0.0


class ServeEngine:
    """Drives one session behind a micro-batcher and an embedding cache."""

    def __init__(self, session, cache: Optional[EmbeddingCache] = None,
                 batcher: Optional[MicroBatcher] = None,
                 oracle_check: bool = True, keep_records: bool = False,
                 slo: Optional[ServeSLO] = None):
        self.session = session
        self.cache = cache
        self.batcher = batcher or MicroBatcher()
        self.oracle_check = oracle_check
        self.keep_records = keep_records
        self.records: List[RequestRecord] = []   # only if keep_records
        self.slo = slo
        self.busy_until = 0.0        # modeled engine-free time (SLO mode)
        self.num_degraded = 0
        self.num_shed = 0
        self.num_rejected = 0
        self._last_computed = 0      # seeds the last _embed actually computed
        # the id space arrivals are validated against (None: skip validation)
        g = getattr(session, "g", None)
        self.num_ids = (g.num_nodes if g is not None
                        else getattr(session, "num_users", None))
        # bounded-memory latency state: a streaming histogram + running
        # clock extrema replace the old per-request latency list; ungated —
        # the report's percentiles must work with telemetry off (and the
        # instance is per-engine, not in the global registry)
        self.lat_hist = obs.Histogram("serve.latency_seconds", gated=False)
        self.num_requests = 0
        self._t_first = np.inf                   # earliest arrival seen
        self._t_last = -np.inf                   # latest completion seen
        self.num_batches = 0
        self.max_oracle_err = 0.0

    # -------------------------------------------------------------- warming
    def warm(self, order: np.ndarray,
             layers: Optional[Sequence[int]] = None) -> int:
        """Preload every cache layer along an execution order (e.g. the
        ``lsh_reorder`` permutation) from the offline layer values."""
        if self.cache is None:
            return 0
        n = 0
        for l in (layers if layers is not None
                  else range(self.session.num_layers + 1)):
            n += self.cache.warm(l, order, self.session.layer_values(l))
        return n

    # ------------------------------------------------------------- compute
    def _compute(self, seeds: np.ndarray) -> np.ndarray:
        """Embed unique ``seeds`` via the cache-pruned sampled block."""
        sess, cache = self.session, self.cache
        L = sess.num_layers
        assert L >= 1, "leaf-only sessions are served directly in _embed"

        need: List[Optional[np.ndarray]] = [None] * (L + 1)
        edges: List[Optional[tuple]] = [None] * (L + 1)
        known: List[Dict[int, np.ndarray]] = [dict() for _ in range(L + 1)]
        need[L] = seeds
        for l in range(L, 0, -1):
            if need[l].size == 0:
                need[l - 1] = np.empty(0, np.int32)
                edges[l] = (np.empty(0, np.int32), np.empty(0, np.int32))
                continue
            src, dst = sess.expand(need[l])
            edges[l] = (src, dst)
            children = np.unique(np.concatenate([src, need[l]]))
            if cache is not None and l - 1 >= 1:
                mask, vals = cache.lookup(l - 1, children)
                for u, hit, v in zip(children, mask, vals):
                    if hit:
                        known[l - 1][int(u)] = v
                need[l - 1] = children[~mask]
            else:
                need[l - 1] = children

        if need[0].size:
            base = (cache.fetch_base(need[0], sess.gather)
                    if cache is not None else sess.gather(need[0]))
            for i, u in enumerate(need[0]):
                known[0][int(u)] = base[i]

        for l in range(1, L + 1):
            B = need[l]
            if B.size == 0:
                continue
            src, dst = edges[l]
            lut = {int(u): i for i, u in enumerate(B)}
            dst_index = np.fromiter((lut[int(x)] for x in dst),
                                    dtype=np.int32, count=dst.shape[0])
            prev = known[l - 1]
            d_prev = sess.layer_dims[l - 1]
            src_h = (np.stack([prev[int(u)] for u in src])
                     if src.size else np.empty((0, d_prev), np.float32))
            self_h = np.stack([prev[int(u)] for u in B])
            h = sess.layer_forward(l, B, src, dst_index, src_h, self_h)
            if cache is not None:
                cache.put_many(l, B, h)
            for i, u in enumerate(B):
                known[l][int(u)] = h[i]

        return np.stack([known[L][int(u)] for u in seeds])

    def _embed(self, unique_ids: np.ndarray) -> np.ndarray:
        L = self.session.num_layers
        self._last_computed = int(unique_ids.shape[0])
        if L == 0:
            # leaf-only session (recsys tower): the line cache IS the path
            if self.cache is not None:
                return self.cache.fetch_base(unique_ids, self.session.gather)
            return self.session.gather(unique_ids)
        out = np.empty((unique_ids.shape[0], self.session.layer_dims[L]),
                       np.float32)
        if self.cache is not None:
            mask, vals = self.cache.lookup(L, unique_ids)
            for i, (hit, v) in enumerate(zip(mask, vals)):
                if hit:
                    out[i] = v
        else:
            mask = np.zeros(unique_ids.shape[0], bool)
        miss = unique_ids[~mask]
        self._last_computed = int(miss.size)
        if miss.size:
            out[~mask] = self._compute(miss)
        return out

    # -------------------------------------------------------------- serving
    def process_batch(self, mb: MicroBatch) -> np.ndarray:
        """Serve one flushed micro-batch; returns (live, d) embeddings."""
        with obs.span("serve.batch", cat="serve",
                      size=int(mb.valid.sum())) as bsp:
            t0 = time.perf_counter()
            with obs.span("serve.dedupe", cat="serve"):
                live_ids = mb.node_ids[mb.valid]
                unique_ids, inverse = np.unique(live_ids,
                                                return_inverse=True)
            with obs.span("serve.embed", cat="serve",
                          unique=int(unique_ids.shape[0])):
                emb = self._embed(unique_ids)[inverse]
            compute_dt = time.perf_counter() - t0
            self.num_batches += 1

            errs = np.zeros(live_ids.shape[0], np.float32)
            if self.oracle_check:
                with obs.span("serve.oracle", cat="serve"):
                    ref = self.session.oracle(live_ids)
                    errs = np.max(np.abs(emb - ref), axis=-1)
                    self.max_oracle_err = max(self.max_oracle_err,
                                              float(errs.max(initial=0.0)))
            if self.slo is None:
                t_done = mb.t_flush + compute_dt
            else:
                # modeled completion on the trace clock: deterministic cost
                # chained through busy_until (real wall time goes to a gauge
                # only, so timing noise never reaches the accounting)
                cost = (self.slo.cost_per_batch_s
                        + self.slo.cost_per_miss_s * self._last_computed)
                t_done = max(mb.t_flush, self.busy_until) + cost
                self.busy_until = t_done
                obs.gauge("serve.batch_wall_ms").set(compute_dt * 1e3)
            for i, r in enumerate(mb.requests):
                lat = t_done - r.t_arrival
                self.lat_hist.observe(lat)
                self.num_requests += 1
                self._t_first = min(self._t_first, r.t_arrival)
                self._t_last = max(self._t_last, t_done)
                obs.instant("serve.request", cat="serve", req_id=r.req_id,
                            node_id=r.node_id, latency_ms=lat * 1e3)
                if self.keep_records:
                    self.records.append(RequestRecord(
                        req_id=r.req_id, node_id=r.node_id,
                        latency=lat, t_done=t_done,
                        oracle_err=float(errs[i])))
            obs.counter("serve.requests").inc(len(mb.requests))
            obs.counter("serve.batches").inc()
            bsp.set(compute_ms=compute_dt * 1e3)
        return emb

    # ------------------------------------------------- SLO degradation path
    def _record_aside(self, req: Request, outcome: str, stale: bool = False,
                      latency: float = 0.0) -> None:
        obs.instant("serve.request", cat="serve", req_id=req.req_id,
                    node_id=req.node_id, latency_ms=latency * 1e3,
                    outcome=outcome)
        if self.keep_records:
            self.records.append(RequestRecord(
                req_id=req.req_id, node_id=req.node_id, latency=latency,
                t_done=req.t_arrival + latency, oracle_err=0.0,
                outcome=outcome, stale=stale))

    def _degraded_answer(self, req: Request) -> bool:
        """Answer ``req`` from the final-layer cache, explicitly stale.

        The staleness-flag contract: a degraded response carries whatever
        embedding the cache last computed for the node — served immediately,
        bypassing the queue — and is flagged ``stale=True`` so the client
        knows it is not the freshly computed row.  Returns False (caller
        must shed) when the cache holds nothing for the node."""
        L = self.session.num_layers
        if self.cache is None or L == 0:
            return False
        mask, _vals = self.cache.lookup(L, np.asarray([req.node_id]))
        if not bool(mask[0]):
            return False
        self.num_degraded += 1
        obs.counter("serve.degraded").inc()
        self.lat_hist.observe(0.0)
        self.num_requests += 1
        self._t_first = min(self._t_first, req.t_arrival)
        self._t_last = max(self._t_last, req.t_arrival)
        self._record_aside(req, "degraded", stale=True)
        return True

    def _admit(self, req: Request) -> bool:
        """SLO-mode admission: validate, budget, degrade-or-shed.

        True means "enqueue normally"; False means the request was already
        answered (degraded) or explicitly refused (rejected/shed)."""
        slo, t = self.slo, req.t_arrival
        if self.num_ids is not None and not (
                0 <= int(req.node_id) < self.num_ids):
            self.num_rejected += 1
            obs.counter("serve.rejected", reason="malformed").inc()
            self._record_aside(req, "rejected")
            return False
        # worst-case modeled completion if admitted: deadline-triggered
        # flush, engine backlog, full-batch miss compute
        est = (max(self.busy_until, t + self.batcher.max_wait)
               + slo.cost_per_batch_s
               + slo.cost_per_miss_s * min(len(self.batcher.pending) + 1,
                                           self.batcher.max_batch))
        full = len(self.batcher.pending) >= slo.max_queue
        if not full and est - t <= slo.deadline_s:
            return True
        if slo.degrade and self._degraded_answer(req):
            return False
        self.num_shed += 1
        obs.counter("serve.shed",
                    reason="queue_full" if full else "deadline").inc()
        self._record_aside(req, "shed")
        return False

    def serve(self, requests: Sequence[Request]) -> ServeReport:
        """Run a whole trace through the batcher and report."""
        stream = sorted(requests, key=lambda r: r.t_arrival)
        for req in stream:
            due = self.batcher.due()
            if due is not None and req.t_arrival >= due:
                mb = self.batcher.poll(due)
                if mb is not None:
                    self.process_batch(mb)
            if self.slo is not None and not self._admit(req):
                continue
            mb = self.batcher.submit(req)
            if mb is not None:
                self.process_batch(mb)
        t_end = self.batcher.due()
        if t_end is None and stream:
            t_end = stream[-1].t_arrival
        mb = self.batcher.drain(t_end if t_end is not None else 0.0)
        if mb is not None:
            self.process_batch(mb)
        return self.report()

    def report(self) -> ServeReport:
        if self.num_requests:
            p50 = self.lat_hist.percentile(50)
            p99 = self.lat_hist.percentile(99)
            rate = self.num_requests / max(self._t_last - self._t_first,
                                           1e-9)
        else:
            p50 = p99 = rate = 0.0
        stats = self.cache.stats() if self.cache is not None else None
        self._export_metrics(p50, p99, rate, stats)
        return ServeReport(
            num_requests=self.num_requests, num_batches=self.num_batches,
            p50_ms=float(p50) * 1e3, p99_ms=float(p99) * 1e3,
            req_per_s=float(rate),
            max_oracle_err=self.max_oracle_err,
            cache=stats,
            num_degraded=self.num_degraded, num_shed=self.num_shed,
            num_rejected=self.num_rejected)

    def _export_metrics(self, p50: float, p99: float, rate: float,
                        stats: Optional[CacheStats]) -> None:
        """Mirror the report into the global registry (gated: no-ops with
        telemetry off) — latency percentiles, throughput, and the per-layer
        G-D / G-C cache stats re-exported as ``serve.cache.*`` gauges."""
        if not obs.enabled():
            return
        obs.gauge("serve.latency_p50_ms").set(p50 * 1e3)
        obs.gauge("serve.latency_p99_ms").set(p99 * 1e3)
        obs.gauge("serve.req_per_s").set(rate)
        obs.gauge("serve.max_oracle_err").set(self.max_oracle_err)
        obs.gauge("serve.queue_depth_hwm").set(self.batcher.depth_hwm)
        if stats is None:
            return
        obs.gauge("serve.cache.hit_rate").set(stats.hit_rate)
        obs.gauge("serve.cache.bytes_served").set(stats.bytes_served)
        obs.gauge("serve.cache.bytes_missed").set(stats.bytes_missed)
        for l, d in stats.per_layer.items():
            obs.gauge("serve.cache.hits", layer=l).set(d["hits"])
            obs.gauge("serve.cache.misses", layer=l).set(d["misses"])
            obs.gauge("serve.cache.evictions", layer=l).set(d["evictions"])
            h, m = d["hits"], d["misses"]
            obs.gauge("serve.cache.hit_rate", layer=l).set(
                h / max(h + m, 1))
            if "vec_bytes" in d:
                obs.gauge("serve.cache.vec_bytes", layer=l).set(
                    d["vec_bytes"])
            if "miss_bytes" in d:
                obs.gauge("serve.cache.miss_bytes", layer=l).set(
                    d["miss_bytes"])
