"""repro_torch.dist.elastic — survive shard death, not just a bad step
(port of ``repro/dist/elastic.py``; single-process, as in the reference).

``resilient_halo_aggregate`` degrades exactly one step: a lost shard
pushes the affected aggregation onto the all-gather path and the next step
retries the dead exchange.  This module is the full membership state
machine around that reflex:

* :class:`RetryPolicy` — a seeded, deterministic retry ladder: bounded
  exponential backoff + jitter where every delay is a pure function of
  ``(seed, step, attempt)`` drawn with numpy's generator (the reference's
  schedules, byte for byte), charged to a :class:`ModeledClock`: wall time
  never touches the deterministic state, so chaos drills replay
  bit-identically.
* :class:`ShardHealth` — classifies faults transient-vs-persistent from the
  ``dist.halo_fallback`` history: consecutive fallback steps raise a decayed
  per-shard score; crossing ``evict_after`` flips the verdict to persistent.
* :class:`ElasticAggregator` — the membership state machine itself
  (``active → suspect → evicted → active``).  A faulted step walks the
  ladder (retry → per-step allgather); a persistently failing shard is
  **evicted** and :meth:`ElasticAggregator.repartition_survivors` rebuilds
  the contiguous-window partition, the
  :class:`~repro_torch.graph.partition.HaloPlan` send/recv tables, and
  every survivor's per-shard plan (an
  :class:`~repro_torch.exec.fallback.ResilientPlan` in ``mode="sum"``,
  ``weighted=True``, so the rebuild is quarantine-respecting; topologies are
  memoized, so a 2→1→2 rejoin cycle reuses the warm plans).  The dead
  shard's rows migrate to the survivors: training continues at halo speed
  instead of pinning allgather.  :meth:`ElasticAggregator.rejoin` restores
  full width.

Execution model: the aggregator runs the *modeled* exchange in one process
on one device: each shard's ``[owned | halo]`` row block (``x[lo:hi]`` and
the gather ``x[halo_ids]`` on the device) feeds that shard's own plan.  On
``cuda`` that plan is the ``spmm_blockell_compact`` kernel over the halo
plan's edge weights (0/1 uint8 tiles when every weight is 1 and no edge
repeats, float32 tiles otherwise), one launch per shard per aggregation
and one through its transpose plan per shard in the backward.  The result is
exactly ``core.segment_aggregate`` for every membership, so drills diff
the faulted run against a single-device oracle.  Mesh execution goes
through :func:`repro_torch.dist.resilient.resilient_halo_aggregate`,
which shares this module's retry ladder.

Telemetry: ``dist.membership{state=...}`` gauges, ``dist.elastic.retry`` /
``dist.elastic.evict`` / ``dist.elastic.rejoin`` counters, and a
``dist.elastic.repartition`` span per topology rebuild, all through
:mod:`repro_torch.obs`, under the reference's names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..chaos import inject as chaos
from ..core.aggregate import segment_sum
from ..device import resolve_device
from ..graph.partition import HaloPlan, Partition, build_halo_plan
from ..graph.structure import Graph
from .plan import SendPlan, build_send_plan

FAULT_KINDS = ("shard_loss", "straggler")

# membership states
ACTIVE, SUSPECT, EVICTED = "active", "suspect", "evicted"


class ModeledClock:
    """Deterministic drill clock: advances only by modeled charges.

    Same discipline as ``ServeSLO``'s ``busy_until`` accounting — nothing
    here ever reads wall time, so two same-seed runs see identical clocks.
    """

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Seeded deterministic retry ladder for the halo exchange.

    ``backoff(step, attempt)`` = min(base * factor^attempt, max_backoff) *
    (1 + jitter * u) where u is drawn from a generator seeded by
    ``(seed, step, attempt)`` — a pure function, so same (seed, spec) yields
    the identical backoff schedule every run.  ``budget_s`` bounds the total
    modeled delay a single step may spend retrying before degrading
    (``resilient_halo_aggregate`` maps its legacy ``timeout_s`` onto it).
    """

    max_retries: int = 2
    base_s: float = 1e-3
    factor: float = 2.0
    max_backoff_s: float = 0.1
    jitter: float = 0.25
    budget_s: Optional[float] = None
    seed: int = 0

    def backoff(self, step: int, attempt: int) -> float:
        base = min(self.base_s * self.factor ** attempt, self.max_backoff_s)
        u = float(np.random.default_rng(
            (int(self.seed), int(step), int(attempt))).random())
        return base * (1.0 + self.jitter * u)

    def schedule(self, step: int) -> Tuple[float, ...]:
        """The full backoff ladder a faulted ``step`` would walk."""
        return tuple(self.backoff(step, a) for a in range(self.max_retries))


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """When does a shard's fault history read as *persistent*?

    ``evict_after`` consecutive fallback steps attributed to one shard flip
    its classification to persistent; a healthy step multiplies the shard's
    accumulated score by ``decay`` (so old trouble fades instead of pinning
    the shard suspect forever).
    """

    evict_after: int = 2
    decay: float = 0.5


class ShardHealth:
    """Transient-vs-persistent classification from ``dist.halo_fallback``
    history (:class:`ElasticAggregator` feeds it one record per degraded
    step, which is exactly when ``dist.halo_fallback`` counts)."""

    def __init__(self, policy: Optional[HealthPolicy] = None):
        self.policy = policy or HealthPolicy()
        self.consecutive: Dict[int, int] = {}
        self.score: Dict[int, float] = {}

    def record_failure(self, shard: int, kind: str = "shard_loss") -> None:
        self.consecutive[shard] = self.consecutive.get(shard, 0) + 1
        self.score[shard] = self.score.get(shard, 0.0) + 1.0

    def record_success(self, shard: int) -> None:
        self.consecutive[shard] = 0
        s = self.score.get(shard, 0.0) * self.policy.decay
        self.score[shard] = 0.0 if s < 1e-6 else s

    def reset(self, shard: int) -> None:
        self.consecutive.pop(shard, None)
        self.score.pop(shard, None)

    def classify(self, shard: int) -> str:
        c = self.consecutive.get(shard, 0)
        if c >= self.policy.evict_after:
            return "persistent"
        return "transient" if c > 0 else "healthy"


# ---------------------------------------------------------------- topology
@dataclasses.dataclass
class _ShardSlot:
    """One survivor's slice of the exchange: its window, the global ids of
    its halo rows, and the per-shard execution plan over the renumbered
    ``[owned | halo]`` row space."""

    lo: int
    hi: int
    halo_ids: np.ndarray          # (h,) int32 global ids, unpadded
    plan: "object"                # ResilientPlan over the local graph

    @property
    def local_n(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass
class ElasticTopology:
    """Everything one membership's exchange needs, rebuilt on evict/rejoin."""

    version: int
    active: Tuple[int, ...]
    partition: Partition
    halo: HaloPlan
    send: SendPlan
    shards: List[_ShardSlot]
    halo_rows: int                # total deduplicated remote rows / exchange

    @property
    def num_parts(self) -> int:
        return len(self.active)


def _local_graph(halo: HaloPlan, p: int) -> Tuple[Graph, np.ndarray]:
    """Shard ``p``'s aggregation as a standalone graph over
    ``local_n + halo_n`` nodes (sources renumbered into the [owned | halo]
    row space, destinations in [0, local_n))."""
    lo = int(halo.parts.boundaries[p])
    hi = int(halo.parts.boundaries[p + 1])
    local_n = hi - lo
    hm = halo.halo_mask[p]
    halo_ids = halo.halo_src[p][hm].astype(np.int32)
    em = halo.edge_mask[p]
    g = Graph(src=halo.edge_src[p][em].astype(np.int32),
              dst=halo.edge_dst[p][em].astype(np.int32),
              num_nodes=local_n + int(halo_ids.shape[0]),
              edge_weight=halo.edge_weight[p][em].astype(np.float32))
    return g, halo_ids


def build_elastic_topology(g: Graph, active: Tuple[int, ...], *,
                           version: int = 0,
                           backend: Optional[str] = None,
                           cache_dir: Optional[str] = None,
                           probe: bool = True,
                           device="cuda") -> ElasticTopology:
    """Partition ``g`` over ``len(active)`` contiguous windows and compile
    every shard's local aggregation into its own plan chain.

    The per-shard plans are
    :class:`~repro_torch.exec.fallback.ResilientPlan`s in
    ``mode="sum"``/``weighted=True`` (the halo plan's edge weights already
    carry any normalization) on ``device`` (primary ``cuda`` on a CUDA
    device unless ``backend`` names another), so the rebuild consults the
    autotune cache's quarantine verdicts and each shard keeps its own
    demotion chain.
    """
    from ..exec.fallback import ResilientPlan
    k = len(active)
    halo = build_halo_plan(g, k)
    send = build_send_plan(halo)
    shards: List[_ShardSlot] = []
    halo_rows = 0
    for p in range(k):
        lg, halo_ids = _local_graph(halo, p)
        plan = ResilientPlan(lg, "sum", backend=backend, weighted=True,
                             probe=probe, cache_dir=cache_dir, device=device)
        halo_rows += int(halo_ids.shape[0])
        shards.append(_ShardSlot(lo=int(halo.parts.boundaries[p]),
                                 hi=int(halo.parts.boundaries[p + 1]),
                                 halo_ids=halo_ids, plan=plan))
    return ElasticTopology(version=version, active=tuple(active),
                           partition=halo.parts, halo=halo, send=send,
                           shards=shards, halo_rows=halo_rows)


# ------------------------------------------------------------- aggregator
class ElasticAggregator:
    """Shard-membership state machine over the modeled halo exchange.

    ``parts`` logical shards own contiguous windows of ``g``.  Per step,
    :meth:`step_begin` walks the retry ladder against the ``dist.halo``
    injection site and decides the step's path (``halo`` or the per-step
    ``allgather`` fallback), feeds :class:`ShardHealth`, and — when a
    shard's fault history turns persistent — evicts it and repartitions the
    survivors.  :meth:`aggregate_fn` then returns a differentiable
    ``x -> (N, d)`` for the decided path, so a train step can backprop
    through whichever exchange actually ran.  Every plan and index array
    lives on ``device`` (``cuda`` unless the caller asks for ``cpu``).
    """

    def __init__(self, g: Graph, parts: int, *,
                 policy: Optional[RetryPolicy] = None,
                 health: Optional[ShardHealth] = None,
                 backend: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 clock: Optional[ModeledClock] = None,
                 probe: bool = True, device="cuda"):
        if parts < 1:
            raise ValueError("parts must be >= 1")
        self.g = g
        self.full_width = parts
        self.policy = policy or RetryPolicy()
        self.health = health or ShardHealth()
        self.backend = backend
        self.cache_dir = cache_dir
        self.clock = clock or ModeledClock()
        self.probe = probe
        self.device = resolve_device(device)
        self.membership: Dict[int, str] = {s: ACTIVE for s in range(parts)}
        self._versions = 0
        self._topologies: Dict[Tuple[int, ...], ElasticTopology] = {}
        self.topology = self._install(tuple(range(parts)))
        # the allgather/oracle arrays: one global weighted segment-sum
        valid = (g.edge_mask if g.edge_mask is not None
                 else np.ones(g.num_edges, bool))
        w = (g.edge_weight if g.edge_weight is not None
             else np.ones(g.num_edges, np.float32))
        self._src = torch.as_tensor(g.src[valid].astype(np.int64),
                                    device=self.device)
        self._dst = torch.as_tensor(g.dst[valid].astype(np.int64),
                                    device=self.device)
        self._w = torch.as_tensor(w[valid].astype(np.float32),
                                  device=self.device)
        self._publish_membership()

    # ------------------------------------------------------------ topology
    @property
    def active(self) -> Tuple[int, ...]:
        return self.topology.active

    def _install(self, active: Tuple[int, ...]) -> ElasticTopology:
        topo = self._topologies.get(active)
        warm = topo is not None
        with obs.span("dist.elastic.repartition", cat="dist",
                      parts=len(active), warm=warm):
            if topo is None:
                self._versions += 1
                topo = build_elastic_topology(
                    self.g, active, version=self._versions,
                    backend=self.backend, cache_dir=self.cache_dir,
                    probe=self.probe, device=self.device)
                self._topologies[active] = topo
        prev = getattr(self, "topology", None)
        if prev is not None:
            migrated = self._migrated_rows(prev, topo)
            obs.counter("dist.elastic.rows_migrated").inc(migrated)
            obs.instant("dist.elastic.repartition", cat="dist",
                        parts=len(active), rows_migrated=migrated, warm=warm)
        self.topology = topo
        obs.gauge("dist.elastic.halo_rows").set(topo.halo_rows)
        return topo

    @staticmethod
    def _migrated_rows(prev: ElasticTopology, new: ElasticTopology) -> int:
        """Nodes whose owning *physical* shard changed across the rebuild."""
        nodes = np.arange(int(prev.partition.boundaries[-1]))
        prev_owner = np.asarray(prev.active)[prev.partition.part_of(nodes)]
        new_owner = np.asarray(new.active)[new.partition.part_of(nodes)]
        return int((prev_owner != new_owner).sum())

    def repartition_survivors(self, dead: int) -> ElasticTopology:
        """Evict ``dead`` and rebuild the exchange for the survivors: new
        contiguous-window partition, new HaloPlan send/recv tables, and a
        per-shard plan per survivor.  The dead shard's rows migrate into the
        survivors' windows, so the next healthy step runs at halo speed."""
        survivors = tuple(s for s in self.active if s != dead)
        if not survivors:
            raise RuntimeError("cannot evict the last live shard")
        self.membership[dead] = EVICTED
        self.health.reset(dead)
        obs.counter("dist.elastic.evict").inc()
        obs.instant("dist.elastic.evict", cat="dist", shard=dead)
        topo = self._install(survivors)
        self._publish_membership()
        return topo

    def rejoin(self, shard: int) -> ElasticTopology:
        """Bring an evicted shard back: full-width partition restored (warm
        from the topology memo when the membership was seen before)."""
        if self.membership.get(shard) != EVICTED:
            raise ValueError(f"shard {shard} is not evicted "
                             f"({self.membership.get(shard)!r})")
        self.membership[shard] = ACTIVE
        self.health.reset(shard)
        obs.counter("dist.elastic.rejoin").inc()
        obs.instant("dist.elastic.rejoin", cat="dist", shard=shard)
        topo = self._install(tuple(sorted(set(self.active) | {shard})))
        self._publish_membership()
        return topo

    def _publish_membership(self) -> None:
        counts = {ACTIVE: 0, SUSPECT: 0, EVICTED: 0}
        for st in self.membership.values():
            counts[st] = counts.get(st, 0) + 1
        for st, n in counts.items():
            obs.gauge("dist.membership", state=st).set(n)
        obs.gauge("dist.parts").set(len(self.active))

    # -------------------------------------------------------------- ladder
    def _default_victim(self) -> int:
        """A fault with no shard payload is attributed deterministically to
        the highest-numbered active shard (same choice every replay)."""
        return self.active[-1]

    def step_begin(self, step: int) -> Dict:
        """Walk the retry ladder for ``step``; returns the step decision
        (path, retries, membership changes).  Pure state machine — the
        actual math runs through :meth:`aggregate_fn`."""
        retries, waited = 0, 0.0
        fault: Optional[Tuple[int, str]] = None
        for attempt in range(self.policy.max_retries + 1):
            f = chaos.fire("dist.halo")
            if f is None or f.kind not in FAULT_KINDS:
                fault = None
                break
            shard = f.arg("shard")
            shard = int(shard) if shard is not None else self._default_victim()
            if self.membership.get(shard) == EVICTED:
                # the dead can't die again: a stale fault for an already
                # evicted shard no longer degrades anyone
                obs.counter("dist.elastic.stale_fault", kind=f.kind).inc()
                fault = None
                break
            fault = (shard, f.kind)
            if attempt == self.policy.max_retries:
                break
            delay = self.policy.backoff(step, attempt)
            if (self.policy.budget_s is not None
                    and waited + delay > self.policy.budget_s):
                break
            waited += delay
            self.clock.advance(delay)
            retries += 1
            obs.counter("dist.elastic.retry", kind=f.kind).inc()

        info = {"step": int(step), "path": "halo", "reason": None,
                "retries": retries, "evicted": None,
                "parts": len(self.active)}
        if fault is not None:
            shard, kind = fault
            self.health.record_failure(shard, kind)
            obs.counter("dist.halo_fallback", reason=kind).inc()
            obs.instant("dist.halo_fallback", cat="dist", reason=kind,
                        shard=shard)
            if self.membership.get(shard) == ACTIVE:
                self.membership[shard] = SUSPECT
            info.update(path="allgather", reason=kind)
            if self.health.classify(shard) == "persistent":
                self.repartition_survivors(shard)
                info.update(evicted=shard, parts=len(self.active))
        else:
            for s in self.active:
                self.health.record_success(s)
                if self.membership.get(s) == SUSPECT:
                    self.membership[s] = ACTIVE
            if retries:
                obs.counter("dist.elastic.recovered").inc()
        obs.counter("dist.elastic.steps", path=info["path"],
                    parts=info["parts"]).inc()
        self._publish_membership()
        info["version"] = self.topology.version
        return info

    # ------------------------------------------------------------ execute
    def aggregate_fn(self, path: str = "halo") -> Callable:
        """A differentiable ``x -> (N, d)`` for ``path`` on the current
        topology.  ``halo`` routes every shard's [owned | halo] block
        through that shard's execution plan (the gather of its halo rows
        runs on the device); ``allgather`` is the modeled full-table
        fallback (one global weighted segment-sum)."""
        if path == "allgather":
            src, dst, w, n = self._src, self._dst, self._w, self.g.num_nodes

            def allgather(x):
                return segment_sum(x[src] * w[:, None], dst, n)
            return allgather
        topo = self.topology
        slots = [(s.lo, s.hi,
                  torch.as_tensor(s.halo_ids.astype(np.int64),
                                  device=self.device),
                  s.plan.plan_for(s.plan.backend))
                 for s in topo.shards]

        def halo(x):
            outs = []
            for lo, hi, ids, plan in slots:
                xl = x[lo:hi]
                full = (torch.cat([xl, x[ids]], dim=0)
                        if ids.shape[0] else xl)
                outs.append(plan.apply(full)[: hi - lo])
            return torch.cat(outs, dim=0)
        return halo

    def aggregate(self, x: torch.Tensor, step: int = 0) -> torch.Tensor:
        """Ladder + execute in one call (eager paths, tests, serving).  For
        training, call :meth:`step_begin` then :meth:`aggregate_fn` so the
        differentiable part stays pure."""
        info = self.step_begin(step)
        d = x.shape[1] if x.ndim > 1 else 1
        if info["path"] == "halo":
            obs.gauge("dist.elastic.bytes_per_step").set(
                self.topology.halo_rows * d * 4)
        else:
            k = max(len(self.active), 1)
            obs.gauge("dist.elastic.bytes_per_step").set(
                (k - 1) * self.g.num_nodes / k * d * 4)
        return self.aggregate_fn(info["path"])(x)


# -------------------------------------------------------------- training
def _noop(*a, **kw):
    pass


def elastic_step(agg_fn: Callable, x: torch.Tensor, deg: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, opt) -> Callable:
    """``train_elastic``'s step over ``agg_fn``: a SAGE-mean layer stack
    (``h W_self + (AGG(h) / deg) W_neigh + b``, ReLU between layers), the
    masked mean cross-entropy, clip at global norm 1.0, then ``opt``; as
    ``(params, opt_state, None) -> (params, opt_state, loss)``."""
    from ..train.loop import make_train_step

    def loss_fn(p, _batch):
        h = x
        for i, lp in enumerate(p):
            a = agg_fn(h) / deg[:, None]
            h = h @ lp["w_self"] + a @ lp["w_neigh"] + lp["b"]
            if i < len(p) - 1:
                h = torch.relu(h)
        logp = torch.log_softmax(h, dim=-1)
        picked = logp.gather(1, labels[:, None])[:, 0]
        return -(picked * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return make_train_step(loss_fn, opt, clip_norm=1.0, donate=False)


def train_elastic(g: Graph, *, parts: int = 2, steps: int = 12,
                  lr: float = 1e-2, hidden: int = 16, seed: int = 0,
                  aggregator: Optional[ElasticAggregator] = None,
                  policy: Optional[RetryPolicy] = None,
                  health: Optional[HealthPolicy] = None,
                  backend: Optional[str] = None,
                  cache_dir: Optional[str] = None,
                  rejoin_at: Optional[int] = None,
                  ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                  log: Callable = _noop, device="cuda") -> Dict:
    """Train a SAGE-style GNN with aggregation routed through the elastic
    state machine (modeled exchange; per-shard plans) on ``device``.

    ``rejoin_at`` models the operator bringing dead shards back at that
    step.  ``ckpt_dir`` enables buddy-mirrored checkpoints
    (:func:`repro_torch.train.checkpoint.save_mirrored_checkpoint`) every
    ``ckpt_every`` steps, sharded over the *full* logical width.  The
    weights are ``dist.gnn.dist_gnn_init`` drawn from a
    ``torch.Generator`` seeded with ``seed``; the step is the reference's
    (loss and gradients, clip at global norm 1.0, Adam), one closure per
    (path, topology version) where the reference caches a ``jax.jit``.
    Returns losses, final params, the per-step path/membership trail, and
    the final modeled clock.
    """
    from ..train.optimizer import adam
    if g.node_feat is None or g.labels is None:
        raise ValueError("train_elastic needs node_feat and labels")
    dev = resolve_device(device)
    agg = aggregator or ElasticAggregator(
        g, parts, policy=policy,
        health=ShardHealth(health) if health else None,
        backend=backend, cache_dir=cache_dir, device=dev)
    n_classes = int(g.labels.max()) + 1
    t = lambda a: torch.as_tensor(a, device=dev)
    deg = t(np.maximum(g.in_degrees().astype(np.float32), 1.0))
    x = t(g.node_feat)
    labels = t(g.labels.astype(np.int64))
    mask = t(g.train_mask if g.train_mask is not None
             else np.ones(g.num_nodes, bool)).to(torch.float32)
    from .gnn import dist_gnn_init
    params = dist_gnn_init(torch.Generator().manual_seed(seed),
                           [g.node_feat.shape[1], hidden, n_classes],
                           device=dev)
    opt = adam(lr)
    opt_state = opt.init(params)

    step_fns: Dict = {}
    losses: List[float] = []
    trail: List[Dict] = []
    for i in range(steps):
        if rejoin_at is not None and i == rejoin_at:
            for s in sorted(s for s, st in agg.membership.items()
                            if st == EVICTED):
                agg.rejoin(s)
        info = agg.step_begin(i)
        key = (info["path"], info["version"] if info["path"] == "halo"
               else 0)
        if key not in step_fns:
            step_fns[key] = elastic_step(agg.aggregate_fn(info["path"]), x,
                                         deg, labels, mask, opt)
        with obs.span("dist.step", cat="dist", path=info["path"],
                      parts=info["parts"]):
            params, opt_state, loss = step_fns[key](params, opt_state, None)
            losses.append(float(loss))
        trail.append(info)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            from ..train.checkpoint import save_mirrored_checkpoint
            save_mirrored_checkpoint(ckpt_dir, i + 1, params, opt_state,
                                     num_shards=agg.full_width)
        log(f"elastic step {i}: path={info['path']} parts={info['parts']} "
            f"loss={losses[-1]:.4f}")
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "trail": trail, "aggregator": agg, "clock_s": agg.clock.now(),
            "paths": [t["path"] for t in trail]}
