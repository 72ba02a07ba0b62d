"""Whole-forward scheduling: a DP over the layer chain (port of
``repro/exec/forward.py``).

The ``(order, fuse, backend, bm, compact[, buckets])`` configuration of
every layer is chosen jointly, because the choices couple across layer
boundaries:

* **residuals** — a layer scheduled aggregate-first *unfused* saves its own
  ``agg = F(x)`` (an extra ``(n, d_in)`` array written in the forward and
  re-read in the backward), while the update-first / fused forms keep ``x``,
  which the previous layer's backward already saves for its ReLU mask;
* **plan sharing** — layers whose configs agree on ``(mode, backend, bm,
  compact, buckets)`` share ONE block-ELL construction (and its transpose).

The DP is a Viterbi pass over ``(layer, candidate)`` states: node costs
come from the fingerprinted autotune cache when warm (measured layer trial
rows, :func:`repro_torch.exec.autotune.cached_layer_costs`) and from the
FLOP/byte model when cold, rescaled into microseconds by whatever
measurements (or calibration ratios) exist.

:func:`autotune_forward` measures: it tunes each layer on its own (the
per-layer-greedy schedule, which also warms the DP's oracle), builds the
warm-DP and cold-DP schedules, races every distinct schedule as an eager
whole-chain forward + backward, interleaved, keeps the winner and caches
the verdict under a ``fingerprint:forward:...`` key of the same disk
document.  :func:`plan_forward` trusts the DP without measuring.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..graph.structure import Graph
from ..obs.audit import cand_class, class_ratios, load_calibration
from .autotune import (LayerCandidate, _cache_load, _cache_path, _cache_put,
                       autotune_layer, cached_layer_costs,
                       default_layer_candidates, device_sig, fwd_bwd,
                       graph_fingerprint, model_layer_cost_dims, platform_of,
                       quarantined_backends, time_us)
from .bucketing import (bucket_layer_candidates, make_layer_cand,
                        quarantine_class, split_layer_cand)
from .plan import (GraphExecutionPlan, LayerExecutionPlan, build_layer_plan,
                   build_plan)

SELF_KINDS = ("none", "two_w", "self_coeff")

# one-time block-ELL construction + storage for a mid-chain config switch,
# amortized over this many forward calls (a tie-break prior toward plan
# sharing, not a hot-path traffic term)
_SWITCH_AMORTIZE = 64
_BYTES_PER_EL = 4


# ---------------------------------------------------------------------------
# chain description
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of a forward chain, as the scheduler sees it.

    ``self_kind`` picks the epilogue family: ``"none"`` (GCN —
    ``act(F(x) W + b)``), ``"two_w"`` (SAGE — ``x W_self + F(x) W_nbr + b``),
    ``"self_coeff"`` (GIN — ``(c·x + F(x)) W + b`` with a trained ``c``).
    """
    d_in: int
    d_out: int
    mode: str = "gcn"
    relu: bool = True
    bias: bool = True
    self_kind: str = "none"

    def __post_init__(self):
        if self.self_kind not in SELF_KINDS:
            raise ValueError(f"unknown self_kind {self.self_kind!r}; "
                             f"expected one of {SELF_KINDS}")

    @property
    def sig(self) -> str:
        return (f"{self.d_in}x{self.d_out}:{self.mode}:r{int(self.relu)}"
                f"b{int(self.bias)}:{self.self_kind}")


def gcn_chain(dims: Sequence[int]) -> Tuple[LayerSpec, ...]:
    """``dims = [d_in, hidden..., classes]`` — ReLU between layers, not after
    the last (``models.gcn.gcn_apply``)."""
    L = len(dims) - 1
    return tuple(LayerSpec(dims[i], dims[i + 1], "gcn", relu=i + 1 < L)
                 for i in range(L))


def sage_chain(dims: Sequence[int]) -> Tuple[LayerSpec, ...]:
    """GraphSAGE: mean aggregation, two-W epilogue; the L2 normalize stays
    outside the plan."""
    L = len(dims) - 1
    return tuple(LayerSpec(dims[i], dims[i + 1], "mean", relu=i + 1 < L,
                           self_kind="two_w")
                 for i in range(L))


def gin_chain(d_in: int, d_hidden: int, n_conv: int) -> Tuple[LayerSpec, ...]:
    """GIN convs: sum aggregation with the trained ``1+ε`` self coefficient
    folded into the FIRST MLP layer of each conv."""
    dims = [d_in] + [d_hidden] * n_conv
    return tuple(LayerSpec(dims[i], dims[i + 1], "sum", relu=True,
                           self_kind="self_coeff")
                 for i in range(n_conv))


def chain_params(specs: Sequence[LayerSpec], seed: int = 0,
                 device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Random per-layer parameters in the shape
    :meth:`ForwardExecutionPlan.apply_chain` consumes, drawn from numpy in
    the reference's order (byte-equal arrays)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a).to(device)

    def mat(d1, d2):
        return t((rng.standard_normal((d1, d2)) / np.sqrt(d1))
                 .astype(np.float32))

    out = []
    for s in specs:
        p = {"w": mat(s.d_in, s.d_out)}
        if s.bias:
            p["b"] = t(rng.standard_normal(s.d_out).astype(np.float32))
        if s.self_kind == "two_w":
            p["w_self"] = mat(s.d_in, s.d_out)
        elif s.self_kind == "self_coeff":
            p["coeff"] = t(np.asarray(1.0 + rng.standard_normal() * 0.1,
                                      np.float32))
        out.append(p)
    return out


# ---------------------------------------------------------------------------
# cost oracle: measured table rows when warm, scaled FLOP/byte model when cold
# ---------------------------------------------------------------------------
def model_layer_cost(n: int, e: int, spec: LayerSpec,
                     cand: LayerCandidate) -> float:
    """Cold-model cost (byte-equivalents) of one (layer, candidate)."""
    return model_layer_cost_dims(n, e, spec.d_in, spec.d_out, cand)


def residual_edge_cost(n: int, d_boundary: int,
                       cand_next: LayerCandidate) -> float:
    """Extra backward residual the NEXT layer's order choice forces at this
    boundary: aggregate-first *unfused* saves its own ``agg``."""
    order, fuse = cand_next[0], cand_next[1]
    if order == "aggregate_first" and not fuse:
        return 2.0 * n * d_boundary * _BYTES_PER_EL
    return 0.0


def plan_switch_cost(e: int, cand_a: LayerCandidate,
                     cand_b: LayerCandidate) -> float:
    """Tie-break prior toward sharing one block-ELL construction across
    adjacent layers: a (backend, bm, compact[, buckets]) switch builds and
    holds a second plan."""
    if cand_a[2:] == cand_b[2:]:
        return 0.0
    return 3.0 * e * _BYTES_PER_EL / _SWITCH_AMORTIZE


@dataclasses.dataclass
class ForwardCostOracle:
    """Per-(layer, candidate) node costs and per-boundary edge costs.

    ``node_us[l][cand]`` is measured microseconds when the autotune cache
    holds the candidate, otherwise the FLOP/byte model rescaled by the
    candidate class's calibration ratio, or by the median measured/model
    ratio ``scale`` for classes without one."""

    n: int
    e: int
    specs: Tuple[LayerSpec, ...]
    cands: Tuple[Tuple[LayerCandidate, ...], ...]
    measured: Tuple[Dict[LayerCandidate, float], ...]
    scale: float
    sources: Tuple[str, ...]          # per layer: "measured" | "model"
    class_scale: Dict[str, float] = dataclasses.field(default_factory=dict)

    def node_cost(self, layer: int, cand: LayerCandidate) -> float:
        us = self.measured[layer].get(cand)
        if us is not None:
            return us
        scale = self.class_scale.get(cand_class(cand), self.scale)
        return model_layer_cost(self.n, self.e, self.specs[layer],
                                cand) * scale

    def edge_cost(self, layer: int, prev: LayerCandidate,
                  cand: LayerCandidate) -> float:
        """Cost charged on the edge (layer-1) -> layer."""
        d_boundary = self.specs[layer].d_in
        c = residual_edge_cost(self.n, d_boundary, cand)
        c += plan_switch_cost(self.e, prev, cand)
        return c * self.scale if self.scale != 1.0 else c

    def entry_cost(self, cand: LayerCandidate) -> float:
        """Layer 0's boundary: only the residual term applies."""
        c = residual_edge_cost(self.n, self.specs[0].d_in, cand)
        return c * self.scale if self.scale != 1.0 else c


def _default_cand_sets(g: Graph, specs: Sequence[LayerSpec], platform: str
                       ) -> Tuple[Tuple[LayerCandidate, ...], ...]:
    return tuple(tuple(default_layer_candidates(platform, s.d_in, s.d_out)
                       + bucket_layer_candidates(g, platform, s.d_in,
                                                 s.d_out))
                 for s in specs)


def build_cost_oracle(g: Graph, specs: Sequence[LayerSpec], *,
                      candidates: Optional[Sequence[Sequence[LayerCandidate]]]
                      = None,
                      cache_dir: Optional[str] = None,
                      platform: str = "cuda",
                      use_cache: bool = True,
                      calibration: Optional[dict] = None,
                      use_calibration: bool = True,
                      respect_quarantine: bool = True) -> ForwardCostOracle:
    """Assemble the DP's cost oracle for ``specs`` over ``g``.

    ``use_cache=False`` forces the cold model.  Cold candidates are
    rescaled with this device's calibration table when one exists (pass
    ``calibration`` to override, ``use_calibration=False`` for none).
    Quarantined backends are dropped from every layer's candidate set,
    unless that would leave a layer with nothing to run."""
    specs = tuple(specs)
    if candidates is None:
        cands = _default_cand_sets(g, specs, platform)
    else:
        cands = tuple(tuple(c) for c in candidates)
        if len(cands) == 1 and len(specs) > 1:
            cands = cands * len(specs)
    if len(cands) != len(specs):
        raise ValueError(f"{len(specs)} layers but {len(cands)} candidate "
                         "sets")
    if respect_quarantine:
        bad = quarantined_backends(graph_fingerprint(g), platform=platform,
                                   cache_dir=cache_dir)
        if bad:
            def _ok(c):
                _, _, backend, _, _, sig = split_layer_cand(c)
                return (backend not in bad
                        and quarantine_class(backend, sig) not in bad)
            cands = tuple(tuple(c for c in cs if _ok(c)) or cs
                          for cs in cands)
    measured: List[Dict[LayerCandidate, float]] = []
    for s in specs:
        measured.append(cached_layer_costs(
            g, s.d_in, s.d_out, s.mode, relu=s.relu, bias=s.bias,
            platform=platform, cache_dir=cache_dir) if use_cache else {})
    n, e = g.num_nodes, g.num_valid_edges
    # rescale model byte-equivalents into microseconds using whatever
    # measurements exist (median of us/model over measured pairs)
    ratios = []
    for s, m in zip(specs, measured):
        for cand, us in m.items():
            model = model_layer_cost(n, e, s, cand)
            if model > 0:
                ratios.append(us / model)
    if calibration is None and use_calibration:
        calibration = load_calibration(device_sig(platform), cache_dir)
    class_scale = class_ratios(calibration) if use_calibration else {}
    if ratios:
        scale = float(np.median(ratios))
    else:
        scale = 1.0
        if isinstance(calibration, dict):
            try:
                scale = float(calibration.get("global_ratio") or 1.0)
            except (TypeError, ValueError):
                pass    # malformed calibration degrades to uncalibrated
    sources = tuple("measured" if all(c in m for c in cs) else "model"
                    for m, cs in zip(measured, cands))
    return ForwardCostOracle(n=n, e=e, specs=specs, cands=cands,
                             measured=tuple(measured), scale=scale,
                             sources=sources, class_scale=class_scale)


# ---------------------------------------------------------------------------
# the DP itself (and the exhaustive reference the tests compare against)
# ---------------------------------------------------------------------------
def dp_schedule(oracle: ForwardCostOracle
                ) -> Tuple[float, List[LayerCandidate]]:
    """Viterbi over ``(layer, candidate)``: minimize
    ``Σ node(l, c_l) + Σ edge(l, c_{l-1}, c_l)`` exactly in ``O(L · C²)``."""
    L = len(oracle.specs)
    best = [oracle.entry_cost(c) + oracle.node_cost(0, c)
            for c in oracle.cands[0]]
    back: List[List[int]] = []
    for l in range(1, L):
        nxt, ptr = [], []
        for c in oracle.cands[l]:
            node = oracle.node_cost(l, c)
            costs = [best[i] + oracle.edge_cost(l, p, c)
                     for i, p in enumerate(oracle.cands[l - 1])]
            i_best = int(np.argmin(costs))
            nxt.append(costs[i_best] + node)
            ptr.append(i_best)
        best = nxt
        back.append(ptr)
    i = int(np.argmin(best))
    total = best[i]
    path = [i]
    for ptr in reversed(back):
        path.append(ptr[path[-1]])
    path.reverse()
    return float(total), [oracle.cands[l][i] for l, i in enumerate(path)]


def exhaustive_schedule(oracle: ForwardCostOracle
                        ) -> Tuple[float, List[LayerCandidate]]:
    """Brute force over every candidate combination (``C^L`` paths, for
    the tests); must agree with :func:`dp_schedule` exactly."""
    best_cost, best_path = np.inf, None
    for combo in itertools.product(*oracle.cands):
        cost = oracle.entry_cost(combo[0]) + oracle.node_cost(0, combo[0])
        for l in range(1, len(combo)):
            cost += (oracle.edge_cost(l, combo[l - 1], combo[l])
                     + oracle.node_cost(l, combo[l]))
        if cost < best_cost:
            best_cost, best_path = cost, list(combo)
    return float(best_cost), best_path


# ---------------------------------------------------------------------------
# the compiled whole-forward plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ForwardExecutionPlan:
    """The whole forward, compiled: one :class:`LayerExecutionPlan` per
    layer, with configs chosen jointly and graph plans shared across layers
    whose ``(mode, backend, bm, compact, buckets)`` agree."""

    specs: Tuple[LayerSpec, ...]
    layers: List[LayerExecutionPlan]
    configs: Tuple[LayerCandidate, ...]
    source: str                        # "dp-measured" | "dp-model" | label
    predicted_us: Optional[float] = None

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i: int) -> LayerExecutionPlan:
        return self.layers[i]

    def __iter__(self):
        return iter(self.layers)

    @property
    def num_gplans(self) -> int:
        return len({id(lp.gplan) for lp in self.layers})

    def apply_chain(self, x: torch.Tensor,
                    params: Sequence[Dict]) -> torch.Tensor:
        """Run the chain on per-layer param dicts (``w``, optional ``b``,
        ``w_self`` for two-W layers, ``coeff`` for self-coeff layers — whose
        ``w_self`` defaults to ``w``, the GIN form)."""
        h = x
        for spec, lp, p in zip(self.specs, self.layers, params):
            ws, c = p.get("w_self"), p.get("coeff")
            if spec.self_kind == "self_coeff" and ws is None:
                ws = p["w"]
            h = lp.apply(h, p["w"], p.get("b"), relu=spec.relu,
                         w_self=ws, self_coeff=c)
        return h

    def describe(self) -> dict:
        return {
            "layers": [{"spec": s.sig,
                        "order": lp.order, "fuse": lp.fuse,
                        "backend": lp.backend, "bm": lp.gplan.bm,
                        "compact": lp.gplan.compact,
                        "buckets": lp.gplan.buckets}
                       for s, lp in zip(self.specs, self.layers)],
            "num_gplans": self.num_gplans,
            "source": self.source,
            "predicted_us": self.predicted_us,
        }


def build_forward_plan(g: Graph, specs: Sequence[LayerSpec],
                       configs: Sequence[LayerCandidate], *,
                       source: str = "explicit",
                       predicted_us: Optional[float] = None,
                       device="cuda",
                       _gplan_cache: Optional[Dict] = None
                       ) -> ForwardExecutionPlan:
    """Materialize a schedule: build each layer plan, sharing one
    :class:`GraphExecutionPlan` per distinct
    ``(mode, backend, bm, compact, buckets)`` (``_gplan_cache`` extends the
    sharing across several builds, e.g. the schedules
    :func:`autotune_forward` races)."""
    specs = tuple(specs)
    configs = tuple(tuple(c) for c in configs)
    if len(configs) != len(specs):
        raise ValueError(f"{len(specs)} layers but {len(configs)} configs")
    gplans: Dict[Tuple, GraphExecutionPlan] = (
        {} if _gplan_cache is None else _gplan_cache)
    layers = []
    for s, cfg in zip(specs, configs):
        order, fuse, backend, bm, compact, bsig = split_layer_cand(cfg)
        gkey = (s.mode, backend, bm, compact, bsig)
        if gkey not in gplans:
            gplans[gkey] = build_plan(g, s.mode, bm=bm, bk=bm,
                                      backend=backend, compact=compact,
                                      buckets=bsig, device=device)
        layers.append(build_layer_plan(g, s.mode, d_in=s.d_in, d_out=s.d_out,
                                       order=order, fuse=fuse,
                                       gplan=gplans[gkey]))
    return ForwardExecutionPlan(specs=specs, layers=layers, configs=configs,
                                source=source, predicted_us=predicted_us)


def plan_forward(g: Graph, specs: Sequence[LayerSpec], *,
                 candidates: Optional[Sequence[Sequence[LayerCandidate]]]
                 = None,
                 cache_dir: Optional[str] = None,
                 use_cache: bool = True,
                 device="cuda") -> ForwardExecutionPlan:
    """DP-schedule the chain and build it, without measuring: the cost
    oracle is the cache when warm, the FLOP/byte model when cold.  This is
    what a serve session or ``--executor fused`` pays at build time."""
    dev = resolve_device(device)
    with obs.span("exec.forward.dp_schedule", cat="exec",
                  layers=len(tuple(specs))) as sp:
        oracle = build_cost_oracle(g, specs, candidates=candidates,
                                   cache_dir=cache_dir,
                                   platform=platform_of(dev),
                                   use_cache=use_cache)
        cost, configs = dp_schedule(oracle)
        source = ("dp-measured" if use_cache and all(s == "measured"
                                                    for s in oracle.sources)
                  else "dp-model" if not use_cache or not any(
                      s == "measured" for s in oracle.sources)
                  else "dp-mixed")
        sp.set(source=source, predicted_us=cost)
    return build_forward_plan(g, specs, configs, source=source,
                              predicted_us=cost, device=dev)


# ---------------------------------------------------------------------------
# measured whole-forward autotune
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ForwardAutotuneRecord:
    key: str
    configs: Tuple[LayerCandidate, ...]
    us: float                         # winner's whole-chain fwd+bwd µs
    source: str                       # winning schedule's label
    table: Tuple[Tuple[str, float], ...]   # (label, us) per raced schedule
    from_cache: bool
    # label -> per-layer configs for every raced schedule
    schedules: Tuple[Tuple[str, Tuple[LayerCandidate, ...]], ...] = ()

    def schedule_configs(self, label: str
                         ) -> Optional[Tuple[LayerCandidate, ...]]:
        for lab, cfgs in self.schedules:
            if lab == label:
                return cfgs
        return None

    @property
    def greedy_us(self) -> Optional[float]:
        for label, us in self.table:
            if label == "greedy":
                return us
        return None

    @property
    def speedup_vs_greedy(self) -> Optional[float]:
        gus = self.greedy_us
        return None if gus is None else gus / max(self.us, 1e-9)


def _chain_sig(specs: Sequence[LayerSpec]) -> str:
    return hashlib.sha1("|".join(s.sig for s in specs)
                        .encode()).hexdigest()[:10]


def _chain_step(fp: ForwardExecutionPlan, x: torch.Tensor,
                params: Sequence[Dict]):
    """One whole-chain forward + backward wrt x and every parameter."""
    names = [(i, k) for i, p in enumerate(params) for k in sorted(p)]

    def chain(x, *vals):
        ps = [{} for _ in params]
        for (i, k), v in zip(names, vals):
            ps[i][k] = v
        return fp.apply_chain(x, ps)

    leaves = [params[i][k] for i, k in names]
    return lambda: fwd_bwd(chain, x, *leaves)


def autotune_forward(g: Graph, specs: Sequence[LayerSpec], *,
                     candidates: Optional[Sequence[Sequence[LayerCandidate]]]
                     = None,
                     cache_dir: Optional[str] = None, force: bool = False,
                     iters: int = 3, seed: int = 0, device="cuda"
                     ) -> Tuple[ForwardExecutionPlan, ForwardAutotuneRecord]:
    """Schedule the whole forward by measurement (cached on disk).

    1. Per-layer greedy: :func:`autotune_layer` on every layer, which also
       warms the DP's measured cost oracle.
    2. DP schedules: warm (measured node costs + residual/sharing edge
       costs) and cold (pure FLOP/byte model).
    3. Race every distinct schedule as an eager whole-chain fwd+bwd,
       interleaved round-robin; the winner becomes the plan.  The greedy
       schedule is always in the race.

    The verdict is not cached when a layer race dropped a candidate.
    """
    dev = resolve_device(device)
    platform = platform_of(dev)
    specs = tuple(specs)
    if not specs:
        raise ValueError("empty layer chain")
    if candidates is None:
        cand_sets = _default_cand_sets(g, specs, platform)
    else:
        cand_sets = tuple(tuple(c) for c in candidates)
        if len(cand_sets) == 1 and len(specs) > 1:
            cand_sets = cand_sets * len(specs)
    # the per-layer candidate assignment is part of the key
    cand_sig = hashlib.sha1(repr([sorted(c) for c in cand_sets])
                            .encode()).hexdigest()[:8]
    key = (f"{graph_fingerprint(g)}:forward:{_chain_sig(specs)}:"
           f"{device_sig(platform)}:{cand_sig}")
    path = _cache_path(cache_dir)
    if not force:
        e = _cache_load(path).get(key)
        if e is not None:
            try:  # a corrupt entry is a miss (re-measure), never a crash
                configs = tuple(tuple(c) for c in e["configs"])
                scheds = tuple(
                    (lab, tuple(tuple(c) for c in cfgs))
                    for lab, cfgs in e.get("schedules", {}).items())
                rec = ForwardAutotuneRecord(
                    key=key, configs=configs, us=float(e["us"]),
                    source=str(e["source"]),
                    table=tuple((r[0], float(r[1]))
                                for r in e.get("table", ())),
                    from_cache=True, schedules=scheds)
                plan = build_forward_plan(g, specs, configs,
                                          source=rec.source,
                                          predicted_us=rec.us, device=dev)
            except (KeyError, TypeError, ValueError,
                    AttributeError, IndexError):
                obs.counter("exec.autotune.cache", result="corrupt").inc()
            else:
                obs.counter("exec.autotune.cache", result="hit").inc()
                obs.instant("exec.forward.verdict", cat="exec",
                            source=rec.source, us=rec.us, from_cache=True)
                return plan, rec

    # 1. per-layer greedy — warms the cache the DP reads
    greedy = []
    dropped = False         # a layer race dropped a candidate: no caching
    for s, cands in zip(specs, cand_sets):
        rec_l = autotune_layer(g, s.d_in, s.d_out, s.mode, relu=s.relu,
                               bias=s.bias, candidates=cands,
                               cache_dir=cache_dir, iters=iters, seed=seed,
                               device=dev)
        dropped = dropped or bool(rec_l.failed)
        greedy.append(make_layer_cand(rec_l.order, rec_l.fuse, rec_l.backend,
                                      rec_l.bm, rec_l.compact,
                                      rec_l.buckets))

    # 2. candidate schedules
    schedules: Dict[str, Tuple[LayerCandidate, ...]] = {
        "greedy": tuple(greedy)}
    warm = build_cost_oracle(g, specs, candidates=cand_sets,
                             cache_dir=cache_dir, platform=platform,
                             use_cache=True)
    _, dp_configs = dp_schedule(warm)
    if tuple(dp_configs) not in schedules.values():
        schedules["dp"] = tuple(dp_configs)
    cold = build_cost_oracle(g, specs, candidates=cand_sets,
                             cache_dir=cache_dir, platform=platform,
                             use_cache=False)
    _, model_configs = dp_schedule(cold)
    if tuple(model_configs) not in schedules.values():
        schedules["dp-model"] = tuple(model_configs)

    # 3. race the distinct schedules whole-chain
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((g.num_nodes, specs[0].d_in))
                        .astype(np.float32)).to(dev)
    params = chain_params(specs, seed=seed, device=dev)
    shared_gplans: Dict[Tuple, GraphExecutionPlan] = {}
    steps = {label: _chain_step(build_forward_plan(
                 g, specs, cfgs, source=label, device=dev,
                 _gplan_cache=shared_gplans), x, params)
             for label, cfgs in schedules.items()}
    for step in steps.values():                       # warm
        time_us(step, dev, iters=1)
    times: Dict[str, List[float]] = {label: [] for label in steps}
    for _ in range(max(iters, 2)):                    # interleaved
        for label, step in steps.items():
            with obs.span("exec.forward.race", cat="exec", schedule=label):
                times[label].append(time_us(step, dev, iters=1, warmup=0))
    table = tuple((label, float(np.median(ts)))
                  for label, ts in times.items())
    source, us = min(table, key=lambda r: r[1])
    configs = schedules[source]
    obs.instant("exec.forward.verdict", cat="exec", source=source, us=us,
                from_cache=False, table={lab: t for lab, t in table})
    if not dropped:
        try:
            _cache_put(path, key, {
                "configs": [list(c) for c in configs], "us": us,
                "source": source, "table": [list(r) for r in table],
                "schedules": {lab: [list(c) for c in cfgs]
                              for lab, cfgs in schedules.items()}})
        except OSError:
            pass              # read-only FS: tuning still works, uncached
    winner = build_forward_plan(g, specs, configs, source=source,
                                predicted_us=us, device=dev,
                                _gplan_cache=shared_gplans)
    rec = ForwardAutotuneRecord(key=key, configs=configs, us=us,
                                source=source, table=table, from_cache=False,
                                schedules=tuple(schedules.items()))
    return winner, rec
