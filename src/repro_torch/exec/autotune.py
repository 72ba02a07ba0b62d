"""Measure, don't guess: pick the aggregation engine by wall-clock (port of
``repro/exec/autotune.py``).

For each candidate ``(backend, bm, compact[, buckets])`` ``autotune`` builds
a :class:`GraphExecutionPlan`, times one eager **forward + backward** (the
training hot path: ``torch.autograd.grad(y, x, grad_outputs=y)``, the
reference's ``vjp(y)``) and keeps the winner.  ``autotune_layer`` does the
same over the joint layer space ``(order, fuse, backend, bm, compact
[, buckets])`` of a :class:`LayerExecutionPlan`, with 10% hysteresis toward
the FLOP/byte model's computation order.  A candidate that fails to build
or run drops out of the race, as in the reference, except a ``cuda``
candidate on the card: a hand-written kernel that fails there is a fault,
and its error propagates.  A dropped candidate is printed, and the verdict
of a race that dropped one is not cached.

On the card every trial is timed with ``torch.cuda.synchronize()`` around
``time.perf_counter()`` (the host clock over work that ends in a
synchronise: what a training step pays, launches included); on the CPU
with ``perf_counter`` alone.  The median of ``iters`` runs after one
warm-up counts.

Verdicts are cached on disk keyed by a structural graph fingerprint (the
reference's, byte for byte), the shapes, the plan mode, a device signature
(:func:`device_sig`: ``cuda-<torch.cuda.get_device_name>`` or ``cpu``) and
a hash of the raced candidate set.  Cache location:
``$REPRO_TORCH_EXEC_CACHE`` or ``~/.cache/repro_torch/exec`` — kept apart
from the reference's TPU/CPU verdicts.  Delete the directory (or its
``autotune.json``) to tune afresh.

Candidate grids: on the card (platform ``"cuda"``) the reference's TPU grid
with ``pallas`` read as ``cuda``; on the CPU its CPU grid with ``jnp`` read
as ``torch``, with the same width gate.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.blocksparse import traffic_model
from ..device import resolve_device
from ..graph.structure import Graph
from .bucketing import (bucket_candidates, bucket_layer_candidates,
                        make_layer_cand, split_graph_cand, split_layer_cand)
from .plan import (GraphExecutionPlan, LayerExecutionPlan, build_layer_plan,
                   build_plan, choose_order, layer_order_costs, spmm_cost)

# (backend, bm==bk, compact[, buckets])
Candidate = Tuple
# (order, fuse, backend, bm==bk, compact[, buckets]) — the joint layer space
LayerCandidate = Tuple

_BYTES_PER_EL = 4

# calibration-guided pruning: skip racing candidates whose calibrated
# predicted cost exceeds PRUNE_ALPHA x the best calibrated prediction
PRUNE_ALPHA = 4.0


def platform_of(device) -> str:
    """``"cuda"`` for a CUDA device, ``"cpu"`` otherwise: the platform whose
    candidate grid and cache keys a run on ``device`` uses."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def _drop_failed(platform: str, backend: str, cand, exc: Exception,
                 failed: list) -> None:
    """A trial raised ``exc``.  On the card a ``cuda`` candidate runs a
    hand-written kernel, and its failure is re-raised: it must never pass
    for a lost race, leaving the run on plain code.  Any other candidate
    drops out, as in the reference; it is printed and recorded in
    ``failed``, and the caller does not cache the race's verdict."""
    if platform == "cuda" and backend == "cuda":
        raise exc
    failed.append(tuple(cand))
    obs.counter("exec.autotune.failed").inc()
    print(f"autotune: candidate {tuple(cand)} failed and drops out of the "
          f"race: {type(exc).__name__}: {exc}", file=sys.stderr)


def _prune_candidates(cands: list, model_costs: dict,
                      cache_dir: Optional[str], platform: str) -> list:
    """Drop candidates the *calibrated* model predicts can't come close
    (over ``PRUNE_ALPHA`` x the best calibrated prediction).

    Only candidates whose calibration class carries a measured ratio
    participate; no calibration table (or fewer than two calibrated
    candidates) disables pruning."""
    if len(cands) <= 1:
        return cands
    from ..obs.audit import cand_class, class_ratios, load_calibration
    ratios = class_ratios(load_calibration(device_sig(platform), cache_dir))
    calibrated = {}
    for c in cands:
        r = ratios.get(cand_class(c))
        if r is not None:
            calibrated[c] = model_costs[c] * r
    if len(calibrated) < 2:
        return cands
    best = min(calibrated.values())
    kept = [c for c in cands
            if not (c in calibrated and calibrated[c] > PRUNE_ALPHA * best)]
    if len(kept) < len(cands):
        obs.counter("exec.autotune.pruned").inc(len(cands) - len(kept))
    return kept


# ------------------------------------------------- cold cost model (shared)
def model_graph_cost(n: int, e: int, d: int) -> float:
    """Cold-model cost (byte-equivalents) of one aggregation-only launch."""
    return spmm_cost(n, e, d)


def model_layer_cost_dims(n: int, e: int, d_in: int, d_out: int,
                          cand: LayerCandidate) -> float:
    """Cold-model cost (byte-equivalents) of one (layer, candidate):
    :func:`layer_order_costs` plus the fusion credit (the one-launch
    epilogue keeps the ``(n, d_in)`` aggregation out of device memory).
    The self half's matmul is candidate-independent and left out."""
    order, fuse = cand[0], cand[1]
    cost = layer_order_costs(n, e, d_in, d_out)[order]
    if fuse:
        cost -= 2.0 * n * d_in * _BYTES_PER_EL
    return cost


def default_candidates(platform: str = "cuda") -> List[Candidate]:
    """Graph-plan candidate grid per platform (the reference's TPU grid on
    ``cuda``, its CPU grid on ``cpu``)."""
    if platform == "cuda":
        return [("cuda", 128, True), ("cuda", 128, False),
                ("cuda", 256, True), ("coo", 128, True)]
    return [("coo", 128, True),
            ("torch", 16, True), ("torch", 32, True), ("torch", 64, True),
            ("torch", 128, True), ("torch", 128, False)]


def _device_kind(platform: str) -> str:
    """The device kind a signature names (monkeypatchable in tests)."""
    if platform != "cuda":
        return platform
    try:
        return torch.cuda.get_device_name(0)
    except Exception:
        return "unknown"


def device_sig(platform: str = "cuda") -> str:
    """Platform + device-kind cache-key component, e.g.
    ``"cuda-NVIDIA-H100-80GB-HBM3"``; the bare platform where the kind
    repeats it (``"cpu"``) or is unknown."""
    kind = re.sub(r"[^A-Za-z0-9._-]+", "-", _device_kind(platform).strip())
    if kind.lower() == platform.lower() or kind == "unknown":
        return platform
    return f"{platform}-{kind}"


def graph_fingerprint(g: Graph) -> str:
    """Structural hash: node/edge counts + exact edge list + mask (the
    reference's string for the same graph)."""
    h = hashlib.sha1()
    h.update(np.int64(g.num_nodes).tobytes())
    h.update(np.ascontiguousarray(g.src.astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(g.dst.astype(np.int64)).tobytes())
    if g.edge_mask is not None:
        h.update(np.packbits(g.edge_mask).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class AutotuneRecord:
    key: str
    backend: str
    bm: int
    compact: bool
    us: float                      # winner's fwd+bwd microseconds
    table: Tuple[Tuple, ...]       # all measurements (bucketed rows carry
    from_cache: bool               # their signature before ``us``)
    buckets: str = ""              # winner's bucket signature ("" = single)
    failed: Tuple[Tuple, ...] = ()  # candidates that dropped out (uncached)

    def as_config(self) -> dict:
        return {"backend": self.backend, "bm": self.bm, "bk": self.bm,
                "compact": self.compact, "buckets": self.buckets}


# ------------------------------------------------------------------- cache
CACHE_MAX_ENTRIES = 1024      # prune_cache keeps the most recently written


def _cache_path(cache_dir: Optional[str]) -> str:
    root = cache_dir or os.environ.get(
        "REPRO_TORCH_EXEC_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "exec"))
    return os.path.join(root, "autotune.json")


def _cache_load(path: str) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    return doc if isinstance(doc, dict) else {}


def _cache_store(path: str, entries: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(entries, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _cache_put(path: str, key: str, value: dict,
               max_entries: Optional[int] = None) -> None:
    """Insert one entry (re-reading first so concurrent tuners of other
    keys aren't clobbered), stamp its write time, and prune the document to
    its ``max_entries`` most recently written keys."""
    entries = _cache_load(path)
    entries[key] = dict(value, _ts=time.time())
    _prune(entries, max_entries if max_entries is not None
           else CACHE_MAX_ENTRIES)
    _cache_store(path, entries)


def _prune(entries: dict, max_entries: int) -> None:
    if len(entries) <= max_entries:
        return
    # unstamped entries are evicted first
    stamp = lambda k: (entries[k].get("_ts", 0.0)
                       if isinstance(entries[k], dict) else 0.0)
    for k in sorted(entries, key=stamp, reverse=True)[max_entries:]:
        del entries[k]


def prune_cache(max_entries: int = CACHE_MAX_ENTRIES,
                cache_dir: Optional[str] = None) -> int:
    """Trim the autotune disk cache to its ``max_entries`` most recently
    written keys; returns the number of entries remaining."""
    path = _cache_path(cache_dir)
    entries = _cache_load(path)
    _prune(entries, max_entries)
    try:
        _cache_store(path, entries)
    except OSError:
        pass
    return len(entries)


# ------------------------------------------------------------- quarantine
def quarantine_key(fingerprint: str, backend: str,
                   platform: str = "cuda") -> str:
    return f"{fingerprint}:quarantine:{backend}:{device_sig(platform)}"


def record_quarantine(fingerprint: str, backend: str, *, reason: str = "",
                      platform: str = "cuda",
                      cache_dir: Optional[str] = None) -> None:
    """Persist a "this backend failed on this graph" verdict next to the
    autotune entries, so every later scheduler on this device (the DP
    included) stops choosing it."""
    obs.counter("exec.quarantine", backend=backend).inc()
    obs.instant("exec.quarantine", cat="exec", backend=backend,
                reason=reason, fingerprint=fingerprint)
    try:
        _cache_put(_cache_path(cache_dir),
                   quarantine_key(fingerprint, backend, platform),
                   {"quarantined": True, "reason": reason})
    except OSError:
        pass


def quarantined_backends(fingerprint: str, *, platform: str = "cuda",
                         cache_dir: Optional[str] = None) -> set:
    """The backends (or ``backend|buckets`` classes) quarantined for this
    graph on this device."""
    prefix = f"{fingerprint}:quarantine:"
    suffix = f":{device_sig(platform)}"
    out = set()
    for key, e in _cache_load(_cache_path(cache_dir)).items():
        if (key.startswith(prefix) and key.endswith(suffix)
                and isinstance(e, dict) and e.get("quarantined")):
            out.add(key[len(prefix):len(key) - len(suffix)])
    return out


def clear_quarantine(fingerprint: str, *, platform: str = "cuda",
                     cache_dir: Optional[str] = None) -> int:
    """Lift every quarantine for this graph on this device; returns how
    many verdicts were removed."""
    path = _cache_path(cache_dir)
    entries = _cache_load(path)
    victims = [quarantine_key(fingerprint, b, platform)
               for b in quarantined_backends(fingerprint, platform=platform,
                                             cache_dir=cache_dir)]
    for k in victims:
        entries.pop(k, None)
    if victims:
        try:
            _cache_store(path, entries)
        except OSError:
            pass
    return len(victims)


def cached_layer_costs(g: Graph, d_in: int, d_out: int, mode: str = "gcn", *,
                       relu: bool = True, bias: bool = True,
                       platform: str = "cuda",
                       cache_dir: Optional[str] = None
                       ) -> Dict[LayerCandidate, float]:
    """Measured fwd+bwd microseconds per layer candidate, merged from every
    cached :func:`autotune_layer` run of this (graph, shape, mode, epilogue)
    on this device, whatever candidate set each run raced — the DP's warm
    cost oracle.  An empty dict means the layer is cold."""
    prefix = (f"{graph_fingerprint(g)}:layer:{d_in}x{d_out}:{mode}:"
              f"r{int(relu)}b{int(bias)}:{device_sig(platform)}:")
    out: Dict[LayerCandidate, float] = {}
    for key, e in _cache_load(_cache_path(cache_dir)).items():
        if not key.startswith(prefix) or not isinstance(e, dict):
            continue
        rows = e.get("table", ())
        if not isinstance(rows, (list, tuple)):
            obs.counter("exec.autotune.cache", result="corrupt").inc()
            continue
        for row in rows:
            # a corrupt row is skipped, never allowed to poison the DP
            try:
                if len(row) == 7:          # degree-bucketed layer trial
                    order, fuse, backend, bm, compact, bsig, us = row
                else:
                    order, fuse, backend, bm, compact, us = row
                    bsig = ""
                cand = make_layer_cand(str(order), bool(fuse), str(backend),
                                       int(bm), bool(compact), str(bsig))
                us = float(us)
            except (TypeError, ValueError):
                obs.counter("exec.autotune.cache", result="corrupt").inc()
                continue
            if cand not in out or us < out[cand]:
                out[cand] = us
    return out


# --------------------------------------------------------------- measuring
def time_us(step: Callable[[], object], device: torch.device,
            iters: int = 3, warmup: int = 1) -> float:
    """Median microseconds of ``step()`` on the host clock, synchronising
    the card after each call when ``device`` is a CUDA device."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        step()
        sync()
    ts = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts))


def fwd_bwd(fn: Callable, *inputs: torch.Tensor):
    """One eager forward and the backward ``vjp(y)``:
    ``torch.autograd.grad(y, inputs, grad_outputs=y)``."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    y = fn(*leaves)
    return torch.autograd.grad(y, leaves, grad_outputs=y.detach())


def _modeled_traffic(plan: GraphExecutionPlan, d: int) -> dict:
    """Modeled device bytes per launch for a trial span — only when
    tracing is on and the plan already carries a block-ELL layout."""
    if not obs.enabled() or plan._ell is None:
        return {}
    t = traffic_model(plan._ell, d)
    return {"modeled_gather_bytes": int(t["gather_bytes"]),
            "modeled_blockell_bytes": int(t["blockell_bytes"])}


def _time_fwd_bwd(plan: GraphExecutionPlan, x: torch.Tensor,
                  iters: int = 3, warmup: int = 1) -> float:
    """Median microseconds of one eager forward+backward through the
    plan."""
    return time_us(lambda: fwd_bwd(plan.apply, x), x.device, iters, warmup)


def autotune(g: Graph, d: int, mode: str = "gcn", *,
             candidates: Optional[Sequence[Candidate]] = None,
             cache_dir: Optional[str] = None, force: bool = False,
             iters: int = 3, seed: int = 0,
             device="cuda") -> AutotuneRecord:
    """Measure the candidate grid on ``g`` and return the winner (cached).

    ``candidates=None`` takes the platform defaults plus degree-bucketed
    variants when the degree distribution warrants them; candidates whose
    calibration-scaled model cost exceeds ``PRUNE_ALPHA`` x the best
    calibrated candidate are skipped."""
    dev = resolve_device(device)
    platform = platform_of(dev)
    if candidates is not None:
        cands = list(candidates)
    else:
        cands = default_candidates(platform) + bucket_candidates(g, platform)
    # the candidate set is part of the key: a cached verdict never hands
    # back a config the caller excluded
    cand_sig = hashlib.sha1(repr(sorted(cands)).encode()).hexdigest()[:8]
    key = f"{graph_fingerprint(g)}:{d}:{mode}:{device_sig(platform)}:{cand_sig}"
    path = _cache_path(cache_dir)
    entries = _cache_load(path)
    if not force and key in entries:
        e = entries[key]
        try:      # a corrupt entry is a miss (re-measure), never a crash
            rec = AutotuneRecord(
                key=key, backend=str(e["backend"]), bm=int(e["bm"]),
                compact=bool(e["compact"]), us=float(e["us"]),
                table=tuple(tuple(r) for r in e.get("table", ())),
                from_cache=True, buckets=str(e.get("buckets", "")))
        except (KeyError, TypeError, ValueError, AttributeError):
            obs.counter("exec.autotune.cache", result="corrupt").inc()
        else:
            obs.counter("exec.autotune.cache", result="hit").inc()
            return rec
    obs.counter("exec.autotune.cache", result="miss").inc()

    x = torch.as_tensor(np.random.default_rng(seed)
                        .standard_normal((g.num_nodes, d))
                        .astype(np.float32)).to(dev)
    n_nodes, n_edges = g.num_nodes, g.num_valid_edges
    model_cost = model_graph_cost(n_nodes, n_edges, d)
    race = _prune_candidates(cands, {c: model_cost for c in cands},
                             cache_dir, platform)
    table: List[Tuple] = []
    failed: List[Tuple] = []
    best = None
    for cand in race:
        backend, bm, compact, bsig = split_graph_cand(cand)
        with obs.span("exec.autotune.trial", cat="exec", backend=backend,
                      bm=bm, compact=compact, buckets=bsig, d=d, mode=mode,
                      n=n_nodes, e=n_edges, model_cost=model_cost) as sp:
            try:
                plan = build_plan(g, mode, bm=bm, bk=bm, backend=backend,
                                  compact=compact, buckets=bsig, device=dev)
                us = _time_fwd_bwd(plan, x, iters=iters)
            except Exception as exc:
                sp.set(failed=True)
                _drop_failed(platform, backend, cand, exc, failed)
                continue
            sp.set(us=us, **_modeled_traffic(plan, d))
        obs.counter("exec.autotune.trials").inc()
        table.append((backend, bm, compact, bsig, us) if bsig
                     else (backend, bm, compact, us))
        if best is None or us < best[0]:
            best = (us, (backend, bm, compact, bsig))
    if best is None:
        raise RuntimeError(f"autotune: every candidate failed (tried {race})")
    us, (backend, bm, compact, bsig) = best
    if not failed:
        try:
            _cache_put(path, key, {"backend": backend, "bm": bm,
                                   "compact": compact, "buckets": bsig,
                                   "us": us, "table": table,
                                   "n": n_nodes, "e": n_edges, "d": d,
                                   "mode": mode,
                                   "device_sig": device_sig(platform)})
        except OSError:
            pass              # read-only FS: tuning still works, uncached
    return AutotuneRecord(key=key, backend=backend, bm=bm, compact=compact,
                          us=us, table=tuple(table), from_cache=False,
                          buckets=bsig, failed=tuple(failed))


def autotune_plan(g: Graph, d: int, mode: str = "gcn", *,
                  candidates: Optional[Sequence[Candidate]] = None,
                  cache_dir: Optional[str] = None, force: bool = False,
                  iters: int = 3, device="cuda"
                  ) -> Tuple[GraphExecutionPlan, AutotuneRecord]:
    """Autotune then build the winning plan for ``g``."""
    rec = autotune(g, d, mode, candidates=candidates, cache_dir=cache_dir,
                   force=force, iters=iters, device=device)
    plan = build_plan(g, mode, bm=rec.bm, bk=rec.bm, backend=rec.backend,
                      compact=rec.compact, buckets=rec.buckets, device=device)
    return plan, rec


# ---------------------------------------------------------------------------
# joint layer autotune: (order, fuse, backend, bm, compact) in one space
# ---------------------------------------------------------------------------
def default_layer_candidates(platform: str = "cuda",
                             d_in: Optional[int] = None,
                             d_out: Optional[int] = None
                             ) -> List[LayerCandidate]:
    """Joint candidate grid per platform.  ``fuse=True`` (the one-launch
    layer kernel) exists only for ``cuda`` in aggregate-first order; the
    CPU grid races both orders over ``coo`` and ``torch``, with the dense-
    tile ``torch`` engine gated to widths <= 256 (at Cora's 1433 it costs
    seconds per call and can never win)."""
    if platform == "cuda":
        return [("aggregate_first", True, "cuda", 128, True),
                ("aggregate_first", True, "cuda", 128, False),
                ("aggregate_first", False, "cuda", 128, True),
                ("aggregate_first", True, "cuda", 256, True),
                ("update_first", False, "cuda", 128, True),
                ("update_first", False, "coo", 128, True)]
    cands = [("aggregate_first", False, "coo", 128, True),
             ("update_first", False, "coo", 128, True)]
    if d_in is None or d_in <= 256:
        cands.append(("aggregate_first", False, "torch", 64, True))
    if d_out is None or d_out <= 256:
        cands.append(("update_first", False, "torch", 64, True))
    return cands


@dataclasses.dataclass(frozen=True)
class LayerAutotuneRecord:
    key: str
    order: str
    fuse: bool
    backend: str
    bm: int
    compact: bool
    us: float                      # winner's fwd+bwd microseconds
    model_order: str               # what the FLOP/byte model predicted
    table: Tuple[Tuple, ...]       # bucketed rows carry their sig before us
    from_cache: bool
    buckets: str = ""              # winner's bucket signature ("" = single)
    failed: Tuple[Tuple, ...] = ()  # candidates that dropped out (uncached)

    @property
    def order_agrees_with_model(self) -> bool:
        return self.order == self.model_order

    def as_config(self) -> dict:
        return {"order": self.order, "fuse": self.fuse,
                "backend": self.backend, "bm": self.bm, "bk": self.bm,
                "compact": self.compact, "buckets": self.buckets}


def _time_layer_fwd_bwd(lp: LayerExecutionPlan, x: torch.Tensor,
                        w: torch.Tensor, b: Optional[torch.Tensor],
                        relu: bool, iters: int = 3, warmup: int = 1) -> float:
    """Median microseconds of one eager layer forward+backward wrt (x, w,
    b)."""
    if b is None:
        step = lambda: fwd_bwd(lambda x, w: lp.apply(x, w, relu=relu), x, w)
    else:
        step = lambda: fwd_bwd(lambda x, w, b: lp.apply(x, w, b, relu=relu),
                               x, w, b)
    return time_us(step, x.device, iters, warmup)


def autotune_layer(g: Graph, d_in: int, d_out: int, mode: str = "gcn", *,
                   relu: bool = True, bias: bool = True,
                   candidates: Optional[Sequence[LayerCandidate]] = None,
                   cache_dir: Optional[str] = None, force: bool = False,
                   iters: int = 3, seed: int = 0, device="cuda",
                   _gplan_cache: Optional[Dict] = None) -> LayerAutotuneRecord:
    """Measure the joint layer space on ``g`` and return the winner
    (cached); keys carry the layer shape, mode, epilogue flags, device and
    candidate signature.  ``candidates=None`` takes the platform defaults
    plus degree-bucketed variants on skewed graphs."""
    dev = resolve_device(device)
    platform = platform_of(dev)
    if candidates is not None:
        cands = list(candidates)
    else:
        cands = (default_layer_candidates(platform, d_in, d_out)
                 + bucket_layer_candidates(g, platform, d_in, d_out))
    cand_sig = hashlib.sha1(repr(sorted(cands)).encode()).hexdigest()[:8]
    model_order = choose_order(g.num_nodes, g.num_valid_edges, d_in, d_out)
    key = (f"{graph_fingerprint(g)}:layer:{d_in}x{d_out}:{mode}:"
           f"r{int(relu)}b{int(bias)}:{device_sig(platform)}:{cand_sig}")
    path = _cache_path(cache_dir)
    entries = _cache_load(path)
    if not force and key in entries:
        e = entries[key]
        try:      # a corrupt entry is a miss (re-measure), never a crash
            rec = LayerAutotuneRecord(
                key=key, order=str(e["order"]), fuse=bool(e["fuse"]),
                backend=str(e["backend"]), bm=int(e["bm"]),
                compact=bool(e["compact"]), us=float(e["us"]),
                model_order=str(e.get("model_order", model_order)),
                table=tuple(tuple(r) for r in e.get("table", ())),
                from_cache=True, buckets=str(e.get("buckets", "")))
        except (KeyError, TypeError, ValueError, AttributeError):
            obs.counter("exec.autotune.cache", result="corrupt").inc()
        else:
            obs.counter("exec.autotune.cache", result="hit").inc()
            return rec
    obs.counter("exec.autotune.cache", result="miss").inc()

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32)).to(dev)
    x = t(rng.standard_normal((g.num_nodes, d_in)))
    w = t(rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
    b = t(rng.standard_normal(d_out)) if bias else None
    gplans: Dict[Tuple, GraphExecutionPlan] = (
        {} if _gplan_cache is None else _gplan_cache)
    n_nodes, n_edges = g.num_nodes, g.num_valid_edges
    model_costs = {c: model_layer_cost_dims(n_nodes, n_edges, d_in, d_out, c)
                   for c in cands}
    race = _prune_candidates(cands, model_costs,
                             cache_dir, platform)
    table: List[Tuple] = []
    failed: List[Tuple] = []
    best = None
    for cand in race:
        order, fuse, backend, bm, compact, bsig = split_layer_cand(cand)
        gkey = (backend, bm, compact, bsig)
        with obs.span("exec.autotune.trial", cat="exec", backend=backend,
                      bm=bm, compact=compact, order=order, fuse=fuse,
                      buckets=bsig, d_in=d_in, d_out=d_out, mode=mode,
                      n=n_nodes, e=n_edges,
                      model_cost=model_costs[cand]) as sp:
            try:
                if gkey not in gplans:
                    gplans[gkey] = build_plan(g, mode, bm=bm, bk=bm,
                                              backend=backend,
                                              compact=compact, buckets=bsig,
                                              device=dev)
                lp = build_layer_plan(g, mode, d_in=d_in, d_out=d_out,
                                      order=order, fuse=fuse,
                                      gplan=gplans[gkey])
                us = _time_layer_fwd_bwd(lp, x, w, b, relu, iters=iters)
            except Exception as exc:
                sp.set(failed=True)
                _drop_failed(platform, backend, cand, exc, failed)
                continue
            sp.set(us=us, **_modeled_traffic(gplans[gkey], d_out))
        obs.counter("exec.autotune.trials").inc()
        table.append((order, fuse, backend, bm, compact, bsig, us) if bsig
                     else (order, fuse, backend, bm, compact, us))
        if best is None or us < best[0]:
            best = (us, (order, fuse, backend, bm, compact, bsig))
    if best is None:
        raise RuntimeError("autotune_layer: every candidate failed "
                           f"(tried {race})")
    us, (order, fuse, backend, bm, compact, bsig) = best
    if order != model_order:
        # hysteresis toward the analytic prior: the measurement overrules
        # the FLOP/byte model only when it is decisively (>10%) better
        contenders = [r for r in table if r[0] == model_order]
        if contenders:
            alt = min(contenders, key=lambda r: r[-1])
            if alt[-1] <= us * 1.10:
                us = alt[-1]
                order, fuse, backend, bm, compact, bsig = \
                    split_layer_cand(alt[:-1])
    if not failed:
        try:
            _cache_put(path, key, {"order": order, "fuse": fuse,
                                   "backend": backend, "bm": bm,
                                   "compact": compact, "buckets": bsig,
                                   "us": us, "model_order": model_order,
                                   "table": table, "n": n_nodes,
                                   "e": n_edges, "d_in": d_in,
                                   "d_out": d_out, "mode": mode,
                                   "device_sig": device_sig(platform)})
        except OSError:
            pass              # read-only FS: tuning still works, uncached
    return LayerAutotuneRecord(key=key, order=order, fuse=fuse,
                               backend=backend, bm=bm, compact=compact,
                               us=us, model_order=model_order,
                               table=tuple(table), from_cache=False,
                               buckets=bsig, failed=tuple(failed))


def autotune_layer_plan(g: Graph, d_in: int, d_out: int, mode: str = "gcn",
                        *, relu: bool = True, bias: bool = True,
                        candidates: Optional[Sequence[LayerCandidate]] = None,
                        cache_dir: Optional[str] = None, force: bool = False,
                        iters: int = 3,
                        gplan: Optional[GraphExecutionPlan] = None,
                        device="cuda"
                        ) -> Tuple[LayerExecutionPlan, LayerAutotuneRecord]:
    """Autotune the joint space, then build the winning layer plan, reusing
    ``gplan`` or a graph plan the tuning run built when one matches."""
    built: Dict[Tuple, GraphExecutionPlan] = {}
    rec = autotune_layer(g, d_in, d_out, mode, relu=relu, bias=bias,
                         candidates=candidates, cache_dir=cache_dir,
                         force=force, iters=iters, device=device,
                         _gplan_cache=built)
    win = (rec.backend, rec.bm, rec.compact, rec.buckets)
    if gplan is not None and (
            gplan.mode != mode
            or (gplan.backend, gplan.bm, gplan.compact,
                gplan.buckets) != win):
        gplan = None
    if gplan is None:
        gplan = built.get(win)
    lp = build_layer_plan(g, mode, d_in=d_in, d_out=d_out, order=rec.order,
                          fuse=rec.fuse, bm=rec.bm, bk=rec.bm,
                          backend=rec.backend, compact=rec.compact,
                          gplan=gplan, buckets=rec.buckets, device=device)
    return lp, rec
