"""The chaos gauntlet: ``python -m repro_torch.chaos.drill --seed 0`` (the
port of ``repro/chaos/drill.py``).

Runs seeded fault-injection drills against every degradation path in the
stack and asserts the graceful-degradation contract end to end:

* **exec** — an injected kernel launch failure and an injected NaN backend
  each demote :class:`repro_torch.exec.ResilientPlan` down the
  ``cuda → torch → coo`` chain (the reference's ``pallas → jnp → coo``),
  quarantine the failed engine in the autotune cache, and the whole-forward
  DP (:func:`repro_torch.exec.build_cost_oracle`) stops choosing it.
  Outputs stay finite and match the reference engine.  On the card
  ``cuda`` is demoted only by these injected faults: a real kernel failure
  propagates (``exec.fallback``).
* **serve** — an adversarial trace (overload burst + malformed ids) against
  a :class:`repro_torch.serve.ServeSLO`-guarded engine: malformed requests
  are rejected, overload answers degrade to stale-flagged cache responses
  or shed explicitly, the accounting closes exactly, and every *admitted*
  request's modeled latency lands within the SLO deadline.
* **dist** — a *transient* ``shard_loss`` on the halo exchange is absorbed
  by :func:`repro_torch.dist.resilient_halo_aggregate`'s seeded retry
  ladder (the step recovers on the halo path, counting
  ``dist.halo_retry``); a *persistent* fault that outlives the ladder
  degrades the step to the all-gather path, matching the reference
  aggregation.  It runs at the world size of an initialised process group
  (every rank calls the drill); where there is none, the drill starts a
  one-rank group of its own (NCCL on ``cuda``, gloo on the CPU, over a
  ``FileStore`` in its work directory) and destroys it afterwards.
* **elastic** — the full membership drill: a shard killed mid-run is
  retried, degraded, then **evicted** by
  :class:`repro_torch.dist.elastic.ElasticAggregator`; the survivors
  repartition and training continues on the halo path (not pinned to
  allgather) with final params within tolerance of the no-fault run; a
  later ``rejoin`` restores full width.  Buddy-mirrored checkpoints then
  lose one shard's entire directory and restore **bit-identically** from
  the surviving copies (``--gauntlet elastic`` runs just this drill).
* **train** — an injected ``crash`` mid-run, then resume: the restored
  run's final parameters are **bit-identical** to an uninterrupted run's
  (the at-least-once replay contract).  The newest checkpoint is then
  corrupted (:func:`repro_torch.chaos.corrupt_file`) and restore must fall
  back to the previous one, counting ``train.ckpt_fallback``.

The gauntlet runs **twice** with the same seed and asserts the two runs
produced identical fault schedules and identical counter values — the
whole drill is a pure function of the seed.  Wall-time-derived counters
(``TIMING_COUNTERS``, e.g. the straggler watchdog) are exempt from the
comparison: they are real measurements, warn-only here.

``--metrics-out``/``--trace`` dump the second run's registry and Perfetto
trace for ``python -m repro_torch.obs.validate``.  ``--device`` defaults
to the card, as every launcher of the port.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from . import inject
from .inject import Fault, FaultPlan
from .traffic import adversarial_trace

# counters whose values derive from wall-clock measurements; identical
# same-seed runs may legitimately disagree on them (warn-only)
TIMING_COUNTERS = ("train.straggler_flagged",)
# counters of the port that the reference has no twin of, left out of the
# report so that it stays the reference's: how the plans store each
# direction (entry lists or tiles)
PORT_COUNTERS = ("exec.plan.directions",)

# the seed-derived part of the gauntlet's fault schedule (exec/dist sites);
# the train crash keeps an explicit hit so it lands after the step-8
# checkpoint the resume drill restores from
SCHEDULE_SPEC = {
    "exec.pallas_launch": [("kernel_launch", 1)],
    "exec.kernel_result": [("nan_backend", 1)],
    "dist.halo": [("shard_loss", 1)],
}

# the elastic drill's shape: kill shard 1 at step KILL_STEP for exactly
# long enough that the retry ladder exhausts on EVICT_AFTER consecutive
# steps — (max_retries + 1) site hits per fully-faulted step — and the
# membership machine evicts.  Healthy steps consume one hit each.
ELASTIC_STEPS = 12
ELASTIC_KILL_STEP = 3
ELASTIC_REJOIN_STEP = 9
_LADDER_HITS = 3          # RetryPolicy.max_retries (2) + 1
_EVICT_AFTER = 2          # HealthPolicy.evict_after

def _plans(seed: int) -> Dict[str, FaultPlan]:
    gen = FaultPlan.generate(seed, SCHEDULE_SPEC)

    def site(s: str) -> FaultPlan:
        return FaultPlan(faults=gen.for_site(s), seed=seed)

    return {"exec_launch": site("exec.pallas_launch"),
            "exec_nan": site("exec.kernel_result"),
            "dist": site("dist.halo"),
            # outlives the whole retry ladder -> the step must degrade
            "dist_persistent": FaultPlan.of(
                Fault("dist.halo", "shard_loss", hit=0, count=_LADDER_HITS),
                seed=seed),
            # shard 1 dies at step KILL_STEP and stays dead until evicted:
            # healthy steps burn 1 hit, faulted steps burn the full ladder
            "elastic": FaultPlan.of(
                Fault("dist.halo", "shard_loss", hit=ELASTIC_KILL_STEP,
                      count=_EVICT_AFTER * _LADDER_HITS,
                      payload=(("shard", 1),)),
                seed=seed),
            "train": FaultPlan.of(Fault("train.step", "crash", hit=10),
                                  seed=seed)}


class DrillFailure(AssertionError):
    """A gauntlet contract was violated."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise DrillFailure(msg)


def _graph(seed: int):
    from ..graph import DatasetSpec, synthesize
    return synthesize(DatasetSpec("drill", 512, 6000, 32, 4, community=0.9,
                                  num_communities=8, seed=seed + 1))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _leaves(tree) -> list:
    from ..train.optimizer import tree_leaves
    return tree_leaves(tree)


# ------------------------------------------------------------------- exec
def _exec_gauntlet(seed: int, workdir: str, plans: Dict[str, FaultPlan],
                   log: Callable, device) -> Dict:
    from ..exec import (ResilientPlan, build_cost_oracle, build_plan,
                        dp_schedule, gcn_chain, graph_fingerprint,
                        quarantined_backends)
    g = _graph(seed)
    x = torch.as_tensor(np.random.default_rng(seed)
                        .standard_normal((g.num_nodes, 32))
                        .astype(np.float32), device=device)
    ref = _np(build_plan(g, "gcn", backend="coo", device=device).apply(x))
    fp = graph_fingerprint(g)

    # launch failure: cuda raises at hit 0 -> demote to torch + quarantine
    cache_a = os.path.join(workdir, "exec_cache_a")
    rp = ResilientPlan(g, "gcn", backend="cuda", cache_dir=cache_a,
                       device=device)
    with inject.armed(plans["exec_launch"]):
        y = _np(rp.apply(x))
    _check(rp.verdict is not None and rp.verdict.degraded,
           "exec: launch fault did not demote the backend")
    _check(rp.verdict.backend != "cuda",
           "exec: still serving from the failed backend")
    _check(np.isfinite(y).all() and np.allclose(y, ref, atol=1e-4),
           "exec: degraded output does not match the reference engine")
    _check("cuda" in quarantined_backends(fp, platform=rp.platform,
                                          cache_dir=cache_a),
           "exec: failed backend was not quarantined")
    y2 = _np(rp.apply(x))           # disarmed: healthy, no retry of cuda
    _check(not rp.verdict.degraded and np.allclose(y2, ref, atol=1e-4),
           "exec: post-fault call should be healthy on the fallback")

    # NaN backend: cuda result mangled -> finiteness probe demotes it
    cache_b = os.path.join(workdir, "exec_cache_b")
    rp2 = ResilientPlan(g, "gcn", backend="cuda", cache_dir=cache_b,
                        device=device)
    with inject.armed(plans["exec_nan"]):
        y3 = _np(rp2.apply(x))
    _check(np.isfinite(y3).all() and np.allclose(y3, ref, atol=1e-4),
           "exec: NaN fault leaked a non-finite/wrong output")
    _check(any(r == "nonfinite_output" for _, r in rp2.verdict.attempts),
           "exec: finiteness probe did not catch the NaN backend")

    # the DP must stop choosing the quarantined engine on this graph (an
    # explicit grid that includes cuda, so the check bites on the CPU too)
    grid = [("aggregate_first", False, "coo", 128, True),
            ("aggregate_first", False, "torch", 64, True),
            ("aggregate_first", True, "cuda", 128, True)]
    oracle = build_cost_oracle(g, gcn_chain([32, 32, 4]), candidates=[grid],
                               cache_dir=cache_b, use_cache=False,
                               platform=rp2.platform)
    _check(all(c[2] != "cuda" for cs in oracle.cands for c in cs),
           "exec: quarantined backend still in the DP candidate sets")
    _, sched = dp_schedule(oracle)
    _check(all(c[2] != "cuda" for c in sched),
           "exec: DP still schedules the quarantined backend")
    loose = build_cost_oracle(g, gcn_chain([32, 32, 4]), candidates=[grid],
                              cache_dir=cache_b, use_cache=False,
                              platform=rp2.platform,
                              respect_quarantine=False)
    _check(any(c[2] == "cuda" for cs in loose.cands for c in cs),
           "exec: respect_quarantine=False should keep the full grid")
    log(f"  exec: demoted cuda->{rp.verdict.backend}, quarantined, "
        f"DP schedule avoids it ({len(sched)} layers)")
    return {"fallback_backend": rp.verdict.backend,
            "dp_backends": sorted({c[2] for c in sched})}


# ------------------------------------------------------------------ serve
def _serve_gauntlet(seed: int, log: Callable, device) -> Dict:
    from ..serve import (EmbeddingCache, MicroBatcher, ServeEngine, ServeSLO,
                         make_session)
    g = _graph(seed)
    sess = make_session("gcn", g=g, hidden=32, out_dim=8, seed=seed,
                        device=device)
    cache = EmbeddingCache(sess.layer_dims, capacity_bytes=1 << 22,
                           num_nodes=g.num_nodes)
    slo = ServeSLO(deadline_s=8e-3, max_queue=64)
    engine = ServeEngine(sess, cache,
                         MicroBatcher(max_batch=32, max_wait=2e-3,
                                      max_queue=slo.max_queue),
                         oracle_check=True, keep_records=True, slo=slo)
    engine.warm(np.arange(g.num_nodes))
    trace = adversarial_trace(g.num_nodes, 2000, rate=8000.0, overload=10.0,
                              malformed_fraction=0.02, seed=seed)
    rep = engine.serve(trace)

    outcomes = [r.outcome for r in engine.records]
    _check(all(o in ("exact", "degraded", "shed", "rejected")
               for o in outcomes), "serve: unflagged response outcome")
    n_exact = sum(o == "exact" for o in outcomes)
    _check(n_exact + rep.num_degraded + rep.num_shed + rep.num_rejected
           == len(trace),
           f"serve: accounting leak — {n_exact}+{rep.num_degraded}"
           f"+{rep.num_shed}+{rep.num_rejected} != {len(trace)}")
    _check(rep.num_rejected > 0, "serve: malformed traffic was not rejected")
    _check(rep.num_degraded + rep.num_shed > 0,
           "serve: overload produced no degradation (drill too gentle)")
    _check(all(r.stale for r in engine.records if r.outcome == "degraded"),
           "serve: degraded response missing the stale flag")
    admitted = np.asarray([r.latency for r in engine.records
                           if r.outcome == "exact"])
    p99 = float(np.percentile(admitted, 99)) if admitted.size else 0.0
    _check(p99 <= slo.deadline_s + 1e-9,
           f"serve: admitted p99 {p99 * 1e3:.2f}ms blows the "
           f"{slo.deadline_s * 1e3:.0f}ms SLO")
    _check(rep.max_oracle_err < 1e-3,
           f"serve: oracle error {rep.max_oracle_err:.2e} on exact answers")
    log(f"  serve: {n_exact} exact / {rep.num_degraded} degraded(stale) / "
        f"{rep.num_shed} shed / {rep.num_rejected} rejected; admitted p99 "
        f"{p99 * 1e3:.2f}ms <= {slo.deadline_s * 1e3:.0f}ms SLO")
    return {"exact": n_exact, "degraded": rep.num_degraded,
            "shed": rep.num_shed, "rejected": rep.num_rejected,
            "admitted_p99_ms": p99 * 1e3}


# ------------------------------------------------------------------- dist
def _counter(name: str) -> int:
    return obs.snapshot()["counters"].get(name, 0)


@contextlib.contextmanager
def process_group(workdir: str, device):
    """The initialised process group, or a one-rank group of the drill's
    own (NCCL on ``cuda``, gloo on the CPU) destroyed on exit."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield dist.get_world_size()
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(workdir, "pg_store"), 1),
        rank=0, world_size=1)
    try:
        yield 1
    finally:
        dist.destroy_process_group()


def _dist_gauntlet(seed: int, workdir: str, plans: Dict[str, FaultPlan],
                   log: Callable, device) -> Dict:
    import torch.distributed as dist
    from ..dist import (allgather_aggregate, build_send_plan,
                        resilient_halo_aggregate)
    from ..dist.elastic import ModeledClock
    from ..dist.gnn import pad_graph_nodes
    from ..graph import build_halo_plan
    from ..launch.mesh import make_halo_debug_mesh
    with process_group(workdir, device) as parts:
        g = pad_graph_nodes(_graph(seed), parts)
        local_n = g.num_nodes // parts
        plan = build_halo_plan(g, parts)
        send = build_send_plan(plan)
        mesh = make_halo_debug_mesh(parts, device=device)
        r = dist.get_rank()
        x = torch.as_tensor(np.random.default_rng(seed + 3)
                            .standard_normal((g.num_nodes, 16))
                            .astype(np.float32)[r * local_n:
                                                (r + 1) * local_n],
                            device=device)
        retries0 = _counter("dist.halo_retry{kind=shard_loss}")
        fb0 = _counter("dist.halo_fallback{reason=shard_loss}")
        clock = ModeledClock()
        ref = _np(allgather_aggregate(mesh, x, plan, local_n))
        # transient: one faulted attempt, then the retry recovers on halo
        with inject.armed(plans["dist"]) as inj:
            y_tr = _np(resilient_halo_aggregate(mesh, x, plan, send, local_n,
                                                clock=clock))
        _check(len(inj.fired) == 1 and inj.fired[0].kind == "shard_loss",
               "dist: transient shard-loss fault did not fire")
        _check(_counter("dist.halo_retry{kind=shard_loss}") > retries0,
               "dist: transient fault did not count dist.halo_retry")
        _check(_counter("dist.halo_fallback{reason=shard_loss}") == fb0,
               "dist: transient fault degraded instead of recovering on "
               "halo")
        # persistent: the fault outlives the ladder -> allgather fallback
        with inject.armed(plans["dist_persistent"]) as inj_p:
            y_fb = _np(resilient_halo_aggregate(mesh, x, plan, send, local_n,
                                                clock=clock))
        y_ok = _np(resilient_halo_aggregate(mesh, x, plan, send, local_n,
                                            clock=clock))
    _check(np.allclose(y_tr, ref, atol=1e-4),
           "dist: retried halo step diverges from the reference")
    _check(len(inj_p.fired) == _LADDER_HITS,
           "dist: persistent fault did not exhaust the retry ladder")
    _check(_counter("dist.halo_fallback{reason=shard_loss}") == fb0 + 1,
           "dist: persistent fault did not degrade exactly one step")
    _check(np.allclose(y_fb, ref, atol=1e-4),
           "dist: fallback aggregation diverges from the all-gather path")
    _check(np.allclose(y_ok, ref, atol=1e-4),
           "dist: healthy halo step diverges after the fallback")
    _check(clock.now() > 0.0,
           "dist: retry backoff was never charged to the modeled clock")
    log(f"  dist: transient loss retried -> halo recovery; persistent loss "
        f"-> allgather fallback on {parts}-part mesh "
        f"(modeled backoff {clock.now() * 1e3:.2f}ms)")
    return {"parts": parts}


# ---------------------------------------------------------------- elastic
def _elastic_gauntlet(seed: int, workdir: str, plans: Dict[str, FaultPlan],
                      log: Callable, device) -> Dict:
    from ..dist.elastic import train_elastic
    from ..train.checkpoint import restore_mirrored_checkpoint
    from ..train.optimizer import tree_map
    g = _graph(seed)
    kill, rejoin, steps = ELASTIC_KILL_STEP, ELASTIC_REJOIN_STEP, ELASTIC_STEPS

    # the no-fault oracle: same seed, same graph, full width throughout
    ref = train_elastic(g, parts=2, steps=steps, seed=seed, device=device)
    _check(all(p == "halo" for p in ref["paths"]),
           "elastic: no-fault run left the halo path")

    evict0 = _counter("dist.elastic.evict")
    rejoin0 = _counter("dist.elastic.rejoin")
    retry0 = _counter("dist.elastic.retry{kind=shard_loss}")
    fb0 = _counter("dist.halo_fallback{reason=shard_loss}")
    ckpt_dir = os.path.join(workdir, "elastic_ckpt")
    with inject.armed(plans["elastic"]) as inj:
        res = train_elastic(g, parts=2, steps=steps, seed=seed,
                            rejoin_at=rejoin, ckpt_dir=ckpt_dir,
                            ckpt_every=4, device=device)
    trail = res["trail"]

    # the step-path contract: retry -> degrade -> evict -> halo -> rejoin
    evict_step = kill + _EVICT_AFTER - 1
    want = (["halo"] * kill + ["allgather"] * _EVICT_AFTER
            + ["halo"] * (steps - kill - _EVICT_AFTER))
    _check(res["paths"] == want,
           f"elastic: step paths {res['paths']} != expected {want}")
    _check(all(t["retries"] == _LADDER_HITS - 1 for t in
               trail[kill:kill + _EVICT_AFTER]),
           "elastic: degraded steps did not walk the full retry ladder")
    _check(trail[evict_step]["evicted"] == 1,
           f"elastic: shard 1 was not evicted at step {evict_step}")
    _check(all(t["parts"] == 1 for t in trail[evict_step:rejoin]),
           "elastic: survivors did not repartition to width 1")
    _check(all(t["parts"] == 2 for t in trail[rejoin:]),
           "elastic: rejoin did not restore full width")
    # post-recovery steps run at halo speed on the survivors, not pinned
    # to the allgather fallback — the whole point of the repartition
    _check(all(t["path"] == "halo" for t in trail[evict_step + 1:]),
           "elastic: post-eviction steps stuck on the allgather path")
    _check(len(inj.fired) == _EVICT_AFTER * _LADDER_HITS,
           "elastic: fault schedule was not exactly exhausted at eviction")
    _check(_counter("dist.elastic.evict") == evict0 + 1,
           "elastic: eviction did not count dist.elastic.evict")
    _check(_counter("dist.elastic.rejoin") == rejoin0 + 1,
           "elastic: rejoin did not count dist.elastic.rejoin")
    _check(_counter("dist.elastic.retry{kind=shard_loss}")
           == retry0 + _EVICT_AFTER * (_LADDER_HITS - 1),
           "elastic: retry counter disagrees with the ladder walk")
    _check(_counter("dist.halo_fallback{reason=shard_loss}")
           == fb0 + _EVICT_AFTER,
           "elastic: degraded-step count disagrees with the schedule")
    _check(res["clock_s"] > 0.0,
           "elastic: backoff was never charged to the modeled clock")

    # every membership's exchange is the same exact weighted segment-sum,
    # so the faulted run tracks the oracle up to FP reduction order
    for a, b in zip(_leaves(ref["params"]), _leaves(res["params"])):
        _check(np.allclose(_np(a), _np(b), rtol=1e-3, atol=5e-3),
               "elastic: recovered run's final params diverge from the "
               "no-fault oracle")

    # buddy-mirrored restore: lose shard 0's ENTIRE directory (its primary
    # slice + the mirror it kept for shard 1) -> bit-identical restore from
    # the surviving copies
    p_t = tree_map(torch.zeros_like, res["params"])
    o_t = tree_map(torch.zeros_like, res["opt_state"])
    mf0 = _counter("train.ckpt_mirror_fallback")
    for dirpath, _, files in os.walk(os.path.join(ckpt_dir, "shard_00")):
        for f in files:
            if f.endswith(".npz"):
                inject.corrupt_file(os.path.join(dirpath, f), seed=seed,
                                    mode="truncate")
    rp, ro, got = restore_mirrored_checkpoint(ckpt_dir, p_t, o_t,
                                              num_shards=2)
    _check(got == steps, f"elastic: mirrored restore served step {got}, "
                         f"wanted {steps}")
    _check(_counter("train.ckpt_mirror_fallback") > mf0,
           "elastic: quorum restore did not use the buddy mirror")
    bit_identical = all(
        np.array_equal(_np(a), _np(b))
        for a, b in zip(_leaves(res["params"]), _leaves(rp)))
    _check(bit_identical,
           "elastic: mirrored restore after losing shard 0's files is not "
           "bit-identical")
    log(f"  elastic: kill shard 1 @ step {kill} -> {_LADDER_HITS - 1} "
        f"retries/step, evicted @ step {evict_step}, repartitioned to 1 "
        f"part on halo, rejoined @ step {rejoin}; params within tolerance "
        f"of no-fault run; mirrored ckpt survived losing shard 0's dir")
    return {"evicted_at": evict_step, "rejoined_at": rejoin,
            "paths": res["paths"], "restore_step": got}


# ------------------------------------------------------------------ train
def _noop(*a, **kw):
    pass


def _train_gauntlet(seed: int, workdir: str, plans: Dict[str, FaultPlan],
                    log: Callable, device) -> Dict:
    from ..train.checkpoint import (available_steps, latest_step,
                                    restore_checkpoint)
    from ..train.loop import fit
    from ..train.optimizer import adam
    rng = np.random.default_rng(seed + 7)
    w_true = rng.standard_normal((4, 1)).astype(np.float32)

    def params0():
        return {"w": torch.zeros((4, 1), dtype=torch.float32, device=device)}

    def batches(start):
        i = start
        while True:
            r = np.random.default_rng(10_000 + i)
            xb = r.standard_normal((16, 4)).astype(np.float32)
            yield {"x": torch.as_tensor(xb, device=device),
                   "y": torch.as_tensor(xb @ w_true, device=device)}
            i += 1

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    steps, every = 12, 4
    ref_dir = os.path.join(workdir, "ckpt_ref")
    ref = fit(loss_fn, adam(1e-2), params0(), batches(0), steps,
              ckpt_dir=ref_dir, ckpt_every=every, log_every=0, log=_noop)

    # crash at step 10, then resume from the step-8 checkpoint
    crash_dir = os.path.join(workdir, "ckpt_crash")
    crashed = False
    try:
        with inject.armed(plans["train"]):
            fit(loss_fn, adam(1e-2), params0(), batches(0), steps,
                ckpt_dir=crash_dir, ckpt_every=every, log_every=0, log=_noop)
    except inject.InjectedFault:
        crashed = True
    _check(crashed, "train: injected crash did not fire")
    for _ in range(250):                # async writer may still be flushing
        if latest_step(crash_dir) == 8:
            break
        time.sleep(0.02)
    _check(latest_step(crash_dir) == 8,
           f"train: expected checkpoint 8 after crash, "
           f"found {latest_step(crash_dir)}")
    res = fit(loss_fn, adam(1e-2), params0(), batches(9), steps,
              ckpt_dir=crash_dir, ckpt_every=every, log_every=0, log=_noop)
    identical = all(np.array_equal(_np(a), _np(b))
                    for a, b in zip(_leaves(ref.params),
                                    _leaves(res.params)))
    _check(identical,
           "train: crash+resume params are not bit-identical to the "
           "uninterrupted run")

    # corrupt the newest checkpoint: restore must fall back to the previous
    newest = latest_step(crash_dir)
    fell_back_before = obs.snapshot()["counters"].get(
        "train.ckpt_fallback", 0)
    inject.corrupt_file(
        os.path.join(crash_dir, f"step_{newest:08d}.npz"),
        seed=seed, mode="truncate")
    opt = adam(1e-2)
    p_t = params0()
    _, _, got_step = restore_checkpoint(crash_dir, p_t, opt.init(p_t))
    _check(got_step < newest,
           f"train: restore served the corrupt checkpoint {newest}")
    _check(obs.snapshot()["counters"].get("train.ckpt_fallback", 0)
           > fell_back_before,
           "train: ckpt fallback did not count train.ckpt_fallback")

    # torn write: a crash mid-publish leaves only the dot-prefixed temp
    # file; corrupt it and assert the checkpoint listing never sees it
    steps_before = available_steps(crash_dir)
    torn = os.path.join(crash_dir, ".step_00000099.npz.tmp")
    with open(torn, "wb") as f:
        f.write(b"\x00" * 512)
    inject.corrupt_file(torn, seed=seed, mode="truncate")
    _check(available_steps(crash_dir) == steps_before,
           "train: a torn temp file leaked into the checkpoint listing")
    log(f"  train: crash@10 -> resume from ckpt 8, bit-identical replay; "
        f"corrupt ckpt {newest} -> fell back to ckpt {got_step}; torn temp "
        f"file invisible to restore")
    return {"crash_hit": 10, "resumed_from": 8, "corrupt_fallback": got_step}


# ----------------------------------------------------------------- driver
GAUNTLETS = ("exec", "serve", "dist", "elastic", "train")


def run_gauntlets(seed: int, workdir: str, log: Callable = print,
                  which: tuple = GAUNTLETS, device="cuda") -> Dict:
    """One full pass over ``which`` on ``device``; returns {schedules,
    summary, counters}."""
    dev = resolve_device(device)
    plans = _plans(seed)
    runners = {"exec": lambda: _exec_gauntlet(seed, workdir, plans, log,
                                              dev),
               "serve": lambda: _serve_gauntlet(seed, log, dev),
               "dist": lambda: _dist_gauntlet(seed, workdir, plans, log,
                                              dev),
               "elastic": lambda: _elastic_gauntlet(seed, workdir, plans,
                                                    log, dev),
               "train": lambda: _train_gauntlet(seed, workdir, plans, log,
                                                dev)}
    summary = {name: runners[name]() for name in which}
    counters = {k: v for k, v in obs.snapshot()["counters"].items()
                if not k.startswith(TIMING_COUNTERS + PORT_COUNTERS)}
    return {"schedules": {k: p.describe() for k, p in plans.items()},
            "summary": summary, "counters": counters}


def run_drill(seed: int = 0, metrics_out: Optional[str] = None,
              trace: Optional[str] = None, log: Callable = print,
              which: tuple = GAUNTLETS, device="cuda") -> Dict:
    """Run the gauntlet twice with the same seed; assert determinism."""
    dev = resolve_device(device)
    runs: List[Dict] = []
    for attempt in (1, 2):
        log(f"chaos drill: run {attempt}/2 (seed {seed}, "
            f"gauntlets {'+'.join(which)}, device {dev})")
        obs.reset()
        obs.enable()
        if attempt == 2 and trace:
            obs.start_trace()
        with tempfile.TemporaryDirectory(prefix="chaos_drill_") as workdir:
            runs.append(run_gauntlets(seed, workdir, log, which=which,
                                      device=dev))
    if metrics_out:
        obs.dump_metrics_jsonl(metrics_out, device=dev)
        log(f"chaos drill: metrics -> {metrics_out}")
    if trace:
        obs.stop_trace(trace)
        log(f"chaos drill: trace -> {trace}")

    a, b = runs
    _check(a["schedules"] == b["schedules"],
           "determinism: the two same-seed runs derived different "
           "fault schedules")
    _check(a["summary"] == b["summary"],
           "determinism: the two same-seed runs disagree on outcomes")
    if a["counters"] != b["counters"]:
        diff = {k for k in set(a["counters"]) | set(b["counters"])
                if a["counters"].get(k) != b["counters"].get(k)}
        raise DrillFailure(f"determinism: counter values diverge on {diff}")
    log("chaos drill: PASS — two same-seed runs, identical fault schedules "
        "and counter values")
    return a


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos.drill",
        description="seeded chaos gauntlet across exec/serve/dist/train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gauntlet", default="full",
                    choices=("full",) + GAUNTLETS,
                    help="run the full drill or a single gauntlet "
                         "(e.g. 'elastic' for the shard-death drill)")
    ap.add_argument("--metrics-out", default=None,
                    help="dump the registry as metrics JSONL "
                         "(repro_torch.obs.validate-able)")
    ap.add_argument("--trace", default=None,
                    help="write a Perfetto trace of the second run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    which = GAUNTLETS if args.gauntlet == "full" else (args.gauntlet,)
    try:
        run_drill(args.seed, metrics_out=args.metrics_out, trace=args.trace,
                  which=which, device=args.device)
    except DrillFailure as e:
        print(f"chaos drill: FAIL — {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
