"""The port's elastic shard state machine (``repro_torch/dist/elastic.py``)
against the reference's (``repro/dist/elastic.py``): every case of
``tests/test_dist_elastic.py`` run on the port (``backend="torch"``,
``device="cpu"``), and beside it the reference on the same graph and the
same ``FaultPlan``.

Held: retry schedules, trails (path, reason, retries, evictions, parts,
topology version), modeled clocks and the ``dist.*`` counters equal to the
reference's; aggregates within 1e-5 of the reference's (of the largest
|entry|: fp32 sums in another order); ``train_elastic``'s 8 losses within
1e-4 of the reference's on the reference's weights (the port's
``dist.gnn.dist_gnn_init`` patched to return the reference's draw, carried
by ``convert.params_from_jax``).  The buddy-mirrored checkpoint cases run
on the port's ``train.checkpoint``.
"""
import os

import numpy as np
import pytest
import torch

import jax
from repro import obs as ref_obs
from repro.chaos import Fault as RefFault
from repro.chaos import FaultPlan as RefFaultPlan
from repro.chaos import armed as ref_armed
from repro.dist import elastic as ref_elastic
from repro.dist.gnn import dist_gnn_init as ref_dist_gnn_init
from repro.graph import DatasetSpec as RefSpec
from repro.graph import synthesize as ref_synthesize
from repro_torch import obs
from repro_torch.chaos import Fault, FaultPlan, armed, corrupt_file
from repro_torch.convert import params_from_jax
from repro_torch.dist import gnn as port_gnn
from repro_torch.dist.elastic import (ACTIVE, EVICTED, SUSPECT,
                                      ElasticAggregator, HealthPolicy,
                                      ModeledClock, RetryPolicy, ShardHealth,
                                      train_elastic)
from repro_torch.train.optimizer import tree_leaves

from _torch_parity import to_port

TOL = 1e-5
CPU = dict(backend="torch", device="cpu")


@pytest.fixture(autouse=True)
def _obs_clean(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path / "port"))
    for o in (obs, ref_obs):
        o.reset()
        o.enable()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


@pytest.fixture(scope="module")
def ref_g():
    return ref_synthesize(RefSpec("elastic", 192, 1500, 12, 4, community=0.9,
                                  num_communities=6, seed=11))


@pytest.fixture(scope="module")
def g(ref_g):
    return to_port(ref_g)


def _counter(name: str) -> float:
    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k == name or k.startswith(name + "{"))


def _dist_counters(o) -> dict:
    return {k: v for k, v in o.snapshot()["counters"].items()
            if k.startswith("dist.")}


def _oracle(g, x):
    """Single-device weighted segment-sum, computed independently in numpy."""
    valid = (g.edge_mask if g.edge_mask is not None
             else np.ones(g.num_edges, bool))
    w = (g.edge_weight[valid] if g.edge_weight is not None
         else np.ones(int(valid.sum()), np.float32))
    ref = np.zeros((g.num_nodes, x.shape[1]), np.float32)
    np.add.at(ref, g.dst[valid], np.asarray(x)[g.src[valid]] * w[:, None])
    return ref


def _x(g, seed=0, d=8):
    return (np.random.default_rng(seed)
            .standard_normal((g.num_nodes, d)).astype(np.float32))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale


def _tiny():
    return ref_synthesize(RefSpec("tiny", 64, 400, 8, 3, community=0.9,
                                  num_communities=4, seed=2))


# ---------------------------------------------------------------- ladder
def test_retry_ladder_deterministic_and_bounded():
    kw = dict(max_retries=4, base_s=1e-3, factor=2.0, max_backoff_s=3e-3,
              jitter=0.25, seed=5)
    pol = RetryPolicy(**kw)
    a = pol.schedule(step=7)
    assert a == RetryPolicy(**kw).schedule(step=7)
    assert a == ref_elastic.RetryPolicy(**kw).schedule(step=7)
    assert len(a) == 4
    assert pol.schedule(step=8) != a
    assert RetryPolicy(seed=6, max_retries=4, base_s=1e-3, factor=2.0,
                       max_backoff_s=3e-3).schedule(step=7) != a
    for attempt, delay in enumerate(a):
        base = min(1e-3 * 2.0 ** attempt, 3e-3)
        assert base <= delay <= base * 1.25


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 11), (123, 4)])
def test_retry_schedules_equal_the_reference(seed, step):
    assert (RetryPolicy(seed=seed, max_retries=5).schedule(step)
            == ref_elastic.RetryPolicy(seed=seed,
                                       max_retries=5).schedule(step))


def test_modeled_clock_charges_backoff():
    clock, ref_clock = ModeledClock(), ref_elastic.ModeledClock()
    pol = RetryPolicy()
    with armed(FaultPlan.of(Fault("dist.halo", "shard_loss"))):
        agg = ElasticAggregator(to_port(_tiny()), 2, policy=pol, clock=clock,
                                **CPU)
        info = agg.step_begin(0)
    with ref_armed(RefFaultPlan.of(RefFault("dist.halo", "shard_loss"))):
        ref_info = ref_elastic.ElasticAggregator(
            _tiny(), 2, policy=ref_elastic.RetryPolicy(),
            clock=ref_clock).step_begin(0)
    assert info["path"] == "halo" and info["retries"] == 1
    assert clock.now() == pytest.approx(pol.backoff(0, 0))
    assert info == ref_info and clock.now() == ref_clock.now()


def test_shard_health_classification_and_decay():
    h = ShardHealth(HealthPolicy(evict_after=2, decay=0.5))
    r = ref_elastic.ShardHealth(ref_elastic.HealthPolicy(evict_after=2,
                                                         decay=0.5))
    trail = []
    for op in ("classify", "record_failure", "classify", "record_failure",
               "classify", "record_success", "classify"):
        trail.append((getattr(h, op)(0), getattr(r, op)(0)))
    assert [a for a, _ in trail] == [b for _, b in trail]
    assert [a for a, _ in trail if a] == ["healthy", "transient",
                                          "persistent", "healthy"]
    assert h.score == r.score and 0.0 < h.score[0] < 2.0
    h.reset(0)
    assert h.classify(0) == "healthy" and 0 not in h.score


# ------------------------------------------------------------- aggregator
def test_full_width_halo_matches_oracle(g, ref_g):
    agg = ElasticAggregator(g, 2, **CPU)
    x = _x(g)
    ref = _oracle(g, x)
    y = agg.aggregate(torch.as_tensor(x), step=0).numpy()
    ref_agg = ref_elastic.ElasticAggregator(ref_g, 2)
    y_ref = np.asarray(ref_agg.aggregate(jax.numpy.asarray(x), step=0))
    _close(y, y_ref)
    assert np.allclose(y, ref, atol=1e-4)
    _close(agg.aggregate_fn("allgather")(torch.as_tensor(x)).numpy(),
           np.asarray(ref_agg.aggregate_fn("allgather")(
               jax.numpy.asarray(x))))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_halo_gradient_matches_reference(g, ref_g, parts):
    """The backward of every shard's plan (its transpose plan) against
    ``jax.grad`` through the reference's per-shard plans."""
    x = _x(g, seed=parts, d=5)
    r = _x(g, seed=10 + parts, d=5)
    agg = ElasticAggregator(g, parts, **CPU)
    xt = torch.as_tensor(x).requires_grad_(True)
    (agg.aggregate_fn("halo")(xt) * torch.as_tensor(r)).sum().backward()
    fn = ref_elastic.ElasticAggregator(ref_g, parts).aggregate_fn("halo")
    gx = jax.grad(lambda a: (fn(a) * r).sum())(jax.numpy.asarray(x))
    _close(xt.grad.numpy(), np.asarray(gx))


def test_repartition_parity_2_1_2_vs_oracle(g):
    agg = ElasticAggregator(g, 2, **CPU)
    x = _x(g, seed=1)
    ref = _oracle(g, x)
    xt = torch.as_tensor(x)
    v_full = agg.topology.version

    agg.repartition_survivors(1)
    assert agg.membership == {0: ACTIVE, 1: EVICTED}
    assert agg.active == (0,) and agg.topology.num_parts == 1
    assert np.allclose(agg.aggregate_fn("halo")(xt).numpy(), ref, atol=1e-4)
    assert _counter("dist.elastic.evict") == 1
    assert _counter("dist.elastic.rows_migrated") > 0
    snap = obs.snapshot()["gauges"]
    assert snap["dist.membership{state=active}"] == 1
    assert snap["dist.membership{state=evicted}"] == 1

    agg.rejoin(1)
    assert agg.membership == {0: ACTIVE, 1: ACTIVE}
    assert agg.active == (0, 1)
    assert agg.topology.version == v_full
    assert np.allclose(agg.aggregate_fn("halo")(xt).numpy(), ref, atol=1e-4)
    assert _counter("dist.elastic.rejoin") == 1
    assert obs.snapshot()["gauges"]["dist.membership{state=evicted}"] == 0


def test_repartition_counters_and_gauges_equal_the_reference(g, ref_g):
    agg = ElasticAggregator(g, 3, **CPU)
    ref = ref_elastic.ElasticAggregator(ref_g, 3)
    for a in (agg, ref):
        a.repartition_survivors(2)
        a.repartition_survivors(0)
        a.rejoin(2)
    assert agg.membership == ref.membership
    assert _dist_counters(obs) == _dist_counters(ref_obs)
    gauges = {k: v for k, v in obs.snapshot()["gauges"].items()
              if k.startswith("dist.")}
    assert gauges == {k: v for k, v in ref_obs.snapshot()["gauges"].items()
                      if k.startswith("dist.")}


def test_evict_last_shard_refused(g):
    agg = ElasticAggregator(g, 1, **CPU)
    with pytest.raises(RuntimeError):
        agg.repartition_survivors(0)


def test_rejoin_requires_evicted(g):
    agg = ElasticAggregator(g, 2, **CPU)
    with pytest.raises(ValueError):
        agg.rejoin(1)


def _ladder_run(make_agg, fault_plan, armed_fn, steps):
    agg = make_agg()
    with armed_fn(fault_plan) as inj:
        infos = [agg.step_begin(i) for i in range(steps)]
    return agg, infos, len(inj.fired)


def test_persistent_fault_walks_ladder_then_evicts(g, ref_g):
    pol = RetryPolicy()
    hp = HealthPolicy(evict_after=2)
    ladder = pol.max_retries + 1
    fault = dict(count=hp.evict_after * ladder, payload=(("shard", 1),))
    agg, (i1, i2, i3), fired = _ladder_run(
        lambda: ElasticAggregator(g, 2, policy=pol, health=ShardHealth(hp),
                                  **CPU),
        FaultPlan.of(Fault("dist.halo", "shard_loss", **fault)), armed, 3)
    assert i1["path"] == "allgather" and i1["retries"] == pol.max_retries
    assert i1["evicted"] is None
    assert i2["path"] == "allgather" and i2["evicted"] == 1
    assert agg.membership[1] == EVICTED and agg.active == (0,)
    assert i3["path"] == "halo" and i3["parts"] == 1
    assert fired == hp.evict_after * ladder
    assert _counter("dist.elastic.retry") == hp.evict_after * pol.max_retries
    assert _counter("dist.halo_fallback") == hp.evict_after
    ref_agg, ref_infos, ref_fired = _ladder_run(
        lambda: ref_elastic.ElasticAggregator(
            ref_g, 2, policy=ref_elastic.RetryPolicy(),
            health=ref_elastic.ShardHealth(
                ref_elastic.HealthPolicy(evict_after=2))),
        RefFaultPlan.of(RefFault("dist.halo", "shard_loss", **fault)),
        ref_armed, 3)
    assert [i1, i2, i3] == ref_infos and fired == ref_fired
    assert agg.membership == ref_agg.membership
    assert agg.clock.now() == ref_agg.clock.now()
    assert _dist_counters(obs) == _dist_counters(ref_obs)


def test_transient_fault_recovers_and_clears_suspect(g):
    agg = ElasticAggregator(g, 2, **CPU)
    with armed(FaultPlan.of(Fault("dist.halo", "shard_loss",
                                  count=3, payload=(("shard", 0),)))):
        info = agg.step_begin(0)
        assert info["path"] == "allgather" and agg.membership[0] == SUSPECT
    info2 = agg.step_begin(1)
    assert info2["path"] == "halo"
    assert agg.membership[0] == ACTIVE
    assert _counter("dist.elastic.evict") == 0


def test_stale_fault_for_evicted_shard_ignored(g):
    agg = ElasticAggregator(g, 2, **CPU)
    agg.repartition_survivors(1)
    with armed(FaultPlan.of(Fault("dist.halo", "shard_loss",
                                  payload=(("shard", 1),)))):
        info = agg.step_begin(0)
    assert info["path"] == "halo"
    assert _counter("dist.elastic.stale_fault") == 1
    assert _counter("dist.halo_fallback") == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_fault_plans_give_the_reference_trail(g, ref_g, seed):
    """A schedule drawn from a seed (straggler and shard loss, no shard
    payload: the highest active shard takes the blame) over 10 steps."""
    spec = {"dist.halo": [("shard_loss", 12), ("straggler", 12),
                          ("shard_loss", 20)]}
    agg, infos, fired = _ladder_run(
        lambda: ElasticAggregator(g, 4, **CPU),
        FaultPlan.generate(seed, spec), armed, 10)
    ref_agg, ref_infos, ref_fired = _ladder_run(
        lambda: ref_elastic.ElasticAggregator(ref_g, 4),
        RefFaultPlan.generate(seed, spec), ref_armed, 10)
    assert infos == ref_infos and fired == ref_fired
    assert agg.clock.now() == ref_agg.clock.now()
    assert _dist_counters(obs) == _dist_counters(ref_obs)


# --------------------------------------------------------------- training
def _train_plan(fault_cls=Fault, plan_cls=FaultPlan):
    return plan_cls.of(fault_cls("dist.halo", "shard_loss", hit=2, count=6,
                                 payload=(("shard", 1),)))


def test_train_elastic_two_same_seed_runs_identical(g):
    def run():
        with armed(_train_plan()):
            return train_elastic(g, parts=2, steps=8, seed=3,
                                 policy=RetryPolicy(), rejoin_at=7, **CPU)

    a, b = run(), run()
    assert a["paths"] == b["paths"]
    assert a["trail"] == b["trail"]
    assert a["losses"] == b["losses"]
    assert a["clock_s"] == b["clock_s"]
    for la, lb in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(la, lb)


@pytest.fixture()
def ref_weights(monkeypatch):
    """The port's ``dist_gnn_init`` returns the reference's draw for the
    same seed (``train_elastic`` looks it up at call time)."""
    def init(generator, dims, device="cuda"):
        seed = generator.initial_seed()
        tree = ref_dist_gnn_init(jax.random.PRNGKey(seed), dims)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               device=device)
    monkeypatch.setattr(port_gnn, "dist_gnn_init", init)


def test_train_elastic_recovery_tracks_no_fault_run(g, ref_g, ref_weights):
    ref = train_elastic(g, parts=2, steps=8, seed=4, **CPU)
    assert ref["paths"] == ["halo"] * 8
    with armed(_train_plan()):
        res = train_elastic(g, parts=2, steps=8, seed=4, rejoin_at=7, **CPU)
    assert res["paths"] == ["halo"] * 2 + ["allgather"] * 2 + ["halo"] * 4
    assert res["trail"][3]["evicted"] == 1
    assert [t["parts"] for t in res["trail"]] == [2, 2, 2, 1, 1, 1, 1, 2]
    for a, b in zip(tree_leaves(ref["params"]), tree_leaves(res["params"])):
        assert np.allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=5e-3)
    # the reference on the same weights and the same fault plan
    with ref_armed(_train_plan(RefFault, RefFaultPlan)):
        jres = ref_elastic.train_elastic(ref_g, parts=2, steps=8, seed=4,
                                         rejoin_at=7)
    assert res["trail"] == jres["trail"]
    assert res["clock_s"] == jres["clock_s"]
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=0,
                               atol=1e-4)
    jref = ref_elastic.train_elastic(ref_g, parts=2, steps=8, seed=4)
    np.testing.assert_allclose(ref["losses"], jref["losses"], rtol=0,
                               atol=1e-4)


def test_train_elastic_checkpoints_mirrored(g, tmp_path):
    from repro_torch.train.checkpoint import restore_mirrored_checkpoint
    res = train_elastic(g, parts=2, steps=4, seed=1, ckpt_dir=str(tmp_path),
                        ckpt_every=2, **CPU)
    zeros = lambda t: [{k: torch.zeros_like(v) for k, v in lp.items()}
                       for lp in t]
    rp, _, step = restore_mirrored_checkpoint(
        str(tmp_path), zeros(res["params"]),
        {k: (zeros(v) if isinstance(v, list) else torch.zeros_like(v))
         for k, v in res["opt_state"].items()}, num_shards=2)
    assert step == 4
    for a, b in zip(tree_leaves(rp), tree_leaves(res["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------- mirrored checkpoints
def _trees(v: float):
    params = [{"w": torch.full((4, 3), v, dtype=torch.float32),
               "b": torch.arange(3, dtype=torch.float32) * v}]
    opt = {"m": torch.full((4, 3), v * 2, dtype=torch.float32),
           "count": torch.tensor(3, dtype=torch.int32)}
    return params, opt


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def test_mirrored_quorum_restore_bit_identical(tmp_path):
    from repro_torch.train.checkpoint import (buddy_of,
                                              restore_mirrored_checkpoint,
                                              save_mirrored_checkpoint)
    assert [buddy_of(s, 3) for s in range(3)] == [1, 2, 0]
    p, o = _trees(1.5)
    root = str(tmp_path)
    save_mirrored_checkpoint(root, 4, p, o, num_shards=2)
    for dirpath, _, files in os.walk(os.path.join(root, "shard_00")):
        for f in files:
            if f.endswith(".npz"):
                corrupt_file(os.path.join(dirpath, f), mode="garble")
    rp, ro, step = restore_mirrored_checkpoint(root, _zeros_like(p),
                                               _zeros_like(o), num_shards=2)
    assert step == 4
    assert _counter("train.ckpt_mirror_fallback") >= 1
    for a, b in zip(tree_leaves((p, o)), tree_leaves((rp, ro))):
        assert torch.equal(a, b)


def test_mirrored_quorum_lost_raises(tmp_path):
    from repro_torch.train.checkpoint import (restore_mirrored_checkpoint,
                                              save_mirrored_checkpoint)
    p, o = _trees(2.0)
    root = str(tmp_path)
    save_mirrored_checkpoint(root, 1, p, o, num_shards=2)
    for path in (os.path.join(root, "shard_00", "step_00000001.npz"),
                 os.path.join(root, "shard_01", "mirror_00",
                              "step_00000001.npz")):
        corrupt_file(path, mode="truncate")
    with pytest.raises(RuntimeError, match="quorum"):
        restore_mirrored_checkpoint(root, _zeros_like(p), _zeros_like(o),
                                    num_shards=2, step=1)


def test_mirrored_falls_back_to_older_step(tmp_path):
    from repro_torch.train.checkpoint import (restore_mirrored_checkpoint,
                                              save_mirrored_checkpoint)
    root = str(tmp_path)
    p1, o1 = _trees(1.0)
    save_mirrored_checkpoint(root, 1, p1, o1, num_shards=2)
    p2, o2 = _trees(2.0)
    save_mirrored_checkpoint(root, 2, p2, o2, num_shards=2)
    for path in (os.path.join(root, "shard_00", "step_00000002.npz"),
                 os.path.join(root, "shard_01", "mirror_00",
                              "step_00000002.npz")):
        corrupt_file(path, mode="truncate")
    rp, ro, step = restore_mirrored_checkpoint(root, _zeros_like(p1),
                                               _zeros_like(o1), num_shards=2)
    assert step == 1
    assert float(rp[0]["w"][0, 0]) == 1.0
    assert _counter("train.ckpt_fallback") >= 1


def test_single_shard_mirrored_roundtrip(tmp_path):
    from repro_torch.train.checkpoint import (restore_mirrored_checkpoint,
                                              save_mirrored_checkpoint)
    p, o = _trees(3.0)
    save_mirrored_checkpoint(str(tmp_path), 7, p, o, num_shards=1)
    rp, ro, step = restore_mirrored_checkpoint(str(tmp_path), _zeros_like(p),
                                               _zeros_like(o), num_shards=1)
    assert step == 7
    for a, b in zip(tree_leaves((p, o)), tree_leaves((rp, ro))):
        assert torch.equal(a, b)


def test_torn_temp_files_invisible_to_listing(tmp_path):
    from repro_torch.train.checkpoint import (available_steps,
                                              restore_checkpoint,
                                              save_checkpoint)
    d = str(tmp_path)
    p, o = _trees(1.0)
    save_checkpoint(d, 3, p, o)
    torn = os.path.join(d, ".step_00000009.npz.tmp")
    with open(torn, "wb") as f:
        f.write(b"\x00" * 128)
    corrupt_file(torn, mode="truncate")
    open(os.path.join(d, "step_0000003x.npz"), "wb").close()
    assert available_steps(d) == [3]
    _, _, step = restore_checkpoint(d, _zeros_like(p), _zeros_like(o))
    assert step == 3
