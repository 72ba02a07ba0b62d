"""The port's fallback chain (``repro_torch/exec/fallback.py``), its chaos
sites and weighted ``sum`` plans against the reference's
(``repro/exec/fallback.py``, ``repro/exec/plan.py``), mirroring
``tests/test_chaos.py``'s exec-degradation tests.

The ``cuda`` backend's wrappers run their plain versions (``kernels/ref.py``)
on CPU tensors, so a ``cuda`` plan built with ``device="cpu"`` runs here and
passes the same two sites (``exec.pallas_launch``, ``exec.kernel_result``)
the card's launches pass: the drills arm them as the reference's tests arm
``pallas``'s.  Verdicts are keyed by the CPU's device signature
(``platform="cpu"``), as the reference's tests key them by its default
backend.  Weighted plans are held to the reference's at 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.chaos import Fault as RefFault
from repro.chaos import FaultPlan as RefFaultPlan
from repro.chaos import armed as ref_armed
from repro.exec import build_layer_plan as ref_build_layer_plan
from repro.exec import build_plan as ref_build_plan
from repro.graph import DatasetSpec as RefSpec
from repro.graph import Graph as RefGraph
from repro.graph import synthesize as ref_synthesize
from repro_torch import obs
from repro_torch.exec import plan as plan_mod
from repro_torch.chaos import Fault, FaultPlan, InjectedFault, armed
from repro_torch.exec import (FALLBACK_CHAIN, BackendFailure, ResilientPlan,
                              build_cost_oracle, build_layer_plan,
                              build_plan, clear_quarantine, dp_schedule,
                              gcn_chain, graph_fingerprint, parity_probe,
                              quarantined_backends, record_quarantine)
from repro_torch.exec.bucketing import make_layer_cand, split_layer_cand

from _torch_parity import to_port

BUCKET_SIG = "16@8+64"
CPU = dict(platform="cpu")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.reset()
    obs.enable()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def ref_graph():
    """The graph of ``tests/test_chaos.py``."""
    return ref_synthesize(RefSpec("chaos", 128, 1000, 16, 4, community=0.9,
                                  num_communities=4, seed=3))


@pytest.fixture(scope="module")
def small_graph(ref_graph):
    return to_port(ref_graph)


def _counter(name: str) -> float:
    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k == name or k.startswith(name + "{"))


def _x(g, seed, d=16):
    return torch.as_tensor(np.random.default_rng(seed)
                           .standard_normal((g.num_nodes, d))
                           .astype(np.float32))


def _coo_ref(g, x):
    return build_plan(g, "gcn", backend="coo", device="cpu").apply(x)


# ------------------------------------------------------- the chain itself
def test_chain_and_primary(small_graph, tmp_path):
    assert FALLBACK_CHAIN == ("cuda", "torch", "coo")
    # build_plan's rule: coo on the CPU
    rp = ResilientPlan(small_graph, "gcn", device="cpu",
                       cache_dir=str(tmp_path))
    assert rp.chain == ["coo", "cuda", "torch"] and rp.backend == "coo"
    assert rp.platform == "cpu"
    rp = ResilientPlan(small_graph, "gcn", backend="cuda", device="cpu",
                       cache_dir=str(tmp_path))
    assert rp.chain == ["cuda", "torch", "coo"]
    y = rp.apply(_x(small_graph, 0))
    assert rp.verdict.backend == "cuda" and not rp.verdict.degraded
    assert list(rp._plans) == ["cuda"]        # the healthy path: one plan
    torch.testing.assert_close(y, _coo_ref(small_graph, _x(small_graph, 0)),
                               atol=1e-5, rtol=0)


def test_resilient_plan_launch_fault_quarantines(small_graph, tmp_path):
    g = small_graph
    x = _x(g, 0)
    ref = _coo_ref(g, x)
    rp = ResilientPlan(g, "gcn", backend="cuda", device="cpu",
                       cache_dir=str(tmp_path))
    with armed(FaultPlan.of(Fault("exec.pallas_launch", "kernel_launch"))):
        y = rp.apply(x)
    assert rp.verdict.degraded and rp.verdict.backend == "torch"
    assert rp.verdict.attempts == (("cuda", "kernel_launch"),)
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
    assert "cuda" in quarantined_backends(graph_fingerprint(g),
                                          cache_dir=str(tmp_path), **CPU)
    assert _counter("exec.fallback") >= 1
    assert _counter("exec.quarantine") >= 1
    # the disarmed follow-up call is healthy and skips the quarantined engine
    y2 = rp.apply(x)
    assert not rp.verdict.degraded and rp.verdict.backend == "torch"
    torch.testing.assert_close(y2, ref, atol=1e-4, rtol=0)
    # a fresh plan on the same cache starts with cuda already excluded
    rp3 = ResilientPlan(g, "gcn", backend="cuda", device="cpu",
                        cache_dir=str(tmp_path))
    assert "cuda" not in rp3.chain and rp3.backend == "torch"


def test_resilient_plan_nan_fault_and_dp_avoidance(small_graph, tmp_path):
    g = small_graph
    x = _x(g, 1)
    ref = _coo_ref(g, x)
    rp = ResilientPlan(g, "gcn", backend="cuda", device="cpu",
                       cache_dir=str(tmp_path))
    with armed(FaultPlan.of(Fault("exec.kernel_result", "nan_backend"))):
        y = rp.apply(x)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
    assert rp.verdict.attempts == (("cuda", "nonfinite_output"),)
    assert _counter("exec.fallback") == 1
    # the DP drops the quarantined backend from every layer's candidates...
    grid = [("aggregate_first", False, "coo", 128, True),
            ("aggregate_first", True, "cuda", 128, True)]
    oracle = build_cost_oracle(g, gcn_chain([16, 16, 4]), candidates=[grid],
                               cache_dir=str(tmp_path), use_cache=False,
                               **CPU)
    assert all(c[2] != "cuda" for cs in oracle.cands for c in cs)
    _, sched = dp_schedule(oracle)
    assert all(c[2] != "cuda" for c in sched)
    # ...unless told not to
    loose = build_cost_oracle(g, gcn_chain([16, 16, 4]), candidates=[grid],
                              cache_dir=str(tmp_path), use_cache=False,
                              respect_quarantine=False, **CPU)
    assert any(c[2] == "cuda" for cs in loose.cands for c in cs)


def test_probe_off_trusts_the_backend(small_graph, tmp_path):
    rp = ResilientPlan(small_graph, "gcn", backend="cuda", device="cpu",
                       probe=False, cache_dir=str(tmp_path))
    with armed(FaultPlan.of(Fault("exec.kernel_result", "nan_backend"))):
        y = rp.apply(_x(small_graph, 1))
    assert not bool(torch.isfinite(y).all())
    assert rp.verdict.backend == "cuda" and not rp.verdict.degraded


def test_every_backend_failing_raises_the_last_error(small_graph, tmp_path):
    # the engines below cuda keep the reference's catch-all (cuda's own
    # errors propagate at once: the next test), so the chain starts past a
    # quarantined cuda
    record_quarantine(graph_fingerprint(small_graph), "cuda", reason="test",
                      cache_dir=str(tmp_path), **CPU)
    rp = ResilientPlan(small_graph, "gcn", backend="cuda", device="cpu",
                       cache_dir=str(tmp_path))
    assert rp.chain == ["torch", "coo"]
    with pytest.raises(ValueError, match="wrong graph"):
        rp.apply(torch.zeros((5, 4)))
    assert rp.verdict.backend == "" and rp.verdict.degraded
    assert [b for b, _ in rp.verdict.attempts] == ["torch", "coo"]
    assert {r for _, r in rp.verdict.attempts} == {"ValueError"}
    # coo stays as the engine of last resort, even quarantined
    assert rp.chain == ["coo"]
    assert ResilientPlan(small_graph, "gcn", backend="cuda", device="cpu",
                         cache_dir=str(tmp_path)).chain == ["coo"]


@pytest.mark.parametrize("kernel,kw", [
    ("spmm_blockell_compact", dict()),
    ("spmm_blockell_fused", dict(compact=False)),
    ("spmm_blockell_compact", dict(buckets=BUCKET_SIG))],
    ids=["compact", "padded", "bucketed"])
def test_a_real_cuda_failure_propagates_unquarantined(small_graph, tmp_path,
                                                      monkeypatch, kernel,
                                                      kw):
    """A deliberate divergence from the reference, which demotes on any
    exception: a failure of the ``cuda`` engine that no drill injected (a
    build, launch or driver error) propagates, is not served by ``torch``,
    and leaves no verdict on disk.  The kernel entry point is replaced by a
    test double that raises, as a failed launch would."""
    def failed_launch(*args, **kwargs):
        raise RuntimeError(f"{kernel}: CUDA error: launch failure")

    monkeypatch.setattr(plan_mod, kernel, failed_launch)
    rp = ResilientPlan(small_graph, "gcn", backend="cuda", device="cpu",
                       cache_dir=str(tmp_path), **kw)
    with pytest.raises(RuntimeError, match="launch failure"):
        rp.apply(_x(small_graph, 3))
    assert rp.verdict is None and rp.chain == ["cuda", "torch", "coo"]
    assert quarantined_backends(graph_fingerprint(small_graph),
                                cache_dir=str(tmp_path), **CPU) == set()
    assert not (tmp_path / "autotune.json").exists()
    assert _counter("exec.fallback") == 0
    assert _counter("exec.quarantine") == 0
    # the caller's own error on the cuda engine propagates the same way
    monkeypatch.undo()
    with pytest.raises(ValueError, match="wrong graph"):
        rp.apply(torch.zeros((5, 4)))
    assert rp.verdict is None and rp.chain == ["cuda", "torch", "coo"]


def test_backend_failure_names_backend_and_reason():
    err = BackendFailure("cuda", "nonfinite_output")
    assert err.backend == "cuda" and err.reason == "nonfinite_output"
    assert "cuda" in str(err) and "nonfinite_output" in str(err)


def test_clear_quarantine(small_graph, tmp_path):
    fp = graph_fingerprint(small_graph)
    record_quarantine(fp, "cuda", reason="test", cache_dir=str(tmp_path),
                      **CPU)
    assert quarantined_backends(fp, cache_dir=str(tmp_path), **CPU) == {
        "cuda"}
    # keyed by device signature: the card's verdicts are another set
    assert quarantined_backends(fp, cache_dir=str(tmp_path)) == set()
    assert clear_quarantine(fp, cache_dir=str(tmp_path), **CPU) == 1
    assert quarantined_backends(fp, cache_dir=str(tmp_path), **CPU) == set()


# --------------------------------------------- bucketed (multi-grid) plans
def test_bucketed_resilient_plan_demotes_whole_call(small_graph, tmp_path):
    g = small_graph
    x = _x(g, 2)
    ref = _coo_ref(g, x)
    rp = ResilientPlan(g, "gcn", backend="cuda", buckets=BUCKET_SIG,
                       device="cpu", cache_dir=str(tmp_path))
    # one launch fault in the FIRST bucket's sub-grid: the whole multi-grid
    # call aborts and demotes (no half-stitched output), landing on the
    # torch engine still bucketed with the same scheme
    with armed(FaultPlan.of(Fault("exec.pallas_launch", "kernel_launch"))
               ) as inj:
        y = rp.apply(x)
    assert inj.hits["exec.pallas_launch"] == 1
    assert rp.verdict.degraded and rp.verdict.backend == "torch"
    assert rp.plan_for("torch").buckets == BUCKET_SIG
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
    # quarantine keys the bucketed candidate CLASS, not the bare engine
    bad = quarantined_backends(graph_fingerprint(g), cache_dir=str(tmp_path),
                               **CPU)
    assert f"cuda|{BUCKET_SIG}" in bad and "cuda" not in bad


def test_bucketed_quarantine_class_scoping(small_graph, tmp_path):
    fp = graph_fingerprint(small_graph)
    kw = dict(device="cpu", cache_dir=str(tmp_path))
    # a bucketed-class verdict bans only that bucketing...
    record_quarantine(fp, f"cuda|{BUCKET_SIG}", reason="test",
                      cache_dir=str(tmp_path), **CPU)
    assert "cuda" in ResilientPlan(small_graph, "gcn", backend="cuda",
                                   **kw).chain
    assert "cuda" not in ResilientPlan(small_graph, "gcn", backend="cuda",
                                       buckets=BUCKET_SIG, **kw).chain
    # ...while a bare-engine verdict bans every bucketing of it
    record_quarantine(fp, "torch", reason="test", cache_dir=str(tmp_path),
                      **CPU)
    bucketed2 = ResilientPlan(small_graph, "gcn", backend="torch",
                              buckets=BUCKET_SIG, **kw)
    assert "torch" not in bucketed2.chain
    # the coo rung never buckets: the last demotion drops the signature
    assert bucketed2._buckets_for("coo") == ""
    assert bucketed2.plan_for("coo").buckets == ""


def test_cost_oracle_drops_bucketed_class_keeps_plain(small_graph, tmp_path):
    fp = graph_fingerprint(small_graph)
    record_quarantine(fp, f"cuda|{BUCKET_SIG}", reason="test",
                      cache_dir=str(tmp_path), **CPU)
    grid = [make_layer_cand("aggregate_first", False, "coo", 128, True),
            make_layer_cand("aggregate_first", True, "cuda", 128, True),
            make_layer_cand("aggregate_first", True, "cuda", 64, True,
                            BUCKET_SIG)]
    oracle = build_cost_oracle(small_graph, gcn_chain([16, 16, 4]),
                               candidates=[grid], cache_dir=str(tmp_path),
                               use_cache=False, **CPU)
    kept = {(split_layer_cand(c)[2], split_layer_cand(c)[5])
            for cs in oracle.cands for c in cs}
    assert ("cuda", BUCKET_SIG) not in kept       # quarantined class gone
    assert ("cuda", "") in kept                   # plain engine survives
    assert ("coo", "") in kept


# ------------------------------------------------------------ parity probe
def test_parity_probe(small_graph):
    g = small_graph
    coo = build_plan(g, "gcn", backend="coo", device="cpu")
    for backend in ("cuda", "torch"):
        assert parity_probe(build_plan(g, "gcn", backend=backend,
                                       device="cpu"), coo)
    # another function fails the probe, and so does a plan that raises or
    # answers NaN
    assert not parity_probe(build_plan(g, "sum", backend="coo",
                                       device="cpu"), coo)
    other = build_plan(to_port(RefGraph(src=g.src[:10] % 64,
                                        dst=g.dst[:10] % 64, num_nodes=64)),
                       "gcn", backend="coo", device="cpu")
    assert not parity_probe(other, coo)
    with armed(FaultPlan.of(Fault("exec.kernel_result", "nan_backend"))):
        assert not parity_probe(build_plan(g, "gcn", backend="cuda",
                                           device="cpu"), coo)


def test_parity_probe_matches_the_reference(ref_graph, small_graph):
    """The same verdicts as the reference's probe on the same plans."""
    from repro.exec import parity_probe as ref_probe
    ref_coo = ref_build_plan(ref_graph, "gcn", backend="coo")
    coo = build_plan(small_graph, "gcn", backend="coo", device="cpu")
    for mode in ("gcn", "sum", "mean"):
        got = parity_probe(build_plan(small_graph, mode, backend="torch",
                                      device="cpu"), coo)
        want = ref_probe(ref_build_plan(ref_graph, mode, backend="jnp"),
                         ref_coo)
        assert got == want == (mode == "gcn")


# ------------------------------------------------------ sites, both sides
# (plan kind, build kwargs); the reference's pallas runs in interpret mode
SITE_PLANS = [("compact", dict(compact=True)),
              ("padded", dict(compact=False)),
              ("bucketed", dict(buckets=BUCKET_SIG))]


@pytest.mark.parametrize("kind,kw", SITE_PLANS, ids=[k for k, _ in
                                                     SITE_PLANS])
def test_sites_fire_as_often_as_the_reference(ref_graph, small_graph, kind,
                                              kw):
    """One forward and one backward pass over each plan kind hits each site
    as many times as the reference's pallas plan does (the drills' hit
    indices mean the same in both packages)."""
    x = np.random.default_rng(3).standard_normal(
        (small_graph.num_nodes, 16)).astype(np.float32)
    never = [("exec.pallas_launch", "kernel_launch"),
             ("exec.kernel_result", "nan_backend")]
    ref_plan = ref_build_plan(ref_graph, "gcn", backend="pallas", **kw)
    with ref_armed(RefFaultPlan.of(*[RefFault(s, k, hit=10 ** 6)
                                     for s, k in never])) as ref_inj:
        jax.grad(lambda v: jnp.sum(ref_plan.apply(v) ** 2))(jnp.asarray(x))
    plan = build_plan(small_graph, "gcn", backend="cuda", device="cpu",
                      **kw)
    xt = torch.as_tensor(x).requires_grad_()
    with armed(FaultPlan.of(*[Fault(s, k, hit=10 ** 6)
                              for s, k in never])) as inj:
        (plan.apply(xt) ** 2).sum().backward()
    assert inj.hits == ref_inj.hits
    assert inj.hits["exec.pallas_launch"] >= 2


@pytest.mark.parametrize("buckets", ["", BUCKET_SIG])
def test_fused_layer_sites_propagate(ref_graph, small_graph, buckets):
    """Layer plans have no chain: a launch fault on a fused layer raises
    ``InjectedFault`` to the caller, and a disarmed layer hits its sites as
    often as the reference's."""
    lp = build_layer_plan(small_graph, "gcn", d_in=16, d_out=8,
                          order="aggregate_first", backend="cuda",
                          buckets=buckets, device="cpu")
    assert lp.fuse
    rng = np.random.default_rng(4)
    x = rng.standard_normal((small_graph.num_nodes, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    with armed(FaultPlan.of(Fault("exec.pallas_launch", "kernel_launch"))):
        with pytest.raises(InjectedFault):
            lp.apply(torch.as_tensor(x), torch.as_tensor(w))
    with armed(FaultPlan.of(Fault("exec.kernel_result", "nan_backend"))):
        y = lp.apply(torch.as_tensor(x), torch.as_tensor(w))
    assert not bool(torch.isfinite(y).all())
    ref_lp = ref_build_layer_plan(ref_graph, "gcn", d_in=16, d_out=8,
                                  order="aggregate_first", backend="pallas",
                                  buckets=buckets)
    far = [("exec.pallas_launch", "kernel_launch", 10 ** 6)]
    with ref_armed(RefFaultPlan.of(*[RefFault(*f) for f in far])) as ref_inj:
        ref_y = ref_lp.apply(jnp.asarray(x), jnp.asarray(w))
    with armed(FaultPlan.of(*[Fault(*f) for f in far])) as inj:
        got = lp.apply(torch.as_tensor(x), torch.as_tensor(w))
    assert inj.hits == ref_inj.hits
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_y), rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref_y).max())))


# ----------------------------------------------------------- weighted plans
def _weighted_graph(masked: bool) -> RefGraph:
    """A random graph with no duplicate edge (so its 0/1 bitmask is exact)
    and uniform weights in [0, 1)."""
    rng = np.random.default_rng(5)
    n, e = 300, 2000
    key = np.unique(rng.integers(0, n * n, e))
    e = key.size
    return RefGraph(src=(key % n).astype(np.int32),
                    dst=(key // n).astype(np.int32), num_nodes=n,
                    edge_weight=rng.random(e).astype(np.float32),
                    edge_mask=(rng.random(e) < 0.9) if masked else None)


WEIGHTED = [("coo", dict()), ("torch", dict(compact=True)),
            ("torch", dict(compact=False)), ("cuda", dict(compact=True)),
            ("cuda", dict(compact=False)), ("cuda", dict(buckets="32@8+64")),
            ("torch", dict(buckets="32@8+64"))]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("backend,kw", WEIGHTED,
                         ids=[f"{b}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for b, kw in WEIGHTED])
def test_weighted_sum_plans_match_reference(backend, kw, masked):
    """``weighted=True`` sum plans, forward and backward (the transpose
    plan), against the reference's weighted jnp plan; the cuda plans carry
    float32 coefficients (the entries of float32 tiles), as on the card."""
    g = _weighted_graph(masked)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((g.num_nodes, 24)).astype(np.float32)
    gy = rng.standard_normal((g.num_nodes, 24)).astype(np.float32)
    ref_plan = ref_build_plan(g, "sum", backend="jnp", weighted=True, **kw)
    y_ref, vjp = jax.vjp(ref_plan.apply, jnp.asarray(x))
    dx_ref = np.asarray(vjp(jnp.asarray(gy))[0])
    plan = build_plan(to_port(g), "sum", backend=backend, weighted=True,
                      device="cpu", **kw)
    if backend == "cuda" and not kw.get("buckets"):
        key = "coef" if kw["compact"] else "blocks"   # lists or tiles
        assert plan._fwd[key].dtype == torch.float32
    xt = torch.as_tensor(x).requires_grad_()
    y = plan.apply(xt)
    y.backward(torch.as_tensor(gy))
    for got, ref, what in ((y.detach().numpy(), np.asarray(y_ref), "y"),
                           (xt.grad.numpy(), dx_ref, "dx")):
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=TOL * max(1.0, float(np.abs(ref).max())),
            err_msg=what)
    # the weights matter: the unweighted plan computes another function
    unw = build_plan(to_port(g), "sum", backend=backend, device="cpu", **kw)
    assert float((unw.apply(torch.as_tensor(x)) - y.detach()).abs().max()
                 ) > 0.1


@pytest.mark.parametrize("mode", ["gcn", "mean"])
def test_weighted_composes_with_sum_only(mode):
    g = _weighted_graph(False)
    with pytest.raises(ValueError, match="mode='sum'"):
        ref_build_plan(g, mode, weighted=True)
    with pytest.raises(ValueError, match="mode='sum'"):
        build_plan(to_port(g), mode, weighted=True, device="cpu")


def test_weights_dropped_unless_weighted():
    """As in the reference, a plan built without ``weighted`` ignores the
    graph's edge weights (the 0/1 bitmask tiles)."""
    g = _weighted_graph(False)
    pg = to_port(g)
    plain = to_port(RefGraph(src=g.src, dst=g.dst, num_nodes=g.num_nodes))
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (g.num_nodes, 8)).astype(np.float32))
    for backend in ("coo", "torch", "cuda"):
        a = build_plan(pg, "sum", backend=backend, device="cpu")
        b = build_plan(plain, "sum", backend=backend, device="cpu")
        torch.testing.assert_close(a.apply(x), b.apply(x), rtol=0, atol=0)
    # unit entries: no coefficient (the uint8 bitmask's)
    assert "coef" not in build_plan(pg, "sum", backend="cuda",
                                    device="cpu")._fwd


def test_weighted_tiles_match_the_reference():
    """A weighted plan's tiles hold the weights (float32 on ``cuda``), the
    same tiles the reference's weighted plan stores, in both directions."""
    g = _weighted_graph(False)
    ref_plan = ref_build_plan(g, "sum", backend="jnp", weighted=True,
                              compact=False)
    plan = build_plan(to_port(g), "sum", backend="cuda", weighted=True,
                      compact=False, device="cpu")
    assert plan._fwd["blocks"].dtype == torch.float32
    for a, b in ((plan.ell, ref_plan.ell), (plan.ell_t, ref_plan.ell_t)):
        assert a.width == b.width and not a.implicit and not b.implicit
        np.testing.assert_array_equal(a.dense_blocks(np.float32),
                                      b.dense_blocks(np.float32))


def test_weighted_resilient_plan_demotes_to_weighted_plans(tmp_path):
    g = _weighted_graph(True)
    x = np.random.default_rng(9).standard_normal(
        (g.num_nodes, 16)).astype(np.float32)
    ref = np.asarray(ref_build_plan(g, "sum", backend="coo", weighted=True)
                     .apply(jnp.asarray(x)))
    rp = ResilientPlan(to_port(g), "sum", backend="cuda", weighted=True,
                       device="cpu", cache_dir=str(tmp_path))
    tol = TOL * float(np.abs(ref).max())
    np.testing.assert_allclose(rp.apply(torch.as_tensor(x)).numpy(), ref,
                               rtol=0, atol=tol)
    with armed(FaultPlan.of(Fault("exec.pallas_launch", "kernel_launch"),
                            Fault("exec.kernel_result", "nan_backend"))):
        rp2 = ResilientPlan(to_port(g), "sum", backend="cuda", weighted=True,
                            device="cpu", cache_dir=str(tmp_path / "b"))
        y = rp2.apply(torch.as_tensor(x))
    assert rp2.verdict.backend == "torch"
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=tol)
    rp3 = ResilientPlan(to_port(g), "sum", backend="torch", weighted=True,
                        device="cpu", cache_dir=str(tmp_path / "c"))
    with armed(FaultPlan.of(Fault("exec.kernel_result", "nan_backend"))):
        # the torch engine passes no kernel site: nothing fires, no demotion
        y3 = rp3.apply(torch.as_tensor(x))
    assert rp3.verdict.backend == "torch" and not rp3.verdict.degraded
    np.testing.assert_allclose(y3.numpy(), ref, rtol=0, atol=tol)
