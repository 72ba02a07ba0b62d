"""The port's G-D / G-C cache model and Table II cost model against the
reference's (``repro/core/cache_model.py``, ``repro/core/perf_model.py``):
the same graphs and plans in, every integer and float out equal.

* ``LRUCache``'s presence API (``access`` / ``insert``) over one seeded key
  stream: the same hit/miss answers and counters;
* every ``TrafficReport`` field of ``simulate_gd``, ``simulate_gd_gc`` and
  ``schedule_comparison`` (Index, LR and LR&CR) on Cora, the community
  graph and CITESEER-S at scale 0.005, over PE counts and cache sizes;
* ``layer_cost`` / ``gcn_cost`` / ``aggregation_traffic`` on every Table II
  platform, ``model_shapes``, ``GRAPHSAGE_DIMS`` / ``GIN_DIMS`` and the
  platforms themselves.  These constants model the paper's platforms (its
  GPU is a Quadro P6000), not the card the port runs on.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import cache_model as ref_cm
from repro.core import perf_model as ref_pm
from repro.core import reorder as ref_reorder
from repro.core import shared_set as ref_shared
from repro.graph import citeseer_s_like as ref_citeseer_s_like
from repro_torch.core import build_shared_plan, cache_model, perf_model

from _torch_parity import to_port


@functools.lru_cache(maxsize=None)
def _citeseer():
    return ref_citeseer_s_like(scale=0.005)


def _pair(request, name):
    """(index-order graph, reordered graph) of the reference."""
    g = _citeseer() if name == "citeseer" else request.getfixturevalue(name)
    return g, g.permute(ref_reorder.minhash_reorder(g))


def _report(r) -> tuple:
    return dataclasses.astuple(r)


@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_lru_presence_api_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    keys = rng.integers(0, 40, 2000).tolist()
    ops = rng.random(2000) < 0.7
    port, ref = cache_model.LRUCache(capacity), ref_cm.LRUCache(capacity)
    for k, acc in zip(keys, ops):
        if acc:
            assert port.access(k) == ref.access(k)
        else:
            port.insert(k)
            ref.insert(k)
        assert list(port.store) == list(ref.store)
    assert (port.hits, port.misses, port.evictions, port.hit_rate) == \
        (ref.hits, ref.misses, ref.evictions, ref.hit_rate)
    # the value API shares the store and the eviction order
    port.put(1000, "v")
    ref.put(1000, "v")
    assert list(port.store) == list(ref.store)
    assert port.get(1000) == ref.get(1000) == "v"
    assert port.get(-1) is cache_model.LRUCache.MISS


@pytest.mark.parametrize("name", ["cora", "community_graph", "citeseer"])
@pytest.mark.parametrize("pes,kb,d", [(64, 128, 1433), (16, 64, 64),
                                      (4, 8, 3703)])
def test_simulate_gd_matches_reference(request, name, pes, kb, d):
    for g in _pair(request, name):
        assert _report(cache_model.simulate_gd(to_port(g), pes, kb << 10,
                                               d)) == \
            _report(ref_cm.simulate_gd(g, pes, kb << 10, d))


@pytest.mark.parametrize("name", ["cora", "community_graph", "citeseer"])
@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("pes,gd_kb,gc_kb,d", [(64, 64, 64, 128),
                                               (16, 32, 8, 64),
                                               (64, 64, 64, 3703)])
def test_simulate_gd_gc_matches_reference(request, name, levels, pes, gd_kb,
                                          gc_kb, d):
    _, g = _pair(request, name)
    plan = build_shared_plan(to_port(g), levels=levels)
    ref_plan = ref_shared.build_shared_plan(g, levels=levels)
    got = cache_model.simulate_gd_gc(to_port(g), plan, pes, gd_kb << 10,
                                     gc_kb << 10, d)
    want = ref_cm.simulate_gd_gc(g, ref_plan, pes, gd_kb << 10, gc_kb << 10,
                                 d)
    assert _report(got) == _report(want)


@pytest.mark.parametrize("name", ["cora", "community_graph", "citeseer"])
@pytest.mark.parametrize("kw", [{}, dict(num_pes=16, gd_bytes=32 << 10,
                                         gc_bytes=16 << 10, feat_dim=1433)])
def test_schedule_comparison_matches_reference(request, name, kw):
    g, g_lr = _pair(request, name)
    got = cache_model.schedule_comparison(
        to_port(g), to_port(g_lr), build_shared_plan(to_port(g_lr)), **kw)
    want = ref_cm.schedule_comparison(
        g, g_lr, ref_shared.build_shared_plan(g_lr), **kw)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], ref_cm.TrafficReport):
            assert _report(got[k]) == _report(want[k]), k
        else:
            assert got[k] == want[k], k


def test_schedule_comparison_keeps_the_reference_finding(cora):
    """On the reordered Cora the reference's LR&CR moves a little more than
    LR (3,514,880 against 3,513,344 bytes at the defaults): a finding of the
    reference that the port reproduces, not one it repairs."""
    g_lr = cora.permute(ref_reorder.minhash_reorder(cora))
    out = cache_model.schedule_comparison(
        to_port(cora), to_port(g_lr), build_shared_plan(to_port(g_lr)))
    assert (out["lr"].offchip_bytes, out["lrcr"].offchip_bytes) == \
        (3_513_344, 3_514_880)
    assert out["lrcr_extra_reduction_vs_lr"] < 0


PLATFORMS = ["NN_ACC", "GRAPH_ACC", "RUBIK", "GPU"]


def test_platforms_and_constants_match_reference():
    for name in PLATFORMS:
        p, r = getattr(perf_model, name), getattr(ref_pm, name)
        assert dataclasses.astuple(p) == dataclasses.astuple(r)
        assert p.macs_per_s == r.macs_per_s
    for c in ("E_MAC32", "E_SRAM_BYTE", "E_GBUF_BYTE", "E_DRAM_BYTE",
              "GPU_AVG_POWER"):
        assert getattr(perf_model, c) == getattr(ref_pm, c), c
    for d_in, classes in ((3703, 41), (602, 6)):
        assert perf_model.GRAPHSAGE_DIMS(d_in, classes) == \
            ref_pm.GRAPHSAGE_DIMS(d_in, classes)
        assert perf_model.GIN_DIMS(d_in, classes) == \
            ref_pm.GIN_DIMS(d_in, classes)


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("name", ["cora", "community_graph"])
@pytest.mark.parametrize("cr", [False, True])
def test_cost_model_matches_reference(request, platform, name, cr):
    """``aggregation_traffic`` on the platform's caches, then
    ``layer_cost`` (training and inference) and ``gcn_cost`` over the
    paper's GraphSAGE and GIN widths."""
    _, g = _pair(request, name)
    pg = to_port(g)
    p, r = getattr(perf_model, platform), getattr(ref_pm, platform)
    d_in = g.node_feat.shape[1]
    plan = build_shared_plan(pg) if cr else None
    ref_plan = ref_shared.build_shared_plan(g) if cr else None
    for dims in (perf_model.GRAPHSAGE_DIMS(d_in, 7),
                 perf_model.GIN_DIMS(d_in, 7)):
        shapes = perf_model.model_shapes(pg, dims)
        ref_shapes = ref_pm.model_shapes(g, dims)
        assert [dataclasses.astuple(s) for s in shapes] == \
            [dataclasses.astuple(s) for s in ref_shapes]
        traffic = [perf_model.aggregation_traffic(p, pg, s.d_in, plan)
                   for s in shapes[:2]]
        ref_traffic = [ref_pm.aggregation_traffic(r, g, s.d_in, ref_plan)
                       for s in ref_shapes[:2]]
        assert [_report(t) for t in traffic] == \
            [_report(t) for t in ref_traffic]
        for train in (True, False):
            assert dataclasses.astuple(perf_model.layer_cost(
                p, shapes[0], traffic[0], train)) == dataclasses.astuple(
                ref_pm.layer_cost(r, ref_shapes[0], ref_traffic[0], train))
        got = perf_model.gcn_cost(p, shapes[:2], traffic)
        want = ref_pm.gcn_cost(r, ref_shapes[:2], ref_traffic)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        base = perf_model.gcn_cost(perf_model.GPU, shapes[:2], traffic)
        assert got.speedup_vs(base) == want.speedup_vs(
            ref_pm.gcn_cost(ref_pm.GPU, ref_shapes[:2], ref_traffic))
        assert got.energy_eff_vs(base) == want.energy_eff_vs(
            ref_pm.gcn_cost(ref_pm.GPU, ref_shapes[:2], ref_traffic))


def test_uncached_platform_counts_every_valid_edge(cora):
    """A platform without a private cache loads one vector per valid edge,
    masked edges excluded."""
    rng = np.random.default_rng(0)
    g = dataclasses.replace(cora, edge_mask=rng.random(cora.num_edges) < 0.6)
    got = perf_model.aggregation_traffic(perf_model.NN_ACC, to_port(g), 16)
    assert _report(got) == _report(ref_pm.aggregation_traffic(ref_pm.NN_ACC,
                                                               g, 16))
    assert got.feature_loads == int(g.edge_mask.sum())
