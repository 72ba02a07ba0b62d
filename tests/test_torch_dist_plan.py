"""The port's halo and send plans (``repro_torch/graph/partition.py``,
``repro_torch/dist/plan.py``) and compression primitives
(``repro_torch/dist/compress.py``) against the reference's.

Held: every ``HaloPlan`` / ``SendPlan`` array byte-equal at P in {1, 2, 3,
4, 8} on the reference's ``community_graph`` and on the reordered Cora;
``collective_bytes_estimate`` and its ``dist.*`` gauges equal; the overflow
errors raised alike; the int8 codes and scales byte-equal (both round half
to even); ``topk_compress`` keeping the reference's entries (ties to the
lower index) with ``kept + err == g + residual`` exactly.  The reference's
own plan tests (``tests/test_dist_plan.py``) run on the port too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import obs as ref_obs
from repro.core import minhash_reorder as ref_minhash_reorder
from repro.core import segment_aggregate as ref_segment_aggregate
from repro.dist import build_send_plan as ref_build_send_plan
from repro.dist import collective_bytes_estimate as ref_estimate
from repro.dist import compress as ref_compress
from repro.graph import build_halo_plan as ref_build_halo_plan
from repro.graph import cora_like as ref_cora_like
from repro.graph import Graph as RefGraph
from repro.graph import cut_edges as ref_cut_edges
from repro.graph import uniform_local_n as ref_uniform_local_n
from repro.graph import window_partition as ref_window_partition
from repro_torch import obs
from repro_torch.core import minhash_reorder
from repro_torch.dist import (build_send_plan, collective_bytes_estimate,
                              dequantize_int8, quantize_int8, topk_compress)
from repro_torch.graph import (build_halo_plan, cut_edges, uniform_local_n,
                               window_partition)

from _torch_parity import assert_bytes_equal, to_port

PARTS = (1, 2, 3, 4, 8)
HALO_FIELDS = ("halo_src", "halo_mask", "edge_src", "edge_dst", "edge_mask",
               "edge_weight")
SEND_FIELDS = ("send_idx", "send_mask", "recv_slot", "recv_mask")


@pytest.fixture(autouse=True)
def _obs_clean():
    for o in (obs, ref_obs):
        o.reset()
        o.enable()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


@pytest.fixture(scope="module")
def graphs(community_graph):
    cora = ref_cora_like()
    cora = cora.permute(ref_minhash_reorder(cora))
    weighted = dataclasses.replace(
        cora, edge_weight=np.random.default_rng(3).random(cora.num_edges)
        .astype(np.float32))
    return {"community": community_graph, "cora_reordered": cora,
            "cora_weighted": weighted}


def _assert_plans_equal(ours, ref):
    for f in HALO_FIELDS:
        assert_bytes_equal(getattr(ours, f), getattr(ref, f), f)
    assert_bytes_equal(ours.parts.boundaries, ref.parts.boundaries,
                       "boundaries")
    assert ours.cut_edges == ref.cut_edges
    assert ours.total_edges == ref.total_edges
    assert ours.halo_capacity == ref.halo_capacity
    assert ours.halo_fraction == ref.halo_fraction


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ["community", "cora_reordered",
                                  "cora_weighted"])
def test_halo_and_send_plans_byte_equal(graphs, name, parts):
    g = graphs[name]
    ref = ref_build_halo_plan(g, parts)
    ours = build_halo_plan(to_port(g), parts)
    _assert_plans_equal(ours, ref)
    send, ref_send = build_send_plan(ours), ref_build_send_plan(ref)
    for f in SEND_FIELDS:
        assert_bytes_equal(getattr(send, f), getattr(ref_send, f), f)
    assert_bytes_equal(send.rows_received(), ref_send.rows_received())
    assert cut_edges(to_port(g), parts) == ref_cut_edges(g, parts)


def test_fixed_capacities_byte_equal(graphs):
    g = graphs["cora_reordered"]
    ref = ref_build_halo_plan(g, 4, halo_capacity=1200, edge_capacity=4000)
    ours = build_halo_plan(to_port(g), 4, halo_capacity=1200,
                           edge_capacity=4000)
    _assert_plans_equal(ours, ref)
    send = build_send_plan(ours, pair_capacity=700)
    ref_send = ref_build_send_plan(ref, pair_capacity=700)
    for f in SEND_FIELDS:
        assert_bytes_equal(getattr(send, f), getattr(ref_send, f), f)


def test_masked_edges_byte_equal():
    rng = np.random.default_rng(9)
    n, e = 96, 700
    rg = RefGraph(src=rng.integers(0, n, e).astype(np.int32),
                  dst=rng.integers(0, n, e).astype(np.int32), num_nodes=n,
                  edge_mask=rng.random(e) < 0.7)
    g = to_port(rg)
    for parts in (3, 5):
        _assert_plans_equal(build_halo_plan(g, parts),
                            ref_build_halo_plan(rg, parts))
        assert cut_edges(g, parts) == ref_cut_edges(rg, parts)


@pytest.mark.parametrize("what", ["halo", "edge", "pair"])
def test_overflow_errors_as_the_reference(graphs, what):
    g = graphs["cora_reordered"]
    kw = {"halo": {"halo_capacity": 10}, "edge": {"edge_capacity": 10},
          "pair": {}}[what]
    with pytest.raises(ValueError) as ref_err:
        ref_build_send_plan(ref_build_halo_plan(g, 4, **kw), pair_capacity=5)
    with pytest.raises(ValueError) as err:
        build_send_plan(build_halo_plan(to_port(g), 4, **kw),
                        pair_capacity=5)
    assert str(err.value) == str(ref_err.value)
    assert what in str(err.value)


def test_uniform_local_n_and_ragged_partition():
    assert uniform_local_n(window_partition(1024, 8)) == 128
    assert uniform_local_n(window_partition(7, 1)) == 7
    for n, p in ((2708, 8), (10, 3)):
        with pytest.raises(ValueError, match="ragged") as err:
            uniform_local_n(window_partition(n, p))
        with pytest.raises(ValueError) as ref_err:
            ref_uniform_local_n(ref_window_partition(n, p))
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("parts", PARTS)
def test_collective_bytes_estimate_and_gauges_equal(graphs, parts):
    g = graphs["cora_reordered"]
    ref_plan = ref_build_halo_plan(g, parts)
    plan = build_halo_plan(to_port(g), parts)
    for d, bpe in ((1433, 4), (64, 2)):
        est = collective_bytes_estimate(plan, build_send_plan(plan), d=d,
                                        bytes_per_elem=bpe)
        ref = ref_estimate(ref_plan, ref_build_send_plan(ref_plan), d=d,
                           bytes_per_elem=bpe)
        assert est == ref
    gauges = {k: v for k, v in obs.snapshot()["gauges"].items()
              if k.startswith("dist.")}
    assert gauges and gauges == {
        k: v for k, v in ref_obs.snapshot()["gauges"].items()
        if k.startswith("dist.")}


# ------------------------------------------- the reference's plan tests
PLAN_PARTS = 8


@pytest.fixture(scope="module")
def plan_and_send(community_graph):
    g = to_port(community_graph)
    plan = build_halo_plan(g, PLAN_PARTS)
    return g, plan, build_send_plan(plan)


def test_send_plan_round_trip(plan_and_send):
    g, plan, send = plan_and_send
    b = plan.parts.boundaries
    for p in range(PLAN_PARTS):
        for q in range(PLAN_PARTS):
            sm = send.send_mask[q, p]
            rm = send.recv_mask[p, q]
            assert sm.sum() == rm.sum()
            if not sm.any():
                continue
            sent_global = b[q] + send.send_idx[q, p][sm]
            filed_global = plan.halo_src[p][send.recv_slot[p, q][rm]]
            np.testing.assert_array_equal(sent_global, filed_global)
            assert (plan.parts.part_of(sent_global) == q).all()


def test_send_plan_covers_all_halo_slots(plan_and_send):
    _, plan, send = plan_and_send
    for p in range(PLAN_PARTS):
        slots = np.concatenate(
            [send.recv_slot[p, q][send.recv_mask[p, q]]
             for q in range(PLAN_PARTS)])
        expected = np.nonzero(plan.halo_mask[p])[0]
        assert sorted(slots.tolist()) == expected.tolist()


def test_send_plan_padding_invariants(plan_and_send):
    _, plan, send = plan_and_send
    P, P2, K = send.send_idx.shape
    assert P == P2 == PLAN_PARTS
    for t, m in ((send.send_idx, send.send_mask),
                 (send.recv_slot, send.recv_mask)):
        assert (t[~m] == 0).all()
        n_live = m.sum(axis=-1)
        first_dead = m.argmin(axis=-1)
        assert ((n_live == K) | (first_dead == n_live)).all()
    assert not send.send_mask[np.arange(PLAN_PARTS),
                              np.arange(PLAN_PARTS)].any()
    assert send.send_mask[..., K - 1].any()
    wide = build_send_plan(plan, pair_capacity=K + 7)
    assert wide.pair_capacity == K + 7
    assert (wide.rows_received() == send.rows_received()).all()
    with pytest.raises(ValueError):
        build_send_plan(plan, pair_capacity=max(K - 1, 0))


def test_numpy_halo_simulation_matches_oracle(plan_and_send):
    """The exchange simulated in numpy from the port's tables against the
    reference's single-device ``segment_aggregate``."""
    g, plan, send = plan_and_send
    local_n = uniform_local_n(plan.parts)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    out = np.zeros_like(x, shape=(g.num_nodes, 16))
    b = plan.parts.boundaries
    for p in range(PLAN_PARTS):
        halo = np.zeros((plan.halo_capacity, 16), np.float32)
        for q in range(PLAN_PARTS):
            rm = send.recv_mask[p, q]
            if rm.any():
                rows = x[b[q] + send.send_idx[q, p][send.send_mask[q, p]]]
                halo[send.recv_slot[p, q][rm]] = rows
        full = np.concatenate([x[b[p]:b[p] + local_n], halo])
        msgs = full[plan.edge_src[p]] * plan.edge_weight[p][:, None]
        np.add.at(out[b[p]:b[p] + local_n], plan.edge_dst[p], msgs)
    ref = np.asarray(ref_segment_aggregate(jnp.asarray(x), jnp.asarray(g.src),
                                           jnp.asarray(g.dst), g.num_nodes))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_reordering_shrinks_collective_bytes(community_graph):
    g = to_port(community_graph)
    est = {}
    for tag, gg in (("index", g), ("reordered", g.permute(minhash_reorder(g)))):
        plan = build_halo_plan(gg, PLAN_PARTS)
        est[tag] = collective_bytes_estimate(plan, build_send_plan(plan),
                                             d=64)
    assert est["reordered"]["cut_edge_fraction"] <= \
        est["index"]["cut_edge_fraction"]
    assert est["reordered"]["halo_bytes_per_chip_real"] <= \
        est["index"]["halo_bytes_per_chip_real"]
    assert est["reordered"]["halo_bytes_per_chip_real"] < \
        est["reordered"]["allgather_bytes_per_chip"]
    assert est["reordered"]["reduction_vs_allgather"] > 1.0


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed,shape,scale", [(3, (32, 257), 5.0),
                                              (4, (7, 3), 1e-3),
                                              (5, (1, 1000), 300.0)])
def test_quantize_int8_equals_the_reference(seed, shape, scale):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * np.float32(scale)
    q, s = quantize_int8(torch.as_tensor(x))
    rq, rs = ref_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert_bytes_equal(q.numpy(), np.asarray(rq), "codes")
    assert_bytes_equal(s.numpy(), np.asarray(rs), "scales")
    deq = dequantize_int8(q, s).numpy()
    assert_bytes_equal(deq, np.asarray(ref_compress.dequantize_int8(rq, rs)))
    err = np.abs(deq - x)
    bound = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    assert (err <= bound * 0.5 + 1e-7 * scale).all()


def test_quantize_rounds_half_to_even():
    # 127 * (k + 0.5) / 127.5: codes land on exact halves
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, s = quantize_int8(x)
    rq, _ = ref_compress.quantize_int8(jnp.asarray(x.numpy()))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]
    assert q.tolist() == np.asarray(rq).tolist()


def test_quantize_int8_zero_row():
    q, scale = quantize_int8(torch.zeros((4, 8)))
    assert (dequantize_int8(q, scale) == 0).all()


@pytest.mark.parametrize("k_frac", [0.1, 0.01, 0.5])
def test_topk_compress_equals_the_reference(k_frac):
    rng = np.random.default_rng(4)
    g = rng.standard_normal((64, 32)).astype(np.float32)
    res = rng.standard_normal((64, 32)).astype(np.float32)
    kept, err = topk_compress(torch.as_tensor(g), torch.as_tensor(res),
                              k_frac=k_frac)
    rk, re = ref_compress.topk_compress(jnp.asarray(g), jnp.asarray(res),
                                        k_frac=k_frac)
    assert_bytes_equal(kept.numpy(), np.asarray(rk), "kept")
    assert_bytes_equal(err.numpy(), np.asarray(re), "err")
    assert torch.equal(kept + err, torch.as_tensor(g) + torch.as_tensor(res))
    assert float((kept != 0).to(torch.float32).mean()) <= k_frac + 0.01
    k_np, e_np = kept.numpy(), err.numpy()
    if (k_np != 0).any() and (e_np != 0).any():
        assert np.abs(k_np[k_np != 0]).min() >= np.abs(e_np).max() - 1e-6


def test_topk_ties_go_to_the_lower_index():
    g = np.array([[1.0, -3.0, 3.0, 2.0], [3.0, 0.5, -3.0, 1.0]], np.float32)
    z = np.zeros_like(g)
    kept, err = topk_compress(torch.as_tensor(g), torch.as_tensor(z),
                              k_frac=0.25)
    rk, _ = ref_compress.topk_compress(jnp.asarray(g), jnp.asarray(z),
                                       k_frac=0.25)
    assert_bytes_equal(kept.numpy(), np.asarray(rk))
    assert kept.nonzero().tolist() == [[0, 1], [0, 2]]
    assert torch.equal(kept + err, torch.as_tensor(g))
