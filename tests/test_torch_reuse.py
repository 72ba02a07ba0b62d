"""The port's reuse layer against the reference's (``repro/core``,
``repro/models``): the paper's reorders, shared-set (G-C) plans and
executor, hierarchical mapping and block-ELL aggregation, on the same numpy
inputs made from a seed.

* byte-equal arrays: every reorder of ``REORDERINGS`` but ``index`` (and
  ``bfs_reorder`` against its per-node-queue twin), ``build_shared_plan`` at
  levels 1, 2 and 4 on Cora, the community graph and CITESEER-S at scale
  0.005 (raw and MinHash-reordered), a hypothesis property over random
  graphs, ``window_partition``, ``map_graph_level``, ``map_node_level``,
  ``pe_edge_lists`` and the two ``Graph`` methods this layer adds;
* exact equality: the plans' counters, ``mean_reuse_distance`` and
  ``bandwidth``;
* 1e-5 of the largest entry (fp32 sums in another order):
  ``segment_aggregate`` (four ops, with edge weights and masks),
  ``shared_aggregate`` (four ops x levels 1, 2, 4), ``blockell_aggregate``'s
  plain path and its gradient, and ``gcn_apply`` (``"shared"``,
  ``"blockell"`` with a ``BlockEll``), ``sage_apply`` and ``gin_apply``
  (``"shared"``) with their gradients, on the reference's weights carried
  over by ``params_from_jax``;
* 1e-4: 10 ``fit`` losses of gcn-cora under ``"shared"``;
* ``transpose_blockell`` as a matrix against the block-ELL of the
  transposed graph;
* ``examples/quickstart_torch.py --device cpu`` prints the reference
  quickstart's numbers.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _ht import given, settings, st
from repro.core import aggregate as ref_agg
from repro.core import blocksparse as ref_bs
from repro.core import mapping as ref_mapping
from repro.core import reorder as ref_reorder
from repro.core import shared_set as ref_shared
from repro.graph import Graph as RefGraph
from repro.graph import citeseer_s_like as ref_citeseer_s_like
from repro.graph import partition as ref_partition
from repro.models import gcn as ref_gcn
from repro.models import sage_gin as ref_sage_gin
from repro.train import adam as ref_adam
from repro.train import fit as ref_fit
from repro_torch.convert import params_from_jax
from repro_torch.core import (REORDERINGS, blockell_aggregate,
                              build_blockell, build_shared_plan, mapping,
                              reorder, segment_aggregate, shared_aggregate,
                              transpose_blockell, transpose_graph)
from repro_torch.graph import partition
from repro_torch.models import gcn as port_gcn
from repro_torch.models import sage_gin as port_sage_gin
from repro_torch.train import adam, fit

from _torch_parity import GRAPHS, assert_bytes_equal, to_port

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _close(got, ref, what, tol=TOL):
    """|got - ref| <= tol * max(1, max|ref|) entrywise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max(
                                   initial=0.0))), err_msg=what)


def _masked(g: RefGraph, seed=3) -> RefGraph:
    """``g`` with every fourth-ish edge masked out."""
    rng = np.random.default_rng(seed)
    return dataclasses.replace(g, edge_mask=rng.random(g.num_edges) < 0.75)


@functools.lru_cache(maxsize=None)
def _citeseer():
    return ref_citeseer_s_like(scale=0.005)


def _graph(request, name: str) -> RefGraph:
    """``cora`` / ``community_graph`` (the reference's fixtures),
    ``citeseer`` (CITESEER-S at 0.005) or a structural graph of
    ``_torch_parity``; ``+minhash`` reorders it, ``+mask`` masks edges."""
    base, *mods = name.split("+")
    if base == "citeseer":
        g = _citeseer()
    elif base in GRAPHS:
        g = GRAPHS[base]
    else:
        g = request.getfixturevalue(base)
    for m in mods:
        g = g.permute(ref_reorder.minhash_reorder(g)) if m == "minhash" \
            else _masked(g)
    return g


# --------------------------------------------------------------- graph
@pytest.mark.parametrize("name", ["cora", "skewed", "random+mask"])
def test_graph_methods_byte_equal(request, name):
    g = _graph(request, name)
    pg = to_port(g)
    assert_bytes_equal(pg.out_degrees(), g.out_degrees(), "out_degrees")
    for f in dataclasses.fields(RefGraph):
        assert_bytes_equal(getattr(pg.with_sym_norm(), f.name),
                           getattr(g.with_sym_norm(), f.name), f.name)


# ------------------------------------------------------------- reorders
REORDER_GRAPHS = ["cora", "community_graph", "skewed", "empty_rows",
                  "random+mask"]


def test_reorderings_cover_the_reference():
    assert set(REORDERINGS) == set(ref_reorder.REORDERINGS)


@pytest.mark.parametrize("name", REORDER_GRAPHS)
@pytest.mark.parametrize("order", ["lsh", "minhash", "degree", "bfs"])
def test_reorder_byte_equal(request, order, name):
    g = _graph(request, name)
    assert_bytes_equal(REORDERINGS[order](to_port(g)),
                       ref_reorder.REORDERINGS[order](g), order)


@pytest.mark.parametrize("kw", [dict(num_bits=8, seed=3),
                                dict(tiebreak_degree=False)])
def test_lsh_reorder_options_byte_equal(cora, kw):
    assert_bytes_equal(reorder.lsh_reorder(to_port(cora), **kw),
                       ref_reorder.lsh_reorder(cora, **kw), str(kw))


@pytest.mark.parametrize("name", REORDER_GRAPHS)
@pytest.mark.parametrize("start", [None, 5])
def test_bfs_matches_its_queue_twin(request, name, start):
    g = to_port(_graph(request, name))
    queue = reorder._bfs_reorder_queue(g, start)
    assert_bytes_equal(reorder.bfs_reorder(g, start), queue, "bfs")
    assert_bytes_equal(queue, ref_reorder._bfs_reorder_queue(
        _graph(request, name), start), "queue")


@pytest.mark.parametrize("name", ["cora", "cora+minhash", "community_graph",
                                  "random+mask"])
def test_reorder_metrics_equal(request, name):
    g = _graph(request, name)
    pg = to_port(g)
    for sample in (200_000, 3_000):
        assert reorder.mean_reuse_distance(pg, sample=sample) == \
            ref_reorder.mean_reuse_distance(g, sample=sample)
    assert reorder.bandwidth(pg) == ref_reorder.bandwidth(g)


# ------------------------------------------------------- shared-set plans
def _assert_plans_equal(port, ref):
    for f in ("residual_src", "residual_dst"):
        assert_bytes_equal(getattr(port, f), getattr(ref, f), f)
    assert port.num_levels == ref.num_levels
    for l in range(ref.num_levels):
        assert_bytes_equal(port.level_src[l], ref.level_src[l], f"src {l}")
        assert_bytes_equal(port.level_block[l], ref.level_block[l],
                           f"block {l}")
    for f in ("num_nodes", "original_edges", "shared_edges", "consume_adds",
              "effective_reductions", "reduction_ratio", "shared_fraction"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("levels", [1, 2, 4])
@pytest.mark.parametrize("name", ["cora", "cora+minhash", "community_graph",
                                  "community_graph+minhash", "citeseer",
                                  "citeseer+minhash", "random+mask"])
def test_shared_plan_byte_equal(request, name, levels):
    g = _graph(request, name)
    _assert_plans_equal(build_shared_plan(to_port(g), levels=levels),
                        ref_shared.build_shared_plan(g, levels=levels))


def test_shared_plan_on_reordered_cora_keeps_the_reference_finding(cora):
    """The reference's own numbers on its stand-in: 1,217 shared edges and
    a negative reduction ratio (more reductions than the index order)."""
    g = cora.permute(ref_reorder.minhash_reorder(cora))
    plan = build_shared_plan(to_port(g), levels=1)
    assert plan.shared_edges == 1217
    assert round(plan.shared_fraction, 4) == 0.2306
    assert round(plan.reduction_ratio, 4) == -0.0435


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 80), e=st.integers(0, 500), seed=st.integers(0, 999),
       levels=st.integers(1, 4))
def test_shared_plan_property(n, e, seed, levels):
    """For any graph the plan is the reference's, byte for byte, and its
    executor sums every row exactly as the segment executor does."""
    rng = np.random.default_rng(seed)
    g = RefGraph(src=rng.integers(0, n, e).astype(np.int32),
                 dst=rng.integers(0, n, e).astype(np.int32), num_nodes=n)
    plan = build_shared_plan(to_port(g), levels=levels)
    _assert_plans_equal(plan, ref_shared.build_shared_plan(g, levels=levels))
    x = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32))
    _close(shared_aggregate(x, plan, "sum"),
           segment_aggregate(x, torch.as_tensor(g.src),
                             torch.as_tensor(g.dst), n).numpy(), "sum")


# --------------------------------------------------------------- mapping
@pytest.mark.parametrize("n,parts", [(2708, 64), (100, 7), (5, 8), (64, 1)])
def test_window_partition_byte_equal(n, parts):
    p, r = partition.window_partition(n, parts), \
        ref_partition.window_partition(n, parts)
    assert_bytes_equal(p.boundaries, r.boundaries, "boundaries")
    assert p.num_parts == r.num_parts
    nodes = np.arange(n)
    assert_bytes_equal(p.part_of(nodes), r.part_of(nodes), "part_of")
    assert_bytes_equal(p.sizes(), r.sizes(), "sizes")


@pytest.mark.parametrize("name", ["cora+minhash", "random+mask"])
@pytest.mark.parametrize("pes", [1, 16, 64])
def test_graph_level_mapping_byte_equal(request, name, pes):
    g = _graph(request, name)
    pm, rm = mapping.map_graph_level(to_port(g), pes), \
        ref_mapping.map_graph_level(g, pes)
    assert (pm.window, pm.num_pes) == (rm.window, rm.num_pes)
    assert_bytes_equal(pm.parts.boundaries, rm.parts.boundaries, "parts")
    assert_bytes_equal(pm.pe_of(g.dst), rm.pe_of(g.dst), "pe_of")
    port_lists = mapping.pe_edge_lists(to_port(g), pm)
    ref_lists = ref_mapping.pe_edge_lists(g, rm)
    assert len(port_lists) == len(ref_lists) == pes
    for p, ((ps, pd), (rs, rd)) in enumerate(zip(port_lists, ref_lists)):
        assert_bytes_equal(ps, rs, f"pe {p} src")
        assert_bytes_equal(pd, rd, f"pe {p} dst")


@pytest.mark.parametrize("kw", [dict(d_in=1433, d_out=16),
                                dict(d_in=3, d_out=256, mac_rows=2,
                                     mac_cols=16, rf_bytes=512),
                                dict(d_in=1433, d_out=16, mxu=True),
                                dict(d_in=64, d_out=300, mxu=True)])
def test_node_level_mapping_equal(kw):
    p, r = mapping.map_node_level(**kw), ref_mapping.map_node_level(**kw)
    assert dataclasses.astuple(p) == dataclasses.astuple(r)
    assert p.flops(2708, kw["d_in"], kw["d_out"]) == \
        r.flops(2708, kw["d_in"], kw["d_out"])


# ----------------------------------------------------------- aggregation
def _inputs(g: RefGraph, d: int, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.num_nodes, d)).astype(np.float32),
            rng.uniform(0.1, 2.0, g.num_edges).astype(np.float32))


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("variant", ["plain", "weight", "mask", "both"])
@pytest.mark.parametrize("name", ["random", "empty_rows"])
def test_segment_aggregate_matches_reference(name, variant, op):
    g = _masked(GRAPHS[name])
    x, w = _inputs(g, 6)
    weight = w if variant in ("weight", "both") else None
    mask = g.edge_mask if variant in ("mask", "both") else None
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = ref_agg.segment_aggregate(j(x), j(g.src), j(g.dst), g.num_nodes,
                                    op, edge_weight=j(weight),
                                    edge_mask=j(mask))
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = segment_aggregate(t(x), t(g.src), t(g.dst), g.num_nodes, op,
                            edge_weight=t(weight), edge_mask=t(mask))
    _close(got, ref, f"{name} {variant} {op}")


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("levels", [1, 2, 4])
@pytest.mark.parametrize("name", ["community_graph+minhash", "empty_rows",
                                  "skewed"])
def test_shared_aggregate_matches_reference(request, name, levels, op):
    g = _graph(request, name)
    plan = build_shared_plan(to_port(g), levels=levels)
    x, _ = _inputs(g, 5)
    ref = ref_agg.shared_aggregate(
        jnp.asarray(x), ref_shared.build_shared_plan(g, levels=levels), op)
    _close(shared_aggregate(torch.as_tensor(x), plan, op), ref,
           f"{name} levels={levels} {op}")
    # and it is the segment executor's answer
    _close(shared_aggregate(torch.as_tensor(x), plan, op),
           segment_aggregate(torch.as_tensor(x), torch.as_tensor(g.src),
                             torch.as_tensor(g.dst), g.num_nodes,
                             op).numpy(), "vs segment")


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("levels", [1, 2])
def test_shared_aggregate_gradient_matches_reference(community_graph, levels,
                                                     op):
    g = community_graph.permute(ref_reorder.minhash_reorder(community_graph))
    x, _ = _inputs(g, 5)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    ref_plan = ref_shared.build_shared_plan(g, levels=levels)
    ref = jax.grad(lambda v: (ref_agg.shared_aggregate(v, ref_plan, op)
                              * w).sum())(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (shared_aggregate(xt, build_shared_plan(to_port(g), levels=levels), op)
     * torch.as_tensor(w)).sum().backward()
    _close(xt.grad, ref, f"grad levels={levels} {op}")


@pytest.mark.parametrize("storage", ["dense", "auto"])
@pytest.mark.parametrize("name,bm", [("random", 64), ("skewed", 128),
                                     ("empty_rows", 32)])
def test_blockell_aggregate_and_gradient_match_reference(name, bm, storage):
    g = GRAPHS[name].with_sym_norm() if storage == "dense" else GRAPHS[name]
    x, _ = _inputs(g, 9)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    ref_ell = ref_bs.build_blockell(g, bm=bm, bk=bm, storage=storage)
    ell = build_blockell(to_port(g), bm=bm, bk=bm, storage=storage)
    ref_y, ref_vjp = jax.vjp(lambda v: ref_agg.blockell_aggregate(ref_ell, v),
                             jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    y = blockell_aggregate(ell, xt)
    _close(y, ref_y, f"{name} y")
    (y * torch.as_tensor(w)).sum().backward()
    _close(xt.grad, ref_vjp(jnp.asarray(w))[0], f"{name} grad")


def _dense_matrix(ell) -> np.ndarray:
    R, W = ell.block_cols.shape
    C = -(-ell.num_nodes // ell.bk)
    a = np.zeros((R * ell.bm, C * ell.bk), np.float64)
    tiles = ell.dense_blocks(np.float32)
    for r, s in zip(*np.nonzero(ell.block_cols >= 0)):
        c = ell.block_cols[r, s]
        a[r * ell.bm:(r + 1) * ell.bm, c * ell.bk:(c + 1) * ell.bk] += \
            tiles[r, s]
    return a[:ell.num_nodes, :ell.num_nodes]


@pytest.mark.parametrize("storage", ["dense", "bitmask"])
@pytest.mark.parametrize("name,bm,bk", [("random", 64, 64),
                                        ("skewed", 128, 128),
                                        ("empty_rows", 32, 64)])
def test_transpose_blockell_is_the_transposed_matrix(name, bm, bk, storage):
    g = to_port(GRAPHS[name])
    if storage == "dense":
        g = g.with_sym_norm()
    else:                                   # the bitmask needs unique edges
        key = np.unique(g.dst.astype(np.int64) * g.num_nodes + g.src)
        g = dataclasses.replace(g, src=(key % g.num_nodes).astype(np.int32),
                                dst=(key // g.num_nodes).astype(np.int32))
    ell = build_blockell(g, bm=bm, bk=bk, storage=storage)
    ell_t = transpose_blockell(ell)
    assert (ell_t.bm, ell_t.bk, ell_t.implicit) == (bk, bm, ell.implicit)
    want = _dense_matrix(build_blockell(transpose_graph(g), bm=bk, bk=bm,
                                        storage=storage))
    np.testing.assert_array_equal(_dense_matrix(ell_t), want)
    np.testing.assert_array_equal(want, _dense_matrix(ell).T)
    for row in ell_t.block_cols:           # slots by ascending source block
        live = row[row >= 0]
        assert (np.diff(live) > 0).all() and (row[len(live):] == -1).all()


# ---------------------------------------------------------------- models
def _carry(tree):
    """The reference's params as leaf tensors that collect gradients."""
    return jax.tree_util.tree_map(
        lambda t: t.requires_grad_(),
        params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                        device="cpu"))


def _leaves(tree):
    """Leaves by sorted key and index, the same order on both sides."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _model_inputs(g, d_in, classes, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.num_nodes, d_in)).astype(np.float32),
            rng.integers(0, classes, g.num_nodes).astype(np.int32),
            rng.random(g.num_nodes) < 0.5)


def _hold_model(ref_loss, port_loss, ref_params, what):
    """Loss and every gradient within 1e-5 of the largest entry."""
    port_params = _carry(ref_params)
    ref_val, ref_grads = jax.value_and_grad(ref_loss)(ref_params)
    loss = port_loss(port_params)
    loss.backward()
    _close(loss, ref_val, f"{what} loss")
    for i, (p, r) in enumerate(zip(_leaves(port_params),
                                   _leaves(ref_grads))):
        _close(p.grad, r, f"{what} grad {i}")


@pytest.mark.parametrize("executor", ["shared", "blockell"])
def test_gcn_apply_matches_reference(community_graph, executor):
    g = community_graph.permute(ref_reorder.minhash_reorder(community_graph))
    pg = to_port(g)
    x, labels, mask = _model_inputs(g, 64, 4)
    dims = [64, 16, 4]
    ref_params = ref_gcn.gcn_init(jax.random.PRNGKey(0), dims)
    ref_graph = ref_gcn.make_graph_inputs(g)
    graph = port_gcn.make_graph_inputs(pg, device="cpu")
    if executor == "shared":
        ref_kw = dict(plan=ref_shared.build_shared_plan(g))
        plans = build_shared_plan(pg)
    else:
        ell = ref_bs.build_blockell(g, bm=128, bk=128)
        ref_kw = dict(ell={"block_cols": jnp.asarray(ell.block_cols),
                           "blocks": jnp.asarray(ell.dense_blocks()),
                           "bm": 128, "bk": 128})
        plans = build_blockell(pg, bm=128, bk=128)
    xt = torch.as_tensor(x)
    _close(port_gcn.gcn_apply(_carry(ref_params), xt, graph, executor,
                              plans),
           ref_gcn.gcn_apply(ref_params, jnp.asarray(x), ref_graph,
                             executor, **ref_kw), f"gcn {executor}")
    _hold_model(
        lambda p: ref_gcn.gcn_loss(p, jnp.asarray(x), ref_graph,
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   executor, **ref_kw),
        lambda p: port_gcn.gcn_loss(p, xt, graph, torch.as_tensor(labels),
                                    torch.as_tensor(mask), executor, plans),
        ref_params, f"gcn {executor}")


@pytest.mark.parametrize("levels", [1, 2])
def test_sage_and_gin_shared_match_reference(community_graph, levels):
    g = community_graph.permute(ref_reorder.minhash_reorder(community_graph))
    pg = to_port(g)
    x, labels, mask = _model_inputs(g, 64, 5)
    ref_plan = ref_shared.build_shared_plan(g, levels=levels)
    plan = build_shared_plan(pg, levels=levels)
    ref_graph = {"src": jnp.asarray(g.src), "dst": jnp.asarray(g.dst)}
    graph = {"src": torch.as_tensor(g.src.astype(np.int64)),
             "dst": torch.as_tensor(g.dst.astype(np.int64))}
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    lj, lt = jnp.asarray(labels), torch.as_tensor(labels)
    mj, mt = jnp.asarray(mask), torch.as_tensor(mask)
    key = jax.random.PRNGKey(1)

    sage = ref_sage_gin.sage_init(key, [64, 16, 5])
    _close(port_sage_gin.sage_apply(_carry(sage), xt, graph, "shared", plan),
           ref_sage_gin.sage_apply(sage, xj, ref_graph, "shared", ref_plan),
           "sage_apply")
    _hold_model(
        lambda p: ref_sage_gin.sage_loss(p, xj, ref_graph, lj, mj,
                                         executor="shared", plan=ref_plan),
        lambda p: port_sage_gin.sage_loss(p, xt, graph, lt, mt,
                                          executor="shared", plan=plan),
        sage, "sage")

    gin = ref_sage_gin.gin_init(key, 64, 16, 2, 5)
    _close(port_sage_gin.gin_apply(_carry(gin), xt, graph, "shared", plan),
           ref_sage_gin.gin_apply(gin, xj, ref_graph, "shared", ref_plan),
           "gin_apply")
    _hold_model(
        lambda p: ref_sage_gin.gin_loss(p, xj, ref_graph, lj, mj,
                                        executor="shared", plan=ref_plan),
        lambda p: port_sage_gin.gin_loss(p, xt, graph, lt, mt,
                                         executor="shared", plan=plan),
        gin, "gin")


def test_shared_without_a_plan_raises_where_the_reference_falls_back(cora):
    """A deliberate divergence: the reference runs its segment path when
    ``executor="shared"`` comes without a plan; the port raises."""
    x, _, _ = _model_inputs(cora, 8, 3)
    graph_j = {"src": jnp.asarray(cora.src), "dst": jnp.asarray(cora.dst)}
    sage = ref_sage_gin.sage_init(jax.random.PRNGKey(0), [8, 4])
    np.testing.assert_array_equal(
        np.asarray(ref_sage_gin.sage_apply(sage, jnp.asarray(x), graph_j,
                                           "shared", None)),
        np.asarray(ref_sage_gin.sage_apply(sage, jnp.asarray(x), graph_j)))
    graph = {"src": torch.as_tensor(cora.src.astype(np.int64)),
             "dst": torch.as_tensor(cora.dst.astype(np.int64))}
    params = _carry(sage)
    with pytest.raises(ValueError, match="SharedSetPlan"):
        port_sage_gin.sage_apply(params, torch.as_tensor(x), graph, "shared")
    with pytest.raises(ValueError, match="SharedSetPlan"):
        port_sage_gin.gin_apply(_carry(ref_sage_gin.gin_init(
            jax.random.PRNGKey(0), 8, 4, 1, 3)), torch.as_tensor(x), graph,
            "shared")
    with pytest.raises(ValueError, match="SharedSetPlan"):
        port_gcn.gcn_apply(_carry(ref_gcn.gcn_init(jax.random.PRNGKey(0),
                                                   [8, 3])),
                           torch.as_tensor(x),
                           port_gcn.make_graph_inputs(to_port(cora), "cpu"),
                           "shared")
    with pytest.raises(ValueError, match="nodes"):
        port_sage_gin.sage_apply(params, torch.as_tensor(x[:100]), graph,
                                 "shared", build_shared_plan(to_port(cora)))


def test_gcn_cora_shared_fit_matches_reference(cora):
    """gcn-cora [1433, 16, 7] on the reordered Cora under ``"shared"``: 10
    losses of ``fit`` with ``adam(1e-2)`` within 1e-4 (sums of up to 1433
    terms in another order, carried through 10 Adam steps)."""
    g = cora.permute(ref_reorder.minhash_reorder(cora))
    pg = to_port(g)
    ref_params = ref_gcn.gcn_init(jax.random.PRNGKey(0), [1433, 16, 7])
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             device="cpu")
    ref_plan, plan = ref_shared.build_shared_plan(g), build_shared_plan(pg)
    ref_graph = ref_gcn.make_graph_inputs(g)
    graph = port_gcn.make_graph_inputs(pg, device="cpu")
    ref_batch = {"x": jnp.asarray(g.node_feat), "y": jnp.asarray(g.labels),
                 "m": jnp.asarray(g.train_mask)}
    batch = {"x": torch.as_tensor(g.node_feat),
             "y": torch.as_tensor(g.labels.astype(np.int64)),
             "m": torch.as_tensor(g.train_mask)}
    ref = ref_fit(lambda p, b: ref_gcn.gcn_loss(
        p, b["x"], ref_graph, b["y"], b["m"], "shared", plan=ref_plan),
        ref_adam(1e-2), ref_params, iter(lambda: ref_batch, None), steps=10,
        log=lambda s: None)
    res = fit(lambda p, b: port_gcn.gcn_loss(
        p, b["x"], graph, b["y"], b["m"], "shared", plan),
        adam(1e-2), params, iter(lambda: batch, None), steps=10,
        log=lambda s: None)
    np.testing.assert_allclose(res.losses, ref.losses, atol=1e-4, rtol=1e-4)
    assert res.losses[-1] < res.losses[0]


# ------------------------------------------------------------ quickstart
def test_quickstart_prints_the_reference_numbers(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = module.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "graph: 2708 nodes, 10556 edges" in text
    assert ("off-chip traffic: index=56.0MB -> LR=43.4MB (22.5% eliminated)"
            in text)
    assert "1217 shared edges, -4.3% reductions eliminated" in text
    assert "CR executor exact: True" in text
    assert "block-ELL: 461 active blocks" in text
    assert (out["index"].feature_loads, out["lr"].feature_loads) == \
        (9778, 7578)
    assert out["losses"][-1] < out["losses"][0]
