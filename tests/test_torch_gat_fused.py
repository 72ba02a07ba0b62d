"""GAT's fused executor on the CPU, where it runs the plain versions of the
``gat::`` kernels (``kernels/ref.py``) over an attention plan
(``exec/gat.py``).

* The plan's lists (``core.blocksparse.attention_lists``) hold every valid
  edge once, duplicates twice, and one self loop a node where asked; the
  transposed lists hold the same edges, and each entry's forward place
  names its own edge.  Byte-exact.
* The published inductive geometry (3 layers, 4 heads concatenated, a
  skip, 6 heads averaged, self loops) on a graph with a hub (a row of more
  than 512 entries), an isolated node and duplicate edges, with a masked
  loss: the fused loss and every gradient equal the segment path's, and
  the benchmark's plain reference's (``h100bench/reference/gat_full.py``,
  here with blocks small enough to cut the graph into many).
* gat-cora's defaults (2 layers, one final head, no skip, no self loops,
  the edges as given, with and without an edge mask) through the fused
  executor equal the JAX reference's ``gat_loss`` and its gradients.
* The fused executor refuses a plan of the other self-loop setting, no
  plan and a mesh; the bundle and launcher take it for GAT.
* Spans: ``exec.gat.plan`` in the plan build, ``exec.gat.layer`` a layer
  with ``layer``, ``heads`` and ``width``, ``exec.gat.layer.backward``
  under ``train.backward``.

Tolerance: 1e-5 (the port's bar) of the largest entry of each compared
array.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp
from repro.graph import DatasetSpec as RefSpec
from repro.graph import synthesize as ref_synthesize
from repro.models import gat as ref_gat
from repro_torch import obs
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.core.blocksparse import attention_lists
from repro_torch.exec.gat import AttentionPlan, build_attention_plan
from repro_torch.graph import Graph
from repro_torch.kernels.spmm_blockell import HUB_ENTRIES
from repro_torch.models.gat import gat_init, gat_loss
from repro_torch.train import adam, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)
from h100bench.reference import gat_full as bench_ref  # noqa: E402

TOL = 1e-5


def _close(got, ref, what, tol=TOL):
    got, ref = (t.detach().double() if torch.is_tensor(t) else
                torch.tensor(np.array(t), dtype=torch.float64)
                for t in (got, ref))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30)
    assert err <= tol * scale, f"{what}: {err} of {scale}"


def _hub_graph(n=900, e=6000, seed=0):
    """Random edges, 40 of them twice, a row (3) of 700 in-neighbours, a
    source (8) of 600 out-neighbours, node 13 with no edge."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), rng.choice(n, 700, False),
                          np.full(600, 8)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(700, 3),
                          rng.choice(n, 600, False)])
    src, dst = np.concatenate([src, src[:40]]), np.concatenate([dst,
                                                                dst[:40]])
    keep = (src != 13) & (dst != 13)
    return Graph(src=src[keep].astype(np.int32),
                 dst=dst[keep].astype(np.int32), num_nodes=n)


# ------------------------------------------------------------------ lists
@pytest.mark.parametrize("self_loops", [True, False])
def test_attention_lists_hold_every_edge_and_a_self_loop(self_loops):
    g = _hub_graph()
    mask = np.random.default_rng(5).random(g.num_edges) < 0.9
    g = Graph(src=g.src, dst=g.dst, num_nodes=g.num_nodes, edge_mask=mask)
    al = attention_lists(g, self_loops=self_loops)
    src, dst = g.src[mask].astype(np.int64), g.dst[mask].astype(np.int64)
    if self_loops:
        loops = np.arange(g.num_nodes)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    n = g.num_nodes
    rows = np.repeat(np.arange(n), np.diff(al.row_ptr))
    assert np.array_equal(np.sort(rows * n + al.src), np.sort(dst * n + src))
    cols = np.repeat(np.arange(n), np.diff(al.row_ptr_t))
    assert np.array_equal(np.sort(cols * n + al.dst_t),
                          np.sort(src * n + dst))
    # sources ascending in a row, rows ascending in a transposed row
    assert np.all(np.diff(rows * n + al.src) >= 0)
    assert np.all(np.diff(cols * n + al.dst_t) >= 0)
    # a transposed entry's forward place holds the same edge
    assert np.array_equal(al.src[al.fwd_pos], cols)
    assert np.array_equal(rows[al.fwd_pos], al.dst_t)
    assert np.array_equal(np.sort(al.fwd_pos), np.arange(al.nnz))
    assert al.row_ptr.dtype == al.src.dtype == al.fwd_pos.dtype == np.int32


def test_plan_carries_hubs_both_ways():
    plan = build_attention_plan(_hub_graph(), device="cpu")
    d = plan.describe()
    assert d["hubs"] == 1 and d["hubs_t"] == 1
    assert np.diff(plan.fwd["row_ptr"].numpy()).max() > HUB_ENTRIES
    assert plan.nnz == _hub_graph().num_edges + 900


@pytest.mark.parametrize("values", [2 ** 11, 2 ** 30])
def test_smoke_blocked_plain_versions_match_the_plain_versions(monkeypatch,
                                                               values):
    """``chip_smoke.py``'s plain versions by blocks of rows (its yardstick
    at the benchmark cell's size) equal the plain versions over the whole
    lists, the graph cut into many blocks (a hub alone in one) or one."""
    from repro_torch.kernels.ref import (gat_attention_bwd_ref,
                                         gat_attention_ref)
    from repro_torch.kernels.spmm_blockell import Lists

    monkeypatch.setattr(chip_smoke, "GAT_BLOCK_VALUES", values)
    plan = build_attention_plan(_hub_graph(), device="cpu")
    fwd, bwd = Lists.of(plan.fwd), Lists.of(plan.bwd)
    n, H, F = plan.num_nodes, 2, 8
    blocks = chip_smoke.gat_row_blocks(torch, fwd.row_ptr, H * F)
    assert (len(blocks) == 1) == (values >= plan.nnz * H * F)
    gen = torch.Generator().manual_seed(2)
    z, s_src, s_dst, dout = (torch.randn(*s, generator=gen).double()
                             for s in ((n, H, F), (n, H), (n, H), (n, H, F)))
    out, lse = gat_attention_ref(fwd.row_ptr, fwd.src, z, s_src, s_dst,
                                 negative_slope=0.2)
    row_dot = torch.sum(dout * out, dim=-1)
    want = (out, lse) + gat_attention_bwd_ref(
        fwd.row_ptr, bwd.row_ptr, bwd.src, plan.bwd["fwd_pos"], z, s_src,
        s_dst, lse, row_dot, dout, negative_slope=0.2)
    got = chip_smoke.gat_plain_fwd(torch, fwd, z, s_src, s_dst)
    got += chip_smoke.gat_plain_bwd(torch, bwd, z, s_src, s_dst, lse,
                                    row_dot, dout)
    for a, b, what in zip(got, want, ("out", "lse", "dz", "ds_src",
                                      "ds_dst")):
        _close(a, b, what)


# ------------------------------------------------------------ the model
def _inputs(g, d_in=12, classes=5, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(g.num_nodes, d_in, generator=gen)
    labels = torch.randint(0, classes, (g.num_nodes,), generator=gen)
    mask = torch.rand(g.num_nodes, generator=gen) < 0.6
    graph = {"src": torch.as_tensor(g.src).long(),
             "dst": torch.as_tensor(g.dst).long()}
    return x, labels, mask, graph


def _leaves(params):
    return [t for lay in params["layers"]
            for t in (lay["w"]["w"], lay["a_src"], lay["a_dst"])]


def _loss_and_grads(params, fn):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in _leaves(params)]
    tree = {"layers": [{"w": {"w": leaves[i]}, "a_src": leaves[i + 1],
                        "a_dst": leaves[i + 2]}
                       for i in range(0, len(leaves), 3)]}
    loss = fn(tree)
    return loss, torch.autograd.grad(loss, leaves)


def test_published_geometry_matches_segment_path_and_reference():
    g = _hub_graph()
    x, labels, mask, graph = _inputs(g)
    params = gat_init(torch.Generator().manual_seed(2), 12, 8, 4, 5, 3,
                      device="cpu", out_heads=6)
    assert [tuple(lay["a_src"].shape) for lay in params["layers"]] == [
        (4, 8), (4, 8), (6, 5)]
    plan = build_attention_plan(g, self_loops=True, device="cpu")
    kw = {"skip": True, "self_loops": True}
    fused, g_fused = _loss_and_grads(params, lambda p: gat_loss(
        p, x, None, labels, mask, executor="fused", plan=plan, **kw))
    seg, g_seg = _loss_and_grads(params, lambda p: gat_loss(
        p, x, graph, labels, mask, **kw))
    _close(fused, seg, "loss")
    for i, (a, b) in enumerate(zip(g_fused, g_seg)):
        _close(a, b, f"gradient {i}")

    old = bench_ref.EDGE_BLOCK_BYTES
    bench_ref.EDGE_BLOCK_BYTES = 4 * 32 * 600     # many blocks a layer
    try:
        rg = bench_ref.Graph(g.src, g.dst, g.num_nodes, torch.device("cpu"))
        assert len(rg.blocks(32)) > 10
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in _leaves(params)]
        layers = [dict(zip(("w", "a_src", "a_dst"), leaves[i:i + 3]))
                  for i in range(0, len(leaves), 3)]
        ref = bench_ref.forward_loss(
            layers, rg, x, labels, mask,
            bench_ref._Products("fp32", torch.device("cpu")), True, 0.2)
        g_ref = torch.autograd.grad(ref, leaves)
    finally:
        bench_ref.EDGE_BLOCK_BYTES = old
    _close(fused, ref, "loss against the benchmark's reference")
    for i, (a, b) in enumerate(zip(g_fused, g_ref)):
        _close(a, b, f"gradient {i} against the benchmark's reference")


def test_fused_training_steps_match_segment_path():
    """Three donated steps of adam(5e-3), clip 1.0: the same losses."""
    g = _hub_graph()
    x, labels, mask, graph = _inputs(g)
    plan = build_attention_plan(g, self_loops=True, device="cpu")
    kw = {"skip": True, "self_loops": True}
    runs = []
    for fused in (True, False):
        params = gat_init(torch.Generator().manual_seed(2), 12, 8, 4, 5, 3,
                          device="cpu", out_heads=6)
        opt = adam(5e-3)
        state = opt.init(params)
        if fused:
            fn = lambda p, b: gat_loss(p, x, None, labels, mask,
                                       executor="fused", plan=plan, **kw)
        else:
            fn = lambda p, b: gat_loss(p, x, graph, labels, mask, **kw)
        step = make_train_step(fn, opt, clip_norm=1.0)
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state, None)
            losses.append(float(loss))
        runs.append(losses)
    np.testing.assert_allclose(runs[0], runs[1], rtol=TOL, atol=0)


@pytest.mark.parametrize("masked", [False, True],
                         ids=["all-edges", "masked"])
def test_gat_cora_defaults_through_fused_match_jax(masked):
    from repro.configs.gat_cora import REDUCED as R
    rg = ref_synthesize(RefSpec("zoo", 300, 1500, 32, 4, seed=0))
    emask = np.random.default_rng(1).random(rg.num_edges) < 0.8
    ref_graph = {"src": jnp.asarray(rg.src), "dst": jnp.asarray(rg.dst)}
    g = Graph(src=rg.src, dst=rg.dst, num_nodes=rg.num_nodes,
              edge_mask=emask if masked else None)
    if masked:
        ref_graph["edge_mask"] = jnp.asarray(emask)
    key = jax.random.PRNGKey(0)
    ref_params = ref_gat.gat_init(key, 32, R["d_hidden"], R["n_heads"],
                                  R["classes"], R["n_layers"])
    x = rg.node_feat
    labels = (rg.labels % R["classes"]).astype(np.int32)
    ref_loss, ref_grads = jax.value_and_grad(ref_gat.gat_loss)(
        ref_params, jnp.asarray(x), ref_graph, jnp.asarray(labels),
        jnp.asarray(rg.train_mask))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             device="cpu")
    plan = build_attention_plan(g, self_loops=False, device="cpu")
    loss, grads = _loss_and_grads(params, lambda p: gat_loss(
        p, torch.as_tensor(x), None, torch.as_tensor(labels),
        torch.as_tensor(rg.train_mask), executor="fused", plan=plan))
    _close(loss, np.asarray(ref_loss), "loss")
    want = [np.asarray(t) for lay in ref_grads["layers"]
            for t in (lay["w"]["w"], lay["a_src"], lay["a_dst"])]
    for i, (a, b) in enumerate(zip(grads, want)):
        _close(a, b, f"gradient {i}")


def test_fused_executor_refusals():
    g = _hub_graph()
    x, labels, mask, graph = _inputs(g)
    params = gat_init(torch.Generator().manual_seed(2), 12, 8, 4, 5, 2,
                      device="cpu")
    plan = build_attention_plan(g, self_loops=True, device="cpu")
    with pytest.raises(ValueError, match="self_loops"):
        gat_loss(params, x, None, labels, mask, executor="fused", plan=plan)
    with pytest.raises(ValueError, match="attention plan"):
        gat_loss(params, x, None, labels, mask, executor="fused")
    with pytest.raises(ValueError, match="one device"):
        gat_loss(params, x, None, labels, mask, executor="fused", plan=plan,
                 self_loops=True, mesh=object())
    with pytest.raises(ValueError, match="unknown GAT executor"):
        gat_loss(params, x, graph, labels, mask, executor="blockell")


def test_bundle_takes_an_attention_plan_for_gat():
    bundle = get("gat-reddit").bundle()
    assert bundle.model_kw["skip"] and bundle.model_kw["self_loops"]
    assert bundle.n_classes == 6
    params = bundle.init_params(torch.Generator().manual_seed(0), 12,
                                device="cpu")
    assert [tuple(lay["a_src"].shape) for lay in params["layers"]] == [
        (4, 256), (4, 256), (6, 6)]
    g = _hub_graph(e=2000)
    plan = build_attention_plan(g, self_loops=True, device="cpu")
    assert isinstance(plan, AttentionPlan)
    loss_fn = bundle.loss_fn("full_graph_sm", executor="fused",
                             exec_plan=plan)
    x, labels, mask, graph = _inputs(g)
    batch = {**graph, "edge_mask": None, "deg": None, "x": x,
             "labels": labels, "train_mask": mask}
    seg_fn = bundle.loss_fn("full_graph_sm")
    _close(loss_fn(params, batch), seg_fn(params, batch), "loss")
    for executor in ("forward", "blockell"):
        with pytest.raises(ValueError, match="no kernel executor"):
            bundle.loss_fn("full_graph_sm", executor=executor,
                           exec_plan=plan)


def test_spans_of_the_fused_layers():
    g = _hub_graph(e=2000)
    x, labels, mask, _ = _inputs(g)
    params = gat_init(torch.Generator().manual_seed(2), 12, 8, 4, 5, 3,
                      device="cpu", out_heads=6)
    obs.stop_trace()
    with profile(activities=[ProfilerActivity.CPU]):
        plan = build_attention_plan(g, self_loops=True, device="cpu")
        opt = adam(5e-3)
        step = make_train_step(lambda p, b: gat_loss(
            p, x, None, labels, mask, executor="fused", plan=plan,
            skip=True, self_loops=True), opt, clip_norm=1.0)
        params, _, loss = step(params, opt.init(params), None)
        float(loss)
    spans = obs.profiled_spans().spans
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    assert len(by_name["exec.gat.plan"]) == 1
    plan_id = by_name["exec.gat.plan"][0].id
    assert {sp.args["parent"] for sp in by_name["exec.plan.tiles"]} == {
        plan_id}
    layers = by_name["exec.gat.layer"]
    assert [(sp.args["layer"], sp.args["heads"], sp.args["width"])
            for sp in layers] == [(0, 4, 8), (1, 4, 8), (2, 6, 5)]
    fwd = by_name["train.forward"][0].id
    assert {sp.args["parent"] for sp in layers} == {fwd}
    back = by_name["exec.gat.layer.backward"]
    assert sorted(sp.args["layer"] for sp in back) == [0, 1, 2]
    assert {sp.args["parent"] for sp in back} == {
        by_name["train.backward"][0].id}
