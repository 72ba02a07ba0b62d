"""Per-row entry lists (``core.blocksparse.row_lists``) and the plans that
hold them, on the CPU (no jax, no card).

The lists built from the edges equal, byte for byte, the lists a walk over
``BlockEll.compact()``'s tiles makes (slot, then k), on a ragged last block,
destination blocks with no slot, rows of more than 512 entries, both
directions and weighted ``sum`` plans with coefficients.  The plan holds
lists where they are fewer bytes than the tiles and tiles elsewhere,
builds no ``BlockEll`` for a list plan, counts each direction on
``exec.plan.directions``, and its plain list version computes what the
plain tile version does, in every mode: 1e-5 of the largest entry (fp32
sums in another order).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.blocksparse import (build_blockell, row_lists,
                                          transpose_graph)
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.exec.plan import _diag_fallback, _layer_fallback
from repro_torch.graph import Graph
from repro_torch.graph.datasets import citeseer_s_like
from repro_torch.kernels import spmm_blockell as sk
from repro_torch.kernels.ref import (spmm_blockell_compact_ref,
                                     spmm_blockell_lists_ref,
                                     spmm_blockell_update_compact_ref,
                                     spmm_blockell_update_lists_ref)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

TOL = 1e-5


def _graph(kind: str) -> Graph:
    rng = np.random.default_rng(3)
    n, e = 1000, 6000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = None
    if kind == "empty_blocks":          # only destinations below 200
        dst = rng.integers(0, 200, e)
    elif kind == "hub":                  # row 17 and column 900: 700 each
        src = np.concatenate([src, rng.choice(n, 700, False), np.full(700,
                                                                     900)])
        dst = np.concatenate([dst, np.full(700, 17), rng.choice(n, 700,
                                                                False)])
    elif kind == "weighted":             # duplicates, and sums of zero
        src = np.concatenate([src, src[:300], src[300:400]])
        dst = np.concatenate([dst, dst[:300], dst[300:400]])
        w = rng.uniform(-1, 1, src.size).astype(np.float32)
        w[e + 300:] = -w[300:400]
    if kind != "weighted":               # no duplicates: the 0/1 bitmask
        _, first = np.unique(dst * n + src, return_index=True)
        src, dst = src[np.sort(first)], dst[np.sort(first)]
    mask = rng.random(src.size) < 0.7 if kind == "masked" else None
    return Graph(src=src.astype(np.int32), dst=dst.astype(np.int32),
                 num_nodes=n, edge_weight=w, edge_mask=mask)


def _lists_off_tiles(g: Graph, bm: int):
    """The lists a walk over the compacted tiles makes: per destination
    row, its slots in order, in each the set entries by k."""
    ell = build_blockell(g, bm=bm, bk=bm, storage="auto")
    comp = ell.compact(np.uint8 if ell.implicit else np.float32)
    s, m, k = np.nonzero(comp.blocks)
    row = comp.rows[s].astype(np.int64) * bm + m
    order = np.argsort(row, kind="stable")        # (s, k) kept per row
    row, s, k = row[order], s[order], k[order]
    ptr = np.zeros(g.num_nodes + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=g.num_nodes), out=ptr[1:])
    src = comp.cols[s].astype(np.int64) * bm + k
    coef = None if ell.implicit else comp.blocks[s, m[order], k]
    return ptr.astype(np.int32), src.astype(np.int32), coef, comp.n_active


@pytest.mark.parametrize("bm", [64, 128])        # 1000 rows: ragged blocks
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("kind", ["random", "empty_blocks", "hub",
                                  "weighted", "masked"])
def test_lists_equal_the_tiles_read_in_walk_order(kind, transposed, bm):
    g = _graph(kind)
    if transposed:
        g = transpose_graph(g)
    got = row_lists(g, bm=bm, bk=bm)
    ptr, src, coef, n_active = _lists_off_tiles(g, bm)
    assert got.row_ptr.dtype == got.src.dtype == np.int32
    assert got.row_ptr.tobytes() == ptr.tobytes()
    assert got.src.tobytes() == src.tobytes()
    assert (got.coef is None) == (coef is None) == (kind != "weighted")
    if coef is not None:
        assert got.coef.dtype == np.float32
        assert got.coef.tobytes() == coef.tobytes()
    assert got.n_active == n_active
    if kind == "hub":
        assert int(np.diff(got.row_ptr).max()) > 512
    if kind == "empty_blocks" and not transposed:      # rows 200 and up
        assert not np.diff(got.row_ptr)[200:].any()


def _tile_plan_graph() -> Graph:
    """Two 128-node blocks, each row holding half its block's columns:
    tiles half full, above the lists' 1/4."""
    rng = np.random.default_rng(0)
    dst, src = np.nonzero(rng.random((256, 256)) < 0.5)
    return Graph(src=src.astype(np.int32), dst=dst.astype(np.int32),
                 num_nodes=256)


def _directions():
    c = obs.snapshot()["counters"]
    return tuple(sum(v for k, v in c.items()
                     if k.startswith("exec.plan.directions")
                     and f"form={form}" in k.replace('"', ""))
                 for form in ("list", "tiles"))


def test_fill_rule_picks_tiles_when_dense_and_lists_when_sparse():
    dense = build_plan(_tile_plan_graph(), "gcn", bm=128, backend="cuda",
                       device="cpu")
    assert not dense.meta_fwd.lists and not dense.meta_bwd.lists
    assert dense._fwd["blocks"].dtype == torch.uint8
    g = citeseer_s_like(0.01)
    lists = row_lists(g, bm=128, bk=128)
    assert lists.nbytes() * 10 < lists.tile_bytes(128, 128)
    sparse = build_plan(g, "gcn", bm=128, backend="cuda", device="cpu")
    assert sparse.meta_fwd.lists and sparse.meta_bwd.lists
    assert set(sparse._fwd) == {"s_in", "s_out", "row_ptr", "src", "hubs"}
    # float32 tiles keep the lists below a fill of 1/2
    w = dataclasses.replace(g, edge_weight=np.full(g.num_edges, 0.5,
                                                   np.float32))
    weighted = build_plan(w, "sum", bm=128, backend="cuda", weighted=True,
                          device="cpu")
    assert weighted.meta_fwd.lists and "coef" in weighted._fwd


def test_list_plan_builds_no_blockell():
    g = citeseer_s_like(0.01)
    p = build_plan(g, "gcn", bm=128, backend="cuda", device="cpu")
    assert p._ell is None and p._ell_t is None
    ell = build_blockell(g, bm=128, bk=128, storage="auto")
    assert p.n_active == p.grid_size == ell.n_active
    assert p.meta_bwd.n_active == build_blockell(
        transpose_graph(g), bm=128, bk=128, storage="auto").n_active
    assert p._ell is None                  # still: the metadata answered
    assert p.ell.n_active == ell.n_active  # built on request


def test_each_direction_counts_once():
    g = citeseer_s_like(0.005)
    before = _directions()
    build_plan(g, "gcn", bm=128, backend="cuda", device="cpu")
    assert _directions() == (before[0] + 2, before[1])
    build_plan(g, "gcn", bm=128, backend="cuda", compact=False, device="cpu")
    build_plan(g, "gcn", bm=128, backend="torch", device="cpu")
    build_plan(g, "gcn", backend="cuda", buckets="128@7+256", device="cpu")
    assert _directions() == (before[0] + 2, before[1] + 6)
    build_plan(g, "gcn", backend="coo", device="cpu")      # no block form
    assert _directions() == (before[0] + 2, before[1] + 6)


def _close(got, want, what):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=TOL * scale, rtol=0,
                               msg=what)


@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("mode,kind", [("gcn", "random"), ("sum", "hub"),
                                       ("mean", "empty_blocks"),
                                       ("sum", "weighted"),
                                       ("gcn", "masked")])
def test_plain_list_version_matches_plain_tile_version(mode, kind,
                                                       transposed):
    g = _graph(kind)
    weighted = kind == "weighted"
    p = build_plan(g, mode, bm=64, backend="cuda", weighted=weighted,
                   device="cpu")
    assert p.meta_fwd.lists
    a = p._bwd if transposed else p._fwd
    t = chip_smoke.tile_arrays(p, transposed)
    lists = (a["row_ptr"], a["src"], a.get("coef"))
    # the rows of more than 512 entries, which the card sums apart
    hubs = np.flatnonzero(np.diff(a["row_ptr"].numpy()) > 512)
    assert (kind == "hub") == bool(hubs.size)
    assert np.array_equal(a["hubs"].numpy(), hubs)
    x = torch.randn(g.num_nodes, 24, generator=torch.Generator().manual_seed(1))
    kw = dict(add_diag=p.add_diag)
    tile = spmm_blockell_compact_ref(t["row_offsets"], t["cols"],
                                     t["blocks"], x, t["s_in"], t["s_out"],
                                     bm=64, bk=64, **kw)
    rows = t["node_active"][:, None]
    want = torch.where(rows, tile, _diag_fallback(p.add_diag, t, x))
    _close(spmm_blockell_lists_ref(*lists, x, a["s_in"], a["s_out"], **kw),
           want, "aggregation")
    # the layer: every epilogue term on
    w = torch.randn(24, 8, generator=torch.Generator().manual_seed(2))
    ws = torch.randn(24, 8, generator=torch.Generator().manual_seed(3))
    b, c = torch.randn(8), torch.tensor(1.5)
    tile = spmm_blockell_update_compact_ref(
        t["row_offsets"], t["cols"], t["blocks"], x, t["s_in"], t["s_out"],
        w, b, ws, c, bm=64, bk=64, relu=True, **kw)
    want = torch.where(rows, tile, _layer_fallback(p.add_diag, t, x, w, b,
                                                   True, ws, c))
    _close(spmm_blockell_update_lists_ref(*lists, x, a["s_in"], a["s_out"],
                                          w, b, ws, c, relu=True, **kw),
           want, "layer")


@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
def test_list_plan_matches_tile_plan_values_and_grads(mode):
    """A list plan on the ``cuda`` backend (its plain version on the CPU)
    against the ``torch`` backend's tile plan: the aggregation and a fused
    layer, forward and backward."""
    g = citeseer_s_like(0.005)
    n = g.num_nodes
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(n, 16, generator=gen)
    w = torch.randn(16, 12, generator=gen)
    gy = torch.randn(n, 12, generator=gen)
    out = {}
    for backend in ("cuda", "torch"):
        lp = build_layer_plan(g, mode, d_in=16, d_out=12,
                              order="aggregate_first", bm=128,
                              backend=backend, device="cpu")
        assert lp.gplan.meta_fwd.lists == (backend == "cuda")
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = lp(xr, wr, relu=True)
        y.backward(gy)
        agg = lp.gplan(x)
        out[backend] = (y.detach(), xr.grad, wr.grad, agg)
    for got, want, what in zip(out["cuda"], out["torch"],
                               ("y", "dx", "dw", "aggregation")):
        _close(got, want, what)


def test_walk_schedule_sums_hubs_apart_and_starts_long_rows_first():
    """Rows of more than 512 entries are hubs; the rest are walked in
    blocks of 4 rows, longest row first once a row holds more than 64."""
    lens = [3, 1, 2, 1, 600, 5, 70, 0, 9, 100]
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    src = np.zeros(ptr[-1], np.int32)
    got = sk.list_arrays(ptr, src)
    assert got["row_ptr"] is ptr and got["src"] is src and "coef" not in got
    assert got["hubs"].dtype == got["order"].dtype == np.int32
    assert got["hubs"].tolist() == [4]
    assert got["order"].tolist() == [2, 1, 0]    # 100, 70 (the hub: 0), 3
    short = sk.list_arrays(np.arange(0, 41, 4, dtype=np.int32),
                           np.zeros(40, np.int32), np.ones(40, np.float32))
    assert set(short) == {"row_ptr", "src", "coef", "hubs"}
    assert short["hubs"].size == 0               # nothing long, no hub


def test_lists_cannot_leave_out_their_hubs():
    """The list walk sums a row of more than 512 entries only through the
    hubs it is given, so lists without them are refused: ``Lists`` has no
    default for ``hubs``, and the wrappers check it before any launch."""
    g = _graph("hub")
    p = build_plan(g, "sum", bm=64, backend="cuda", device="cpu")
    a = p._fwd
    lists = sk.Lists.of(a)
    assert lists.hubs.numel() > 0
    with pytest.raises(TypeError):
        sk.Lists(a["row_ptr"], a["src"])
    x = torch.randn(g.num_nodes, 8)
    w = torch.randn(8, 4)
    kw = dict(bm=64, bk=64, add_diag=False)
    with pytest.raises(ValueError, match="hubs"):
        sk.spmm_blockell_compact(None, None, None, x, a["s_in"], a["s_out"],
                                 lists=lists._replace(hubs=None), **kw)
    with pytest.raises(ValueError, match="hubs"):
        sk.spmm_blockell_update_compact(
            None, None, None, x, a["s_in"], a["s_out"], w,
            lists=lists._replace(hubs=None), **kw)
    # with them, the CPU's plain version runs
    assert sk.spmm_blockell_compact(None, None, None, x, a["s_in"],
                                    a["s_out"], lists=lists,
                                    **kw).shape == x.shape
