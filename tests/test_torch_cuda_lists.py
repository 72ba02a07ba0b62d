"""The compact kernels' list walk on the card, against their tile walk on
the same plan: ``spmm_blockell_compact`` and ``spmm_blockell_update_compact``
given the plan's per-row entry lists (``lists=``) and given the tiles that
``chip_smoke.tile_arrays`` builds for the same plan.

On a graph whose rows hold at most 512 entries (the tile walk's list, one
gather) the two are bit-identical: the same entries in the same order,
dealt over the same lane groups.  Where a row holds more (a hub), the tile
walk gathers its list whenever it fills, and the two add the same products
in other groups: 1e-5, the port's bar, scaled by the largest entry.  A
rerun of the list walk is bit-identical, each launch counts on the
wrapper's ``launches``, and a plan's aggregations make no host sync.

Every test needs an NVIDIA GPU with nvcc; it is marked ``cuda`` and skips
without one.  No jax here (``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_lists.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.exec import build_plan
from repro_torch.exec.plan import _diag_fallback
from repro_torch.graph import Graph
from repro_torch.kernels import spmm_blockell as sk

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

pytestmark = pytest.mark.cuda
TOL = 1e-5
BM = 128


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _graph(hubs: bool, weighted: bool = False, n=4000, e=30000, seed=0):
    """Random edges plus two rows and two columns of 300 entries (the
    share rule's long lists inside 512), or of 1,500 with ``hubs``."""
    rng = np.random.default_rng(seed)
    k = 1500 if hubs else 300
    src = np.concatenate([rng.integers(0, n, e), rng.choice(n, k, False),
                          rng.choice(n, k, False), np.full(k, 7),
                          np.full(k, 2050)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(k, 5),
                          np.full(k, 1029), rng.choice(n, k, False),
                          rng.choice(n, k, False)])
    w = None
    if weighted:                        # duplicate edges add up
        w = rng.uniform(-1, 1, src.size).astype(np.float32)
    else:                               # no duplicates: the 0/1 bitmask
        _, first = np.unique(dst * n + src, return_index=True)
        src, dst = src[np.sort(first)], dst[np.sort(first)]
    return Graph(src=src.astype(np.int32), dst=dst.astype(np.int32),
                 num_nodes=n, edge_weight=w)


def _plan(hubs, mode="gcn", weighted=False):
    g = _graph(hubs, weighted)
    p = build_plan(g, mode, bm=BM, backend="cuda", weighted=weighted,
                   device="cuda")
    assert p.meta_fwd.lists and p.meta_bwd.lists
    assert ("coef" in p._fwd) == weighted
    # the hub rows, of more than 512 entries, both ways
    assert (p._fwd["hubs"].numel() > 0) == (p._bwd["hubs"].numel() > 0) \
        == hubs
    return p


def _side(p, transposed):
    a = p._bwd if transposed else p._fwd
    return a, sk.Lists.of(a), chip_smoke.tile_arrays(p, transposed)


def _x(n, d, seed=1):
    return torch.randn(n, d, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))


def _same(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=TOL * scale, rtol=TOL)


@pytest.mark.parametrize("hubs", [False, True], ids=["rows512", "hubs"])
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("mode,weighted", [("gcn", False), ("mean", False),
                                           ("sum", True)])
@pytest.mark.parametrize("d", [16, 41, 64, 256])
def test_spmm_list_walk_matches_tile_walk(hubs, transposed, mode, weighted,
                                          d):
    _need_cuda()
    p = _plan(hubs, mode, weighted)
    a, lists, t = _side(p, transposed)
    x = _x(p.num_nodes, d)
    kw = dict(bm=BM, bk=BM, add_diag=p.add_diag)
    before = sk.spmm_blockell_compact.launches
    y = sk.spmm_blockell_compact(None, None, None, x, a["s_in"], a["s_out"],
                                 lists=lists, **kw)
    assert sk.spmm_blockell_compact.launches == before + 1
    tile = sk.spmm_blockell_compact(t["row_offsets"], t["cols"], t["blocks"],
                                    x, t["s_in"], t["s_out"], **kw)
    # the tile walk leaves rows of blocks with no slot to the plan's patch
    want = torch.where(t["node_active"][:, None], tile,
                       _diag_fallback(p.add_diag, t, x))
    _same(y, want, exact=not hubs)
    # no atomics: a rerun is bit-identical
    assert torch.equal(sk.spmm_blockell_compact(
        None, None, None, x, a["s_in"], a["s_out"], lists=lists, **kw), y)


# (mode, d_in, d_out, epilogue): GCN's fused layer 2 (16 -> 41), a narrow
# output strip (41 -> 16), SAGE's two W (256 -> 41, 64 -> 256: two output
# strips), GIN's w_self-is-w with a coefficient (128 -> 128)
UPDATE_CASES = [("gcn", 16, 41, "none"), ("gcn", 41, 16, "none"),
                ("mean", 256, 41, "two_w"), ("mean", 64, 256, "two_w"),
                ("sum", 128, 128, "self_coeff")]


@pytest.mark.parametrize("hubs", [False, True], ids=["rows512", "hubs"])
@pytest.mark.parametrize("mode,d_in,d_out,epilogue", UPDATE_CASES,
                         ids=[f"{m}-{a}-{b}-{e}" for m, a, b, e in
                              UPDATE_CASES])
def test_update_list_walk_matches_tile_walk(hubs, mode, d_in, d_out,
                                            epilogue):
    _need_cuda()
    p = _plan(hubs, mode)
    a, lists, t = _side(p, False)
    n = p.num_nodes
    x = _x(n, d_in)
    w = _x(d_in, d_out, 2) / d_in ** 0.5
    b = _x(1, d_out, 3)[0]
    ws = c = None
    if epilogue == "two_w":
        ws = _x(d_in, d_out, 4) / d_in ** 0.5
    elif epilogue == "self_coeff":
        ws, c = w, torch.tensor(1.25, device="cuda")
    kw = dict(bm=BM, bk=BM, add_diag=p.add_diag, relu=True)
    before = sk.spmm_blockell_update_compact.launches
    y = sk.spmm_blockell_update_compact(None, None, None, x, a["s_in"],
                                        a["s_out"], w, b, ws, c, lists=lists,
                                        **kw)
    assert sk.spmm_blockell_update_compact.launches == before + 1
    tile = sk.spmm_blockell_update_compact(
        t["row_offsets"], t["cols"], t["blocks"], x, t["s_in"], t["s_out"],
        w, b, ws, c, **kw)
    rows = t["node_active"]
    _same(y[rows], tile[rows], exact=not hubs)
    assert torch.equal(sk.spmm_blockell_update_compact(
        None, None, None, x, a["s_in"], a["s_out"], w, b, ws, c,
        lists=lists, **kw), y)


def test_list_plan_makes_no_host_sync():
    """A list plan's forward and transposed aggregations, and its fused
    layer, queue without waiting on the card."""
    _need_cuda()
    p = _plan(True)
    x = _x(p.num_nodes, 64)
    from repro_torch.exec import build_layer_plan
    lp = build_layer_plan(_graph(True), "gcn", d_in=64, d_out=16,
                          order="aggregate_first", gplan=p)
    w = _x(64, 16, 2)
    torch.cuda.synchronize()
    before = (sk.spmm_blockell_compact.launches,
              sk.spmm_blockell_update_compact.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        p.raw_apply(x)
        p.raw_apply_t(x)
        lp(x, w, relu=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (sk.spmm_blockell_compact.launches,
            sk.spmm_blockell_update_compact.launches) == (before[0] + 2,
                                                          before[1] + 1)
