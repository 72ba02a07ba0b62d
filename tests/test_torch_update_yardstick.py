"""The update kernels' two-call yardstick against their plain versions.

``chip_smoke.py`` times ``spmm_blockell_update_compact`` and
``spmm_blockell_update`` beside ``composed_update``: ``torch.sparse.mm``
over the plan's scaled adjacency (the gcn diagonal and the update layer's
self term ``c x_v`` on its diagonal), then ``torch.addmm`` with the bias,
ReLU in place.  No single PyTorch call computes aggregation and W epilogue
together, so that composition stands in for a library call.  This holds it
to ``spmm_blockell_update_compact_ref`` and ``spmm_blockell_update_ref`` on
the CPU, at GIN's conv (sum, W_self is W, c = 1 + eps, bias, ReLU), at
gcn's ``add_diag`` layer 1433 -> 16 and at SAGE's two-W layer (a third
call, ``addmm_`` of ``x @ w_self``), so that its times on the card measure
the same function.

Tolerance 1e-5 of the largest entry (at least 1): fp32 sums of a row's
edges and of up to 1433-term products, taken in another order.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.exec import build_plan
from repro_torch.graph import Graph
from repro_torch.kernels.ref import (spmm_blockell_update_compact_ref,
                                     spmm_blockell_update_ref)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

TOL = 1e-5
BM = 32


def _graph(n=300, e=2000, seed=0):
    rng = np.random.default_rng(seed)
    return Graph(src=rng.integers(0, n, e).astype(np.int32),
                 dst=rng.integers(0, n, e).astype(np.int32), num_nodes=n)


@pytest.mark.parametrize("walk", ["compact", "padded"])
@pytest.mark.parametrize("mode,d_in,d_out,self_coeff", [
    ("sum", 128, 128, 1.25), ("gcn", 1433, 16, None)])
def test_composition_matches_the_update_kernels_plain_version(
        walk, mode, d_in, d_out, self_coeff):
    g = _graph()
    n = g.num_nodes
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    x = t(rng.standard_normal((n, d_in)))
    w = t(rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
    b = t(rng.standard_normal(d_out))
    c = None if self_coeff is None else torch.tensor(self_coeff)
    ws = None if c is None else w
    plan = build_plan(g, mode, bm=BM, backend="torch",
                      compact=walk == "compact", device="cpu")
    a = plan._fwd
    kw = dict(bm=BM, bk=BM, add_diag=plan.add_diag, relu=True)
    if walk == "compact":
        ref = spmm_blockell_update_compact_ref(
            a["row_offsets"], a["cols"], a["blocks"], x, a["s_in"],
            a["s_out"], w, b, ws, c, **kw)
        rows = a["node_active"]
        assert bool(rows.any())
    else:
        ref = spmm_blockell_update_ref(a["block_cols"], a["blocks"], x,
                                       a["s_in"], a["s_out"], w, b, ws, c,
                                       **kw)
        rows = torch.ones(n, dtype=torch.bool)
    mat = chip_smoke.library_matrix(torch, torch.device("cpu"), g, mode,
                                    False, self_coeff)
    got = chip_smoke.composed_update(torch, mat, x, w, b, True)
    assert got.shape == (n, d_out)
    chip_smoke.assert_close_scaled(got[rows], ref[rows], TOL,
                                   f"{walk} {mode} {d_in}->{d_out}")


@pytest.mark.parametrize("relu", [False, True])
def test_two_w_composition_matches_the_update_kernels_plain_version(relu):
    """SAGE's two-W layer (mean, separate w_self, no coefficient): the
    yardstick's third call ``addmm_(x, w_self)`` gives the plain version's
    ``(s_out ⊙ A x) @ w + x @ w_self + b``."""
    g = _graph()
    n = g.num_nodes
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    x = t(rng.standard_normal((n, 48)))
    w = t(rng.standard_normal((48, 64)) / np.sqrt(48))
    ws = t(rng.standard_normal((48, 64)) / np.sqrt(48))
    b = t(rng.standard_normal(64))
    plan = build_plan(g, "mean", bm=BM, backend="torch", device="cpu")
    a = plan._fwd
    ref = spmm_blockell_update_compact_ref(
        a["row_offsets"], a["cols"], a["blocks"], x, a["s_in"], a["s_out"],
        w, b, ws, bm=BM, bk=BM, add_diag=plan.add_diag, relu=relu)
    mat = chip_smoke.library_matrix(torch, torch.device("cpu"), g, "mean",
                                    False)
    got = chip_smoke.composed_update(torch, mat, x, w, b, relu, ws)
    rows = a["node_active"]
    chip_smoke.assert_close_scaled(got[rows], ref[rows], TOL,
                                   f"two-W relu={relu}")
