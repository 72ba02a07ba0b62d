"""The port's block-ELL kernels' plain versions against the reference's
Pallas kernels: ``spmm_blockell_compact`` and the one-launch layer
``spmm_blockell_update_compact``.

The JAX side runs ``repro.kernels.spmm_blockell.spmm_blockell_compact`` in
interpret mode, fed the way the reference plan feeds it (d padded to 128
lanes, x zero-padded to C*bk rows, 2-D padded scales).  The port side takes
the same numpy inputs unpadded; on CPU tensors its wrapper runs the plain
version.  Compared on the rows the kernel writes (destination blocks with at
least one active slot), to 1e-5: fp32 sums of at most a row's slots x bk
terms taken in another order.  The layer kernel's reference is fed as the
reference plan feeds it (``repro.exec.plan._pallas_layer``: d_in and d_out
padded to 128 lanes, (1, 1) self coefficient) and held to the same 1e-5.
The kernels themselves against their plain versions are in
``test_torch_cuda.py`` (they need the card).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import build_blockell as ref_build_blockell
from repro.exec import build_plan as ref_build_plan
from repro.exec.plan import _pallas_layer as ref_pallas_layer
from repro.kernels.spmm_blockell import (
    spmm_blockell_compact as ref_spmm_blockell_compact)
from repro_torch.kernels import spmm_blockell as sk
from repro_torch.exec import build_plan
from repro_torch.kernels.ref import (spmm_blockell_compact_ref,
                                     spmm_blockell_update_compact_ref)

from _torch_parity import GRAPHS, to_port

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

TOL = 1e-5
BM = 32


def _inputs(d, tiles, override, seed=0):
    """A compaction of the random graph plus x / scales from one seed."""
    g = GRAPHS["random"]
    rng = np.random.default_rng(seed)
    if tiles == "f32":
        # weighted dense tiles exercise the float32 tile path
        g = dataclasses.replace(g, edge_weight=rng.random(g.num_edges)
                                .astype(np.float32))
    ell = ref_build_blockell(g, bm=BM, bk=BM,
                             storage="auto" if tiles == "u8" else "dense")
    comp = ell.compact(np.uint8 if tiles == "u8" else np.float32)
    n = g.num_nodes
    x = rng.standard_normal((n, d)).astype(np.float32)
    s_in = rng.uniform(0.2, 1.0, n).astype(np.float32)
    s_out = rng.uniform(0.2, 1.0, n).astype(np.float32)
    xd = sd = None
    if override:
        xd = rng.standard_normal((n, d)).astype(np.float32)
        sd = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return ell, comp, x, s_in, s_out, xd, sd


def _pad2(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _ref_kernel(ell, comp, x, s_in, s_out, xd, sd, add_diag):
    n, d = x.shape
    R, C = ell.n_row_blocks, -(-n // BM)
    dp = -(-d // 128) * 128
    y = ref_spmm_blockell_compact(
        jnp.asarray(comp.rows), jnp.asarray(comp.cols),
        jnp.asarray(comp.blocks), jnp.asarray(_pad2(x, C * BM, dp)),
        jnp.asarray(_pad2(s_in[:, None], C * BM, 1).reshape(C, BM)),
        jnp.asarray(_pad2(s_out[:, None], R * BM, 1).reshape(R, BM)),
        None if xd is None else jnp.asarray(_pad2(xd, R * BM, dp)),
        None if sd is None else jnp.asarray(
            _pad2(sd[:, None], R * BM, 1).reshape(R, BM)),
        bm=BM, bk=BM, n_row_blocks=R, add_diag=add_diag, interpret=True)
    return np.asarray(y)[:n, :d]


def _port_args(comp, x, s_in, s_out, xd, sd, device="cpu"):
    t = lambda a: None if a is None else torch.as_tensor(a).to(device)
    return (t(comp.row_offsets.astype(np.int32)), t(comp.cols),
            t(comp.blocks), t(x), t(s_in), t(s_out), t(xd), t(sd))


CASES = ([(d, add_diag, tiles, False) for d in (16, 64, 72)
          for add_diag in (True, False) for tiles in ("u8", "f32")]
         + [(d, True, tiles, True) for d in (16, 64, 72)
            for tiles in ("u8", "f32")])


@pytest.mark.parametrize("d,add_diag,tiles,override", CASES)
def test_plain_version_matches_pallas_kernel(d, add_diag, tiles, override):
    ell, comp, x, s_in, s_out, xd, sd = _inputs(d, tiles, override)
    ref = _ref_kernel(ell, comp, x, s_in, s_out, xd, sd, add_diag)
    launches = sk.spmm_blockell_compact.launches
    y = sk.spmm_blockell_compact(*_port_args(comp, x, s_in, s_out, xd, sd),
                                 bm=BM, bk=BM, add_diag=add_diag)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert sk.spmm_blockell_compact.launches == launches
    assert tuple(y.shape) == x.shape
    written = np.repeat(comp.row_active, BM)[:x.shape[0]]
    assert 0 < written.sum() <= x.shape[0]
    np.testing.assert_allclose(y.numpy()[written], ref[written],
                               atol=TOL, rtol=TOL)


def test_unwritten_rows_come_out_zero_in_plain_version():
    g = GRAPHS["empty_rows"]          # only the first row block has edges
    comp = ref_build_blockell(g, bm=BM, bk=BM, storage="auto").compact(
        np.uint8)
    n = g.num_nodes
    x = np.ones((n, 8), np.float32)
    ones = np.ones(n, np.float32)
    y = spmm_blockell_compact_ref(*_port_args(comp, x, ones, ones, None,
                                              None),
                                  bm=BM, bk=BM, add_diag=True)
    assert comp.row_active.tolist() == [True] + [False] * 7
    assert torch.all(y[BM:] == 0) and torch.all(y[:BM] >= 1)


@pytest.mark.parametrize("bad", ["dtype_x", "dtype_offsets", "shape_blocks",
                                 "rect_diag", "empty", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, comp, x, s_in, s_out, _, _ = _inputs(16, "u8", False)
    args = list(_port_args(comp, x, s_in, s_out, None, None))
    kw = dict(bm=BM, bk=BM, add_diag=True)
    if bad == "dtype_x":
        args[3] = args[3].double()
    elif bad == "dtype_offsets":
        args[0] = args[0].long()
    elif bad == "shape_blocks":
        args[2] = args[2][:, :16].contiguous()
    elif bad == "rect_diag":
        kw["bk"] = 16
        args[2] = args[2][:, :, :16].contiguous()
    elif bad == "empty":
        args[1], args[2] = args[1][:0], args[2][:0]
    elif bad == "noncontig":
        args[3] = torch.as_tensor(np.asfortranarray(x))
    with pytest.raises((TypeError, ValueError)):
        sk.spmm_blockell_compact(*args, **kw)


# ---------------------------------------------------------------------------
# the one-launch layer: spmm_blockell_update_compact
# ---------------------------------------------------------------------------
LAYER_BM = 64


def _layer_inputs(g, epilogue, d_in=40, d_out=12, seed=4):
    rng = np.random.default_rng(seed)
    mat = lambda a, b: (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
        np.float32)
    x = rng.standard_normal((g.num_nodes, d_in)).astype(np.float32)
    w = mat(d_in, d_out)
    b = rng.standard_normal(d_out).astype(np.float32)
    ws = c = None
    if epilogue == "two_w":
        ws = mat(d_in, d_out)
    elif epilogue == "self_coeff":          # GIN: the same W on both halves
        ws, c = w, np.float32(1.25)
    return x, w, b, ws, c


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("epilogue", ["none", "two_w", "self_coeff"])
def test_update_plain_version_matches_pallas_kernel(gname, mode, epilogue):
    g = GRAPHS[gname]
    x, w, b, ws, c = _layer_inputs(g, epilogue)
    ref_plan = ref_build_plan(g, mode, bm=LAYER_BM, backend="pallas",
                              compact=True, interpret=True)
    port_plan = build_plan(to_port(g), mode, bm=LAYER_BM, backend="cuda",
                           device="cpu")
    # the tile walk's plain version
    a = chip_smoke.tile_arrays(port_plan)
    written = a["node_active"].numpy()
    assert 0 < written.sum() <= g.num_nodes
    t = lambda v: None if v is None else torch.as_tensor(v)
    # each epilogue flag on and off (each distinct pair compiles a kernel)
    for bias, relu in ((True, True), (False, False)):
        ref = np.asarray(ref_pallas_layer(
            ref_plan.meta_fwd, ref_plan._fwd, jnp.asarray(x),
            jnp.asarray(w), jnp.asarray(b) if bias else None, relu,
            None if ws is None else jnp.asarray(ws),
            None if c is None else jnp.asarray(c)))
        launches = sk.spmm_blockell_update_compact.launches
        y = sk.spmm_blockell_update_compact(
            a["row_offsets"], a["cols"], a["blocks"], t(x), a["s_in"],
            a["s_out"], t(w), t(b) if bias else None, t(ws), t(c),
            bm=LAYER_BM, bk=LAYER_BM, add_diag=port_plan.add_diag,
            relu=relu)
        # a CPU tensor runs the plain version: no launch is counted
        assert sk.spmm_blockell_update_compact.launches == launches
        assert tuple(y.shape) == (g.num_nodes, w.shape[1])
        np.testing.assert_allclose(
            y.numpy()[written], ref[written], atol=TOL, rtol=TOL,
            err_msg=f"bias={bias} relu={relu}")


def test_update_plain_version_overrides_and_unwritten_rows():
    """x_self / x_diag / s_in_diag replace the destination-row operands
    (degree buckets pass gathered rows); rows of blocks with no slot come
    out zero."""
    g = GRAPHS["empty_rows"]          # only the first row block has edges
    comp = ref_build_blockell(g, bm=BM, bk=BM, storage="auto").compact(
        np.uint8)
    n = g.num_nodes
    rng = np.random.default_rng(8)
    x, xs, xd = (rng.standard_normal((n, 6)).astype(np.float32)
                 for _ in range(3))
    sd = rng.uniform(0.2, 1.0, n).astype(np.float32)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    args = _port_args(comp, x, np.ones(n, np.float32), np.ones(n, np.float32),
                      None, None)[:6]
    t = torch.as_tensor
    y = spmm_blockell_update_compact_ref(
        *args, t(w), None, t(w), t(np.float32(2.0)), t(xs), t(xd), t(sd),
        bm=BM, bk=BM, add_diag=True)
    agg = spmm_blockell_compact_ref(*args, t(xd), t(sd), bm=BM, bk=BM,
                                    add_diag=True)
    expected = agg @ t(w) + 2.0 * (t(xs) @ t(w))
    torch.testing.assert_close(y[:BM], expected[:BM], atol=TOL, rtol=TOL)
    assert torch.all(y[BM:] == 0)


@pytest.mark.parametrize("bad", ["dtype_w", "rows_w", "bias_len",
                                 "coeff_without_self", "self_shape",
                                 "coeff_ndim", "rect_self", "x_self_rows"])
def test_update_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, comp, x, s_in, s_out, _, _ = _inputs(16, "u8", False)
    args = list(_port_args(comp, x, s_in, s_out, None, None)[:6])
    w = torch.ones(16, 8)
    kw = dict(bias=torch.zeros(8), w_self=None, self_coeff=None,
              x_self=None)
    opts = dict(bm=BM, bk=BM, add_diag=False)
    if bad == "dtype_w":
        w = w.double()
    elif bad == "rows_w":
        w = torch.ones(15, 8)
    elif bad == "bias_len":
        kw["bias"] = torch.zeros(7)
    elif bad == "coeff_without_self":
        kw["self_coeff"] = torch.tensor(1.0)
    elif bad == "self_shape":
        kw["w_self"] = torch.ones(16, 7)
    elif bad == "coeff_ndim":
        kw.update(w_self=w, self_coeff=torch.ones(1))
    elif bad == "rect_self":
        kw["w_self"] = w
        opts["bk"] = 16
        args[2] = args[2][:, :, :16].contiguous()
    elif bad == "x_self_rows":
        kw.update(w_self=w, x_self=args[3][:10])
    with pytest.raises((TypeError, ValueError)):
        sk.spmm_blockell_update_compact(*args, w, **kw, **opts)
