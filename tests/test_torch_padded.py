"""The padded block-ELL grid of the port against the reference's.

* ``BlockEll.dense_blocks``: byte-equal arrays, bitmask and dense storage;
* the plain versions of the padded kernels ``spmm_blockell``,
  ``spmm_blockell_fused`` and ``spmm_blockell_update`` (what the wrappers
  run on CPU tensors) against the Pallas kernels in interpret mode, fed as
  the reference feeds them (d padded to 128 lanes, x zero-padded to C*bk
  rows, 2-D padded scales, a (1, 1) coefficient), on uint8 and float32
  tiles, with and without the self term, with bias, ReLU, ``w_self`` and the
  coefficient; and ``kernels.ops.spmm`` against the reference's;
* padded plans (``compact=False``) on the ``cuda`` and ``torch`` backends
  and the padded fused layer, values and gradients, against the reference's
  padded plans on ``pallas`` (interpret) and ``jnp``.

Tolerance 1e-5 of the largest entry of each compared array: fp32 sums of at
most W x bk terms (and, for layers, one d_in-term product) taken in another
order.  Every row is compared: the padded kernels write them all.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import build_blockell as ref_build_blockell
from repro.exec import build_layer_plan as ref_build_layer_plan
from repro.exec import build_plan as ref_build_plan
from repro.kernels import ops as ref_ops
from repro.kernels.spmm_blockell import (
    spmm_blockell_fused as ref_spmm_blockell_fused,
    spmm_blockell_update as ref_spmm_blockell_update)
from repro_torch.core import build_blockell
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.kernels import ops
from repro_torch.kernels import spmm_blockell as sk

from _torch_parity import GRAPHS, assert_bytes_equal, to_port

TOL = 1e-5
BM = 32


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _pad2(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("storage", ["auto", "dense"])
def test_dense_blocks_byte_equal(gname, storage):
    g = GRAPHS[gname]
    ref = ref_build_blockell(g, bm=BM, bk=BM, storage=storage)
    port = build_blockell(to_port(g), bm=BM, bk=BM, storage=storage)
    # "auto" keeps the bitmask wherever it is exact (no duplicate edges)
    assert port.implicit == ref.implicit
    for dtype in (np.float32, np.uint8):
        assert_bytes_equal(port.dense_blocks(dtype), ref.dense_blocks(dtype),
                           f"dense_blocks({dtype.__name__})")


def _inputs(tiles, seed=0, d=16):
    """The random graph's padded ELL plus x / scales from one seed."""
    g = GRAPHS["random"]
    rng = np.random.default_rng(seed)
    if tiles == "f32":
        # weighted dense tiles exercise the float32 tile path
        g = dataclasses.replace(g, edge_weight=rng.random(g.num_edges)
                                .astype(np.float32))
    ell = ref_build_blockell(g, bm=BM, bk=BM,
                             storage="auto" if tiles == "u8" else "dense")
    n = g.num_nodes
    x = rng.standard_normal((n, d)).astype(np.float32)
    s_in = rng.uniform(0.2, 1.0, n).astype(np.float32)
    s_out = rng.uniform(0.2, 1.0, n).astype(np.float32)
    blocks = ell.dense_blocks(np.uint8 if tiles == "u8" else np.float32)
    return ell, blocks, x, s_in, s_out


def _ref_padded_operands(ell, blocks, x, s_in, s_out):
    n, d = x.shape
    R, C = ell.n_row_blocks, -(-n // BM)
    dp = -(-d // 128) * 128
    return (jnp.asarray(ell.block_cols), jnp.asarray(blocks),
            jnp.asarray(_pad2(x, C * BM, dp)),
            jnp.asarray(_pad2(s_in[:, None], C * BM, 1).reshape(C, BM)),
            jnp.asarray(_pad2(s_out[:, None], R * BM, 1).reshape(R, BM)))


t = torch.as_tensor


@pytest.mark.parametrize("d", [16, 72])
@pytest.mark.parametrize("add_diag", [True, False])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
def test_plain_fused_matches_pallas_kernel(d, add_diag, tiles):
    ell, blocks, x, s_in, s_out = _inputs(tiles, d=d)
    ref = np.asarray(ref_spmm_blockell_fused(
        *_ref_padded_operands(ell, blocks, x, s_in, s_out), bm=BM, bk=BM,
        add_diag=add_diag, interpret=True))[:x.shape[0], :d]
    launches = sk.spmm_blockell_fused.launches
    y = sk.spmm_blockell_fused(t(ell.block_cols), t(blocks), t(x), t(s_in),
                               t(s_out), bm=BM, bk=BM, add_diag=add_diag)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert sk.spmm_blockell_fused.launches == launches
    assert tuple(y.shape) == x.shape
    _close(y.numpy(), ref)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("tiles", ["u8", "f32"])
def test_plain_spmm_matches_pallas_kernel(gname, tiles):
    """Kernel 1 through both ``ops.spmm`` entry points and the wrapper."""
    g = GRAPHS[gname]
    rng = np.random.default_rng(3)
    if tiles == "f32":
        g = dataclasses.replace(g, edge_weight=rng.random(g.num_edges)
                                .astype(np.float32))
    storage = "auto" if tiles == "u8" else "dense"
    ref_ell = ref_build_blockell(g, bm=BM, bk=BM, storage=storage)
    ell = build_blockell(to_port(g), bm=BM, bk=BM, storage=storage)
    x = rng.standard_normal((g.num_nodes, 24)).astype(np.float32)
    ref = np.asarray(ref_ops.spmm(ref_ell, jnp.asarray(x), interpret=True))
    launches = sk.spmm_blockell.launches
    y = ops.spmm(ell, t(x))
    assert sk.spmm_blockell.launches == launches
    _close(y.numpy(), ref, "ops.spmm")
    _close(ops.spmm_ref(ell, t(x)).numpy(),
           np.asarray(ref_ops.spmm_ref(ref_ell, jnp.asarray(x))), "spmm_ref")
    # the wrapper's default output covers every row block
    full = sk.spmm_blockell(t(ell.block_cols), t(ell.dense_blocks()), t(x),
                            bm=BM, bk=BM)
    assert full.shape[0] == ell.n_row_blocks * BM
    _close(full.numpy()[:g.num_nodes], ref)


# (d_in, d_out, add_diag, epilogue, bias, relu, tiles): GCN's layer, SAGE's
# two W, GIN's w_self-is-w with a coefficient, a wide d_in and a d_out past
# 128 lanes
UPDATE_CASES = [(20, 12, True, "none", True, True, "u8"),
                (20, 12, False, "two_w", True, False, "f32"),
                (20, 12, False, "self_coeff", False, True, "u8"),
                (140, 9, True, "self_coeff", True, True, "f32"),
                (16, 130, False, "none", False, False, "u8")]


@pytest.mark.parametrize("d_in,d_out,add_diag,epilogue,bias,relu,tiles",
                         UPDATE_CASES)
def test_plain_update_matches_pallas_kernel(d_in, d_out, add_diag, epilogue,
                                            bias, relu, tiles):
    ell, blocks, x, s_in, s_out = _inputs(tiles, seed=1, d=d_in)
    rng = np.random.default_rng(2)
    mat = lambda a, b: (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
        np.float32)
    w = mat(d_in, d_out)
    b = rng.standard_normal(d_out).astype(np.float32) if bias else None
    ws = c = None
    if epilogue == "two_w":
        ws = mat(d_in, d_out)
    elif epilogue == "self_coeff":
        ws, c = w, np.float32(1.3)
    dp_in, dp_out = -(-d_in // 128) * 128, -(-d_out // 128) * 128
    ref = np.asarray(ref_spmm_blockell_update(
        *_ref_padded_operands(ell, blocks, x, s_in, s_out),
        jnp.asarray(_pad2(w, dp_in, dp_out)),
        None if b is None else jnp.asarray(_pad2(b[None], 1, dp_out)),
        None if ws is None else jnp.asarray(_pad2(ws, dp_in, dp_out)),
        None if c is None else jnp.full((1, 1), c, jnp.float32),
        bm=BM, bk=BM, add_diag=add_diag, relu=relu,
        interpret=True))[:x.shape[0], :d_out]
    tw = t(w)
    launches = sk.spmm_blockell_update.launches
    y = sk.spmm_blockell_update(
        t(ell.block_cols), t(blocks), t(x), t(s_in), t(s_out), tw,
        None if b is None else t(b),
        tw if epilogue == "self_coeff" else (None if ws is None else t(ws)),
        None if c is None else torch.tensor(c), bm=BM, bk=BM,
        add_diag=add_diag, relu=relu)
    assert sk.spmm_blockell_update.launches == launches
    assert tuple(y.shape) == (x.shape[0], d_out)
    _close(y.numpy(), ref)


def test_padded_wrappers_reject_bad_operands():
    ell, blocks, x, s_in, s_out = _inputs("u8")
    args = [t(ell.block_cols), t(blocks), t(x), t(s_in), t(s_out)]
    with pytest.raises(ValueError, match="blocks must be"):
        sk.spmm_blockell_fused(args[0], args[1][:, :1], *args[2:], bm=BM,
                               bk=BM, add_diag=True)
    with pytest.raises(ValueError, match="row blocks"):
        sk.spmm_blockell_fused(*args[:4], args[4][:BM], bm=BM, bk=BM,
                               add_diag=True)
    with pytest.raises(TypeError, match="block_cols"):
        sk.spmm_blockell(args[0].long(), *args[1:3], bm=BM, bk=BM)
    with pytest.raises(ValueError, match="self_coeff needs w_self"):
        sk.spmm_blockell_update(*args, torch.zeros(16, 4), None, None,
                                torch.tensor(1.0), bm=BM, bk=BM,
                                add_diag=False)


# ---------------------------------------------------------------------------
# padded plans and the padded fused layer
# ---------------------------------------------------------------------------
def _x(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
def test_padded_plan_value_and_gradient_match_reference(gname, mode):
    """The padded plan's forward and its backward through the padded
    transpose plan, on both block backends, against the reference's padded
    pallas-interpret and jnp plans and their custom VJP."""
    g = GRAPHS[gname]
    d = 24
    x, proj = _x(g.num_nodes, d, 1), _x(g.num_nodes, d, 5)
    for backend in ("pallas", "jnp"):
        rp = ref_build_plan(g, mode, bm=BM, backend=backend, compact=False,
                            interpret=True)
        y_ref = np.asarray(rp.apply(jnp.asarray(x)))
        dx_ref = np.asarray(jax.grad(lambda x: jnp.sum(rp.apply(x) * proj))(
            jnp.asarray(x)))
        for port_backend in ("cuda", "torch"):
            p = build_plan(to_port(g), mode, bm=BM, backend=port_backend,
                           compact=False, device="cpu")
            assert not p.compact and p.grid_size == rp.grid_size
            xt = t(x).requires_grad_()
            y = p.apply(xt)
            (y * t(proj)).sum().backward()
            _close(y.detach().numpy(), y_ref, f"{port_backend} vs {backend}")
            _close(xt.grad.numpy(), dx_ref, f"d{port_backend} vs {backend}")


@pytest.mark.parametrize("gname", ["random", "empty_rows"])
@pytest.mark.parametrize("epilogue", ["none", "two_w", "self_coeff"])
def test_padded_fused_layer_matches_reference(gname, epilogue):
    """The padded one-launch layer (``spmm_blockell_update`` forward, the
    padded transpose plan backward): values and the gradient of every
    operand against ``jax.grad`` of the reference's padded fused layer."""
    g = GRAPHS[gname]
    mode, relu, bias = {"none": ("gcn", True, True),
                        "two_w": ("mean", False, True),
                        "self_coeff": ("sum", True, False)}[epilogue]
    d_in, d_out = 20, 12
    rng = np.random.default_rng(11)
    mat = lambda a, b: (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
        np.float32)
    ops_ = {"x": _x(g.num_nodes, d_in, 3), "w": mat(d_in, d_out)}
    if bias:
        ops_["b"] = rng.standard_normal(d_out).astype(np.float32)
    if epilogue == "two_w":
        ops_["ws"] = mat(d_in, d_out)
    if epilogue == "self_coeff":
        ops_["c"] = np.float32(1.3)
    names = list(ops_)
    proj = _x(g.num_nodes, d_out, 6)

    def call(apply, v):
        ws = v.get("ws", v["w"] if "c" in v else None)
        return apply(v["x"], v["w"], v.get("b"), relu=relu, w_self=ws,
                     self_coeff=v.get("c"))

    ref_lp = ref_build_layer_plan(g, mode, d_in=d_in, d_out=d_out,
                                  order="aggregate_first", fuse=True, bm=BM,
                                  backend="pallas", compact=False,
                                  interpret=True)

    def ref_loss(*vals):
        y = call(ref_lp.apply, dict(zip(names, vals)))
        return jnp.sum(y * jnp.asarray(proj)), y

    (_, ref_y), ref_grads = jax.value_and_grad(
        ref_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(ops_[k]) for k in names))
    lp = build_layer_plan(to_port(g), mode, d_in=d_in, d_out=d_out,
                          order="aggregate_first", bm=BM, backend="cuda",
                          compact=False, device="cpu")
    assert lp.fuse and not lp.gplan.compact
    tv = {k: torch.tensor(np.asarray(ops_[k])).requires_grad_()
          for k in names}
    y = call(lp.apply, tv)
    (y * t(proj)).sum().backward()
    _close(y.detach().numpy(), ref_y, "value")
    for k, rg in zip(names, ref_grads):
        _close(tv[k].grad.numpy(), rg, f"d{k}")
