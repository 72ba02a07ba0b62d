"""The port's ``spmm_blockell_compact`` against the reference Pallas kernel.

The JAX side runs ``repro.kernels.spmm_blockell.spmm_blockell_compact`` in
interpret mode, fed the way the reference plan feeds it (d padded to 128
lanes, x zero-padded to C*bk rows, 2-D padded scales).  The port side takes
the same numpy inputs unpadded; on CPU tensors its wrapper runs the plain
version.  Compared on the rows the kernel writes (destination blocks with at
least one active slot), to 1e-5: fp32 sums of at most a row's slots x bk
terms taken in another order.  The kernel itself against its plain version
is in ``test_torch_cuda.py`` (it needs the card).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import build_blockell as ref_build_blockell
from repro.kernels.spmm_blockell import (
    spmm_blockell_compact as ref_spmm_blockell_compact)
from repro_torch.kernels import spmm_blockell as sk
from repro_torch.kernels.ref import spmm_blockell_compact_ref

from _torch_parity import GRAPHS

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
