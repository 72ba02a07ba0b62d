"""The port's SDDMM against the reference's.

``kernels.ops.sddmm`` (on CPU tensors: the kernel wrapper's plain version)
against the reference's ``ops.sddmm``, which runs the Pallas kernel in
interpret mode (one edge per grid step, q and k padded to 128 lanes), and
against its ``sddmm_ref``, at 1e-5 of the largest score: fp32 dot products
of up to 256 terms in another order.  Edge counts on and off a multiple of
256 (the reference's unused edge block), widths below, at and above a warp
and at the Hopper kernel's branches (a lane per edge below d = 16, lane
groups of d/4 above, 128-column chunks past d = 128); the 60 x 45 node
pairs repeat edges.
The kernel itself against its plain version is in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro.kernels.ref import sddmm_ref as ref_sddmm_ref
from repro_torch.kernels import ops
from repro_torch.kernels import sddmm as ks

TOL = 1e-5


def _inputs(E, d, seed=0, n=60, m=45):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, E).astype(np.int32),
            rng.integers(0, m, E).astype(np.int32),
            rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("E", [256, 300])
@pytest.mark.parametrize("d", [1, 4, 7, 16, 64, 130, 256])
def test_ops_sddmm_matches_reference(E, d):
    src, dst, q, k = _inputs(E, d)
    j = [jnp.asarray(a) for a in (src, dst, q, k)]
    ref_kernel = np.asarray(ref_ops.sddmm(*j, interpret=True))
    ref_plain = np.asarray(ref_sddmm_ref(*j))
    got = ops.sddmm(*(torch.as_tensor(a) for a in (src, dst, q, k)))
    assert got.shape == (E,) and got.dtype == torch.float32
    scale = max(float(np.abs(ref_plain).max()), 1.0)
    for ref, what in ((ref_kernel, "Pallas kernel (interpret)"),
                      (ref_plain, "sddmm_ref")):
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= TOL * scale, f"vs {what}: {err} > {TOL} x {scale}"


def test_sddmm_takes_int64_indices_and_no_edges():
    src, dst, q, k = (torch.as_tensor(a) for a in _inputs(40, 9))
    torch.testing.assert_close(ops.sddmm(src.long(), dst.long(), q, k),
                               ops.sddmm(src, dst, q, k), rtol=0, atol=0)
    empty = torch.zeros(0, dtype=torch.int32)
    assert ops.sddmm(empty, empty, q, k).shape == (0,)
    assert ks.sddmm.launches == 0                # the plain version


@pytest.mark.parametrize("bad", ["src_range", "dst_range", "width",
                                 "lengths", "grad"])
def test_sddmm_rejects_bad_operands(bad):
    src, dst, q, k = (torch.as_tensor(a) for a in _inputs(40, 9))
    if bad == "src_range":
        src[0] = q.shape[0]
        with pytest.raises(IndexError, match="src out of range"):
            ops.sddmm(src, dst, q, k)
    elif bad == "dst_range":
        dst[5] = -1
        with pytest.raises(IndexError, match="dst out of range"):
            ops.sddmm(src, dst, q, k)
    elif bad == "width":
        with pytest.raises(ValueError, match="wide"):
            ops.sddmm(src, dst, q, k[:, :4])
    elif bad == "lengths":
        with pytest.raises(ValueError, match="edges"):
            ks.sddmm(src, dst[:-1], q, k)
    else:
        with pytest.raises(NotImplementedError, match="backward"):
            ops.sddmm(src, dst, q.requires_grad_(), k)
