"""The port's flash-decode attention against the reference's.

``kernels.ops.decode_attention`` (on CPU tensors: the kernel wrapper's
plain version, ``decode_attention_ref``) against the reference's
``ops.decode_attention``, which runs the Pallas kernel in interpret mode,
and its ``decode_attention_ref``: the shapes and the bf16 case of
``tests/test_kernels.py`` at fp32 1e-5 (fp32 sums of up to 1024 terms in
another order) and bf16 3e-2 (the reference's own bar: the Pallas kernel
rounds bf16 scores and probabilities to bf16, the port does not), the
masking test, ragged and zero lengths, and a GQA-native cache against the
same cache expanded.  The kernel itself against its plain version is in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro.kernels.ref import decode_attention_ref as ref_decode_ref
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.nn.attention import _expand_kv

TOL = 1e-5
BF16_TOL = 3e-2


def _inputs(B, S, H, d, seed, KV=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    KV = KV or H
    return (rng.standard_normal((B, H, d)).astype(dtype),
            rng.standard_normal((B, S, KV, d)).astype(dtype),
            rng.standard_normal((B, S, KV, d)).astype(dtype))


def _port(q, k, v, cl, dtype=torch.float32):
    t = lambda a: torch.as_tensor(a).to(dtype)
    return ops.decode_attention(t(q), t(k), t(v), torch.as_tensor(cl))


# the shapes of tests/test_kernels.py::test_decode_attention_shapes
@pytest.mark.parametrize("B,S,H,d,bs", [(1, 256, 2, 64, 64),
                                        (2, 1024, 4, 128, 256),
                                        (3, 512, 1, 32, 512)])
def test_decode_attention_matches_reference(B, S, H, d, bs):
    q, k, v = _inputs(B, S, H, d, B + S)
    cl = np.random.default_rng(B + S).integers(1, S + 1, B).astype(np.int32)
    j = [jnp.asarray(a) for a in (q, k, v, cl)]
    got = _port(q, k, v, cl)
    assert got.shape == (B, H, d) and got.dtype == torch.float32
    for ref, what in ((ref_ops.decode_attention(*j, bs=bs, interpret=True),
                       "Pallas kernel (interpret)"),
                      (ref_decode_ref(*j), "decode_attention_ref")):
        err = float(np.abs(got.numpy() - np.asarray(ref)).max())
        assert err <= TOL, f"vs {what}: {err}"
    assert kd.decode_attention.launches == 0        # the plain version


def test_decode_attention_bf16():
    rng = np.random.default_rng(5)
    B, S, H, d = 2, 512, 2, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, d), (B, S, H, d), (B, S, H, d)))
    cl = np.array([300, 512], np.int32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    got = _port(q, k, v, cl, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    for ref in (ref_ops.decode_attention(*jb, jnp.asarray(cl), bs=128,
                                         interpret=True),
                ref_decode_ref(*jb, jnp.asarray(cl))):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_decode_attention_masking():
    """Positions past cache_len do not reach the output."""
    q, k, v = _inputs(1, 256, 2, 32, 9)
    cl = np.array([100], np.int32)
    out1 = _port(q, k, v, cl)
    k2, v2 = k.copy(), v.copy()
    k2[:, 100:] = 999.0
    v2[:, 100:] = -999.0
    torch.testing.assert_close(_port(q, k2, v2, cl), out1, rtol=0, atol=TOL)


def test_ragged_and_zero_lengths_match_the_pallas_kernel():
    """Lengths 0 (a zero row, as the Pallas kernel's max(l, 1e-30) gives;
    the reference's plain version gives NaN there), 1, S and above S."""
    B, S, H, d = 5, 256, 2, 32
    q, k, v = _inputs(B, S, H, d, 11)
    cl = np.array([0, 1, 77, S, S + 9], np.int32)
    ref = np.asarray(ref_ops.decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, cl)), bs=64, interpret=True))
    got = _port(q, k, v, cl).numpy()
    assert not got[0].any() and not ref[0].any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert np.isnan(np.asarray(ref_decode_ref(
        *(jnp.asarray(a) for a in (q, k, v, cl))))[0]).all()


@pytest.mark.parametrize("G", [1, 4, 12])
def test_gqa_native_equals_expanded_cache(G):
    """G query heads per KV head: the GQA-native cache and the same cache
    expanded (``nn.attention._expand_kv``, the reference's layout) give
    bit-equal outputs."""
    B, S, KV, d = 2, 96, 2, 16
    q, k, v = _inputs(B, S, KV * G, d, G, KV=KV)
    q, k, v = (torch.as_tensor(a) for a in (q, k, v))
    cl = torch.tensor([50, 96], dtype=torch.int32)
    native = ops.decode_attention(q, k, v, cl)
    expanded = ops.decode_attention(q, _expand_kv(k, G), _expand_kv(v, G),
                                    cl)
    assert torch.equal(native, expanded)
    # and the expanded call against the reference's plain version
    ref = ref_decode_ref(*(jnp.asarray(t.numpy()) for t in
                           (q, _expand_kv(k, G), _expand_kv(v, G), cl)))
    np.testing.assert_allclose(native.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_any_sequence_length_and_int64_lengths():
    """No multiple of a block: S = 1 and S = 37; cache_len in any integer
    type (``ops`` casts it to int32)."""
    for S in (1, 37):
        q, k, v = _inputs(2, S, 4, 8, S, KV=2)
        q, k, v = (torch.as_tensor(a) for a in (q, k, v))
        cl = torch.tensor([S, 1], dtype=torch.int64)
        got = ops.decode_attention(q, k, v, cl)
        torch.testing.assert_close(
            got, decode_attention_ref(q, k, v, cl.to(torch.int32)),
            rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "q_shape", "kv_shape",
                                 "groups", "lengths", "width", "stride",
                                 "grad"])
def test_wrapper_rejects_bad_operands(bad):
    """The wrapper's checks, which guard the kernel's launch on the card,
    run on any device."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(2, 16, 4, 8, 0, KV=2))
    cl = torch.tensor([3, 16], dtype=torch.int32)
    call = lambda *a: kd.decode_attention(*a)
    if bad == "dtype":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            call(q.half(), k.half(), v.half(), cl)
    elif bad == "mixed":
        with pytest.raises(TypeError, match="k is"):
            call(q, k.to(torch.bfloat16), v, cl)
    elif bad == "q_shape":
        with pytest.raises(ValueError, match="contiguous"):
            call(q[:, None], k, v, cl)
    elif bad == "kv_shape":
        with pytest.raises(ValueError, match="do not match"):
            call(q, k[:, :, :, :4], v[:, :, :, :4], cl)
    elif bad == "groups":
        with pytest.raises(ValueError, match="group"):
            call(q[:, :3].contiguous(), k, v, cl)
    elif bad == "lengths":
        with pytest.raises(TypeError, match="int32"):
            call(q, k, v, cl.long())
        with pytest.raises(ValueError, match="cache_len"):
            call(q, k, v, cl[:1])
    elif bad == "width":
        wide = torch.zeros(2, 16, 2, 300)
        with pytest.raises(ValueError, match="d <="):
            call(torch.zeros(2, 4, 300), wide, wide, cl)
    elif bad == "stride":
        with pytest.raises(ValueError, match="unit stride"):
            call(q, k.transpose(2, 3).contiguous().transpose(2, 3)[..., ::2],
                 v, cl)
    else:
        with pytest.raises(NotImplementedError, match="backward"):
            call(q.requires_grad_(), k, v, cl)
    assert kd.decode_attention.launches == 0

