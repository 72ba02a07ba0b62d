"""Degree bucketing and bucketed plans of the port against the reference's.

* every function of ``exec/bucketing.py`` on the MinHash-reordered Cora and
  on a skewed synthetic graph: byte-equal index arrays, equal occupancy
  rows, signatures and candidate tuples (with the reference's ``pallas``
  read as ``cuda`` and ``jnp`` as ``torch``);
* bucketed plans (``buckets="..."``) on the ``cuda`` backend (the compact
  kernels once per bucket with gathered destination operands; their plain
  versions on CPU tensors) and on ``torch`` (per-bucket padded plain
  products), values and gradients through the re-bucketed transpose plan,
  against the reference's bucketed plans on ``pallas`` (interpret) and
  ``jnp``; and the bucketed fused layer against the reference's, values and
  every gradient.

Tolerance 1e-5 of the largest entry of each compared array (fp32 sums in
another order), as for the unbucketed plans.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import minhash_reorder as ref_minhash
from repro.exec import bucketing as ref_bucketing
from repro.exec import build_layer_plan as ref_build_layer_plan
from repro.exec import build_plan as ref_build_plan
from repro.graph import cora_like as ref_cora_like
from repro_torch.exec import bucketing
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.kernels import spmm_blockell as sk

from _torch_parity import GRAPHS, assert_bytes_equal, to_port

TOL = 1e-5
PORT_NAME = {"pallas": "cuda", "jnp": "torch"}


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _mapped(cands):
    return [tuple(PORT_NAME.get(v, v) if isinstance(v, str) else v
                  for v in c) for c in cands]


_CORA = ref_cora_like().permute(ref_minhash(ref_cora_like()))
BUCKET_GRAPHS = {"reordered_cora": _CORA, "skewed": GRAPHS["skewed"]}


@pytest.mark.parametrize("gname", sorted(BUCKET_GRAPHS))
def test_bucketing_functions_match_reference(gname):
    g = BUCKET_GRAPHS[gname]
    deg = g.in_degrees()
    for tail, hub in ((16, 64), (32, 128), (128, 256), (128, 512)):
        scheme = bucketing.default_scheme(deg, tail, hub)
        assert scheme == ref_bucketing.default_scheme(deg, tail, hub)
        for cut in (2, 5, None):
            assert (bucketing.default_scheme(deg, tail, hub, cut)
                    == ref_bucketing.default_scheme(deg, tail, hub, cut))
        if not scheme:
            continue
        sig = bucketing.bucket_sig(scheme)
        assert sig == ref_bucketing.bucket_sig(scheme)
        assert bucketing.parse_bucket_sig(sig) == \
            ref_bucketing.parse_bucket_sig(sig) == scheme
        for a, b in zip(bucketing.assign_buckets(deg, scheme),
                        ref_bucketing.assign_buckets(deg, scheme)):
            assert_bytes_equal(a, b, f"assign_buckets {sig}")
        assert bucketing.bucket_occupancy(deg, scheme) == \
            ref_bucketing.bucket_occupancy(deg, scheme)
    for platform, ref_platform in (("cuda", "tpu"), ("cpu", "cpu")):
        assert bucketing.bucket_candidates(to_port(g), platform) == \
            _mapped(ref_bucketing.bucket_candidates(g, ref_platform))
        assert bucketing.bucket_layer_candidates(
            to_port(g), platform, 1433, 16) == _mapped(
            ref_bucketing.bucket_layer_candidates(g, ref_platform, 1433, 16))


def test_launcher_graph_races_the_two_bucketed_candidates():
    """On the launcher's graph the card's grid gains exactly the bucketed
    candidates the reference's accelerator grid gains."""
    assert bucketing.bucket_layer_candidates(to_port(_CORA), "cuda", 1433,
                                             16) == [
        ("aggregate_first", True, "cuda", 256, True, "128@7+256"),
        ("aggregate_first", True, "cuda", 512, True, "128@7+512")]


@pytest.mark.parametrize("sig", ["", "64@8+256", "16@2+32@9+64",
                                 "128@7+512"])
def test_signatures_and_candidates_round_trip(sig):
    assert bucketing.bucket_sig(bucketing.parse_bucket_sig(sig)) == sig
    for parts in (("cuda", 128, True), ("torch", 64, False)):
        c = bucketing.make_graph_cand(*parts, sig)
        assert c == ref_bucketing.make_graph_cand(*parts, sig)
        assert bucketing.split_graph_cand(c) == \
            ref_bucketing.split_graph_cand(c)
        lc = bucketing.make_layer_cand("update_first", False, *parts, sig)
        assert lc == ref_bucketing.make_layer_cand("update_first", False,
                                                   *parts, sig)
        assert bucketing.split_layer_cand(lc) == \
            ref_bucketing.split_layer_cand(lc)
        assert bucketing.quarantine_class(parts[0], sig) == \
            ref_bucketing.quarantine_class(parts[0], sig)


@pytest.mark.parametrize("bad", ["64@8+32@4+128", "64+128", "0@3+64",
                                 "64@-1+128"])
def test_bad_signatures_raise_like_reference(bad):
    with pytest.raises(ValueError):
        ref_bucketing.parse_bucket_sig(bad)
    with pytest.raises(ValueError):
        bucketing.parse_bucket_sig(bad)


# ---------------------------------------------------------------------------
# bucketed plans
# ---------------------------------------------------------------------------
# (graph, signature): the skewed graph's hub in its own bucket, and a
# random graph split three ways with one empty middle bucket
PLAN_CASES = [("skewed", "16@3+32"), ("random", "8@4+16@5+32")]


def _x(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("gname,sig", PLAN_CASES)
@pytest.mark.parametrize("mode", ["gcn", "mean"])
def test_bucketed_plan_value_and_gradient_match_reference(gname, sig, mode):
    g = GRAPHS[gname]
    d = 12
    x, proj = _x(g.num_nodes, d, 1), _x(g.num_nodes, d, 5)
    for ref_backend, port_backend in (("pallas", "cuda"), ("jnp", "torch")):
        rp = ref_build_plan(g, mode, backend=ref_backend, buckets=sig,
                            interpret=True)
        y_ref = np.asarray(rp.apply(jnp.asarray(x)))
        dx_ref = np.asarray(jax.grad(lambda x: jnp.sum(rp.apply(x) * proj))(
            jnp.asarray(x)))
        p = build_plan(to_port(g), mode, backend=port_backend, buckets=sig,
                       device="cpu")
        assert (p.buckets, p.bm, p.compact) == (rp.buckets, rp.bm, True)
        assert p.n_active == rp.n_active and p.grid_size == rp.grid_size
        desc, ref_desc = p.describe(), rp.describe()
        for k in ("buckets", "bucket_occupancy", "grid_size", "plan_bytes"):
            assert desc[k] == ref_desc[k], k
        assert [m.W for m in p.meta_bwd.buckets] == \
            [m.W for m in rp.meta_bwd.buckets]     # the transpose re-buckets
        launches = sk.spmm_blockell_compact.launches
        xt = torch.as_tensor(x).requires_grad_()
        y = p.apply(xt)
        (y * torch.as_tensor(proj)).sum().backward()
        assert sk.spmm_blockell_compact.launches == launches
        _close(y.detach().numpy(), y_ref, f"{port_backend} value")
        _close(xt.grad.numpy(), dx_ref, f"{port_backend} gradient")


@pytest.mark.parametrize("gname,sig", PLAN_CASES)
@pytest.mark.parametrize("epilogue", ["none", "two_w", "self_coeff"])
def test_bucketed_fused_layer_matches_reference(gname, sig, epilogue):
    """One compact update launch per bucket (x_self / x_diag / s_in_diag
    gathered into bucket order), the re-bucketed transpose plan backward:
    values and every gradient against the reference's bucketed fused
    layer."""
    g = GRAPHS[gname]
    mode, relu, bias = {"none": ("gcn", True, True),
                        "two_w": ("mean", False, True),
                        "self_coeff": ("sum", True, False)}[epilogue]
    d_in, d_out = 10, 6
    rng = np.random.default_rng(11)
    mat = lambda a, b: (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
        np.float32)
    vals = {"x": _x(g.num_nodes, d_in, 3), "w": mat(d_in, d_out)}
    if bias:
        vals["b"] = rng.standard_normal(d_out).astype(np.float32)
    if epilogue == "two_w":
        vals["ws"] = mat(d_in, d_out)
    if epilogue == "self_coeff":
        vals["c"] = np.float32(1.3)
    names = list(vals)
    proj = _x(g.num_nodes, d_out, 6)

    def call(apply, v):
        ws = v.get("ws", v["w"] if "c" in v else None)
        return apply(v["x"], v["w"], v.get("b"), relu=relu, w_self=ws,
                     self_coeff=v.get("c"))

    ref_lp = ref_build_layer_plan(g, mode, d_in=d_in, d_out=d_out,
                                  order="aggregate_first", fuse=True,
                                  backend="pallas", buckets=sig,
                                  interpret=True)

    def ref_loss(*v):
        y = call(ref_lp.apply, dict(zip(names, v)))
        return jnp.sum(y * jnp.asarray(proj)), y

    (_, ref_y), ref_grads = jax.value_and_grad(
        ref_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(vals[k]) for k in names))
    lp = build_layer_plan(to_port(g), mode, d_in=d_in, d_out=d_out,
                          order="aggregate_first", backend="cuda",
                          buckets=sig, device="cpu")
    assert lp.fuse and lp.gplan.buckets == sig
    tv = {k: torch.tensor(np.asarray(vals[k])).requires_grad_()
          for k in names}
    y = call(lp.apply, tv)
    (y * torch.as_tensor(proj)).sum().backward()
    _close(y.detach().numpy(), ref_y, "value")
    for k, rg in zip(names, ref_grads):
        _close(tv[k].grad.numpy(), rg, f"d{k}")


def test_bucketed_plans_validate_like_reference():
    g = to_port(GRAPHS["skewed"])
    with pytest.raises(ValueError, match="coo"):
        build_plan(g, "gcn", backend="coo", buckets="16@3+32", device="cpu")
    with pytest.raises(ValueError, match="compaction"):
        build_plan(g, "gcn", backend="cuda", compact=False,
                   buckets="16@3+32", device="cpu")
    with pytest.raises(ValueError, match="square"):
        build_plan(g, "gcn", bm=16, bk=32, device="cpu")
    # a bucketed plan's tile is its largest bucket's, whatever bm says
    p = build_plan(g, "sum", bm=128, backend="torch", buckets="16@3+32",
                   device="cpu")
    assert (p.bm, p.bk) == (32, 32)
