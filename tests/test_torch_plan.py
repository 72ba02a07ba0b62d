"""The port's execution plans against the reference's.

``GraphExecutionPlan`` forward and gradient on the port's ``cuda`` (kernel;
its plain version on CPU tensors), ``torch`` (the plain version on float32
tiles) and ``coo`` backends against the reference's ``pallas``-interpret,
``jnp`` and ``coo`` plans and their custom VJP, on the same graphs and
inputs; then ``LayerExecutionPlan.apply`` in both computation orders, fused
and unfused, with its hand-written backward against ``jax.grad`` of the
reference's layer plan; then the per-layer schedule against the reference's
whole-forward DP.  Tolerance 1e-5 (fp32 sums in another order), the
reference's own (``tests/test_exec_layer.py``).  Layer values and gradients
are held to 1e-5 of the largest entry of each compared array
(``_assert_close_scaled``): dW_self = xᵀḡ on the skewed graph sums 1024
products of magnitude ~1 into entries up to ~60, so an entry near zero
carries ~1e-5 of rounding whatever order the sum takes.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.exec import build_layer_plan as ref_build_layer_plan
from repro.exec import build_plan as ref_build_plan
from repro.exec.plan import choose_order as ref_choose_order
from repro_torch.exec import build_layer_plan, build_plan, choose_order
from repro_torch.kernels import spmm_blockell as sk

from _torch_parity import GRAPHS, to_port

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

TOL = 1e-5
BM = 32
PORT_BACKENDS = ["cuda", "torch", "coo"]


def _assert_close_scaled(got, ref, what):
    """|got - ref| <= TOL * max(1, max|ref|) entrywise."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _x(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _ref_outputs(gname, mode, d):
    """The reference's three plans on one input: name -> numpy output."""
    g = GRAPHS[gname]
    x = jnp.asarray(_x(g.num_nodes, d, 1))
    out = {}
    for backend in ("pallas", "jnp", "coo"):
        p = ref_build_plan(g, mode, bm=BM, backend=backend, compact=True,
                           interpret=True)
        out[backend] = np.asarray(p.apply(x))
    return out


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["gcn", "mean"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_graph_plan_matches_reference(gname, mode, backend):
    g = GRAPHS[gname]
    d = 24
    p = build_plan(to_port(g), mode, bm=BM, backend=backend, device="cpu")
    y = p.apply(torch.as_tensor(_x(g.num_nodes, d, 1))).numpy()
    for ref_backend, ref in _ref_outputs(gname, mode, d).items():
        np.testing.assert_allclose(y, ref, atol=TOL, rtol=TOL,
                                   err_msg=f"vs reference {ref_backend}")


def test_cuda_backend_geometry_matches_reference():
    g = GRAPHS["skewed"]
    p = build_plan(to_port(g), "gcn", bm=64, backend="cuda", device="cpu")
    ref = ref_build_plan(g, "gcn", bm=64, backend="pallas", interpret=True)
    assert p.n_active == p.grid_size == ref.n_active == ref.grid_size
    assert p.meta_fwd.R == ref.meta_fwd.R and p.meta_fwd.C == ref.meta_fwd.C
    assert p.describe(16)["nnz"] == ref.describe(16)["nnz"]
    # the offsets of the plan's tiles cover every active slot; the lists
    # the kernel is handed cover every set entry
    offs = chip_smoke.tile_arrays(p)["row_offsets"]
    assert offs.dtype == torch.int32 and int(offs[-1]) == p.n_active
    assert p.meta_fwd.lists and "blocks" not in p._fwd
    ptr = p._fwd["row_ptr"]
    assert ptr.dtype == torch.int32 and int(ptr[-1]) == p.describe(16)["nnz"]


def test_cpu_plan_never_launches_the_kernel():
    g = GRAPHS["random"]
    p = build_plan(to_port(g), "gcn", bm=BM, backend="cuda", device="cpu")
    before = sk.spmm_blockell_compact.launches
    p.apply(torch.zeros(g.num_nodes, 4))
    assert sk.spmm_blockell_compact.launches == before


def test_plan_rejects_bad_configs():
    g = to_port(GRAPHS["random"])
    with pytest.raises(ValueError, match="square"):
        build_plan(g, "gcn", bm=32, bk=64, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        build_plan(g, "gcn", backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        build_plan(g, "max", device="cpu")
    p = build_plan(g, "gcn", bm=BM, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="nodes"):
        p.apply(torch.zeros(g.num_nodes + 1, 4))
    # the kernel backend back-propagates through its transpose plan
    x = torch.ones(g.num_nodes, 4)
    p.apply(x.requires_grad_()).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("order", ["aggregate_first", "update_first"])
@pytest.mark.parametrize("backend", ["cuda", "torch", "coo"])
def test_layer_plan_matches_reference(gname, order, backend):
    g = GRAPHS[gname]
    d_in, d_out = 20, 12
    rng = np.random.default_rng(7)
    x = _x(g.num_nodes, d_in, 3)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    lp = build_layer_plan(to_port(g), "gcn", d_in=d_in, d_out=d_out,
                          order=order, bm=BM, backend=backend, device="cpu")
    assert lp.order == order
    for relu in (True, False):
        y = lp.apply(torch.as_tensor(x), torch.as_tensor(w),
                     torch.as_tensor(b), relu=relu).numpy()
        for ref_backend in ("pallas", "jnp", "coo"):
            ref_lp = ref_build_layer_plan(
                g, "gcn", d_in=d_in, d_out=d_out, order=order, fuse=False,
                bm=BM, backend=ref_backend, interpret=True)
            ref = np.asarray(ref_lp.apply(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), relu=relu))
            np.testing.assert_allclose(
                y, ref, atol=TOL, rtol=TOL,
                err_msg=f"{ref_backend} relu={relu}")


def test_layer_plans_share_one_graph_plan():
    g = to_port(GRAPHS["random"])
    l1 = build_layer_plan(g, "gcn", d_in=16, d_out=8, bm=BM, device="cpu",
                          backend="torch")
    l2 = build_layer_plan(g, "gcn", d_in=8, d_out=4, gplan=l1.gplan,
                          device="cpu")
    assert l2.gplan is l1.gplan
    with pytest.raises(ValueError, match="mode"):
        build_layer_plan(g, "mean", d_in=8, d_out=4, gplan=l1.gplan,
                         device="cpu")
    with pytest.raises(ValueError, match="W"):
        l1.apply(torch.zeros(g.num_nodes, 16), torch.zeros(8, 16))


@pytest.mark.parametrize("n,e,d_in,d_out", [
    (2708, 10556, 1433, 64), (2708, 10556, 64, 16), (300, 2000, 16, 128),
    (1024, 2047, 32, 32), (100, 50, 8, 7)])
def test_choose_order_matches_reference(n, e, d_in, d_out):
    assert choose_order(n, e, d_in, d_out) == ref_choose_order(n, e, d_in,
                                                               d_out)


@pytest.mark.parametrize("backend", ["cuda", "torch", "coo"])
def test_gcn_apply_matches_reference_on_masked_graph(backend):
    """Both executors of the port's GCN against the reference's segment
    executor, on a graph with padding edges masked out."""
    import dataclasses
    from repro.models.gcn import gcn_apply as ref_gcn_apply
    from repro.models.gcn import make_graph_inputs as ref_graph_inputs
    from repro_torch.models.gcn import gcn_apply, make_graph_inputs

    g = GRAPHS["skewed"]
    g = dataclasses.replace(g, edge_mask=np.arange(g.num_edges) % 5 != 0)
    dims = [12, 8, 4]
    rng = np.random.default_rng(9)
    params = {"layers": [
        {"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
         "b": rng.standard_normal(b).astype(np.float32)}
        for a, b in zip(dims[:-1], dims[1:])]}
    x = _x(g.num_nodes, dims[0], 4)
    ref = np.asarray(ref_gcn_apply(
        {"layers": [{k: jnp.asarray(v) for k, v in p.items()}
                    for p in params["layers"]]},
        jnp.asarray(x), ref_graph_inputs(g), executor="segment"))
    tparams = {"layers": [{k: torch.as_tensor(v) for k, v in p.items()}
                          for p in params["layers"]]}
    pg = to_port(g)
    seg = gcn_apply(tparams, torch.as_tensor(x), make_graph_inputs(pg, device="cpu"),
                    executor="segment")
    plans, gplan = [], None
    for a, b in zip(dims[:-1], dims[1:]):
        plans.append(build_layer_plan(pg, "gcn", d_in=a, d_out=b, bm=BM,
                                      backend=backend, gplan=gplan,
                                      device="cpu"))
        gplan = plans[-1].gplan
    fused = gcn_apply(tparams, torch.as_tensor(x), executor="fused",
                      plans=plans)
    for name, y in (("segment", seg), ("fused", fused)):
        np.testing.assert_allclose(y.numpy(), ref, atol=TOL, rtol=TOL,
                                   err_msg=name)
    with pytest.raises(ValueError, match="one LayerExecutionPlan per layer"):
        gcn_apply(tparams, torch.as_tensor(x), executor="fused",
                  plans=plans[:1])


# ---------------------------------------------------------------------------
# backward: the aggregation's gradient, then whole layers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_vjp(gname, mode, d):
    """The reference pallas-interpret plan's custom VJP of ⟨F(x), proj⟩."""
    g = GRAPHS[gname]
    p = ref_build_plan(g, mode, bm=BM, backend="pallas", compact=True,
                       interpret=True)
    proj = jnp.asarray(_x(g.num_nodes, d, 5))
    return np.asarray(jax.grad(lambda x: jnp.sum(p.apply(x) * proj))(
        jnp.asarray(_x(g.num_nodes, d, 1))))


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_graph_plan_gradient_matches_reference_vjp(gname, mode, backend):
    g = GRAPHS[gname]
    d = 24
    p = build_plan(to_port(g), mode, bm=BM, backend=backend, device="cpu")
    x = torch.as_tensor(_x(g.num_nodes, d, 1)).requires_grad_()
    (p.apply(x) * torch.as_tensor(_x(g.num_nodes, d, 5))).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), _ref_vjp(gname, mode, d),
                               atol=TOL, rtol=TOL)


# (epilogue, plan mode, relu, bias): GCN's plain layer, SAGE's two-W layer,
# GIN's self-coefficient layer with the same W on both halves
EPILOGUES = {"none": ("gcn", True, True),
             "two_w": ("mean", False, True),
             "self_coeff": ("sum", True, False)}


def _layer_operands(g, epilogue, d_in=20, d_out=12):
    rng = np.random.default_rng(11)
    mat = lambda a, b: (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
        np.float32)
    ops = {"x": _x(g.num_nodes, d_in, 3), "w": mat(d_in, d_out),
           "b": rng.standard_normal(d_out).astype(np.float32),
           "proj": _x(g.num_nodes, d_out, 6)}
    if epilogue == "two_w":
        ops["ws"] = mat(d_in, d_out)
    if epilogue == "self_coeff":
        ops["c"] = np.float32(1.3)
    return ops


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("order,fuse", [("aggregate_first", True),
                                        ("aggregate_first", False),
                                        ("update_first", False)])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_layer_plan_value_and_grads_match_reference(gname, order, fuse,
                                                    epilogue):
    """Values and the gradient of every operand, self_coeff included; with
    ``w_self=w`` both gradient paths sum into W on both sides."""
    g = GRAPHS[gname]
    mode, relu, bias = EPILOGUES[epilogue]
    ops = _layer_operands(g, epilogue)
    d_in, d_out = ops["w"].shape
    names = ["x", "w"] + (["b"] if bias else []) + \
        [k for k in ("ws", "c") if k in ops]

    def call(apply, v):
        ws = v.get("ws", v["w"] if "c" in v else None)
        return apply(v["x"], v["w"], v.get("b"), relu=relu, w_self=ws,
                     self_coeff=v.get("c"))

    ref_lp = ref_build_layer_plan(g, mode, d_in=d_in, d_out=d_out,
                                  order=order, fuse=fuse, bm=BM,
                                  backend="pallas", interpret=True)
    proj = jnp.asarray(ops["proj"])

    def ref_loss(*vals):
        y = call(ref_lp.apply, dict(zip(names, vals)))
        return jnp.sum(y * proj), y

    (_, ref_y), ref_grads = jax.value_and_grad(
        ref_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(ops[k]) for k in names))

    lp = build_layer_plan(to_port(g), mode, d_in=d_in, d_out=d_out,
                          order=order, fuse=fuse, bm=BM, backend="cuda",
                          device="cpu")
    assert (lp.order, lp.fuse) == (order, fuse)
    tv = {k: torch.tensor(np.asarray(ops[k])).requires_grad_() for k in names}
    y = call(lp.apply, tv)
    (y * torch.as_tensor(ops["proj"])).sum().backward()
    _assert_close_scaled(y.detach().numpy(), ref_y, "value")
    for k, rg in zip(names, ref_grads):
        _assert_close_scaled(tv[k].grad.numpy(), rg, f"d{k}")


def test_fused_layer_needs_the_kernel_backend_and_aggregate_first():
    g = to_port(GRAPHS["random"])
    assert build_layer_plan(g, "sum", d_in=16, d_out=16, bm=BM,
                            backend="cuda", device="cpu").fuse
    assert not build_layer_plan(g, "sum", d_in=16, d_out=16, bm=BM,
                                backend="torch", device="cpu").fuse
    for backend, order in (("torch", "aggregate_first"),
                           ("coo", "aggregate_first"),
                           ("cuda", "update_first")):
        with pytest.raises(ValueError, match="fuse"):
            build_layer_plan(g, "sum", d_in=16, d_out=16, order=order,
                             fuse=True, bm=BM, backend=backend, device="cpu")


@pytest.mark.parametrize("model", ["gcn-cora", "gin"])
def test_schedule_matches_reference_dp(model):
    """The port's per-layer ``order="auto"`` plans on the reordered Cora pick
    the (order, fuse) the reference's whole-forward DP picks on the TPU
    candidate grid (cold, uncalibrated), with pallas read as cuda."""
    from repro.core import minhash_reorder as ref_minhash
    from repro.exec.forward import (build_cost_oracle, dp_schedule, gcn_chain,
                                    gin_chain)
    from repro.graph import cora_like as ref_cora_like
    from repro_torch.core import minhash_reorder
    from repro_torch.graph import cora_like

    g_ref = ref_cora_like().permute(ref_minhash(ref_cora_like()))
    specs = (gcn_chain([1433, 16, 7]) if model == "gcn-cora"
             else gin_chain(1433, 128, 5))
    _, sched = dp_schedule(build_cost_oracle(
        g_ref, specs, platform="tpu", use_cache=False, use_calibration=False,
        respect_quarantine=False))
    g = cora_like().permute(minhash_reorder(cora_like()))
    gplan = None
    port = []
    for s in specs:
        lp = build_layer_plan(g, s.mode, d_in=s.d_in, d_out=s.d_out,
                              order="auto", bm=128, backend="cuda",
                              gplan=gplan, device="cpu")
        gplan = lp.gplan
        port.append((lp.order, lp.fuse, lp.backend, lp.gplan.bm, True))
    expected = [(o, f, "cuda" if b == "pallas" else b, bm, c)
                for o, f, b, bm, c in sched]
    assert port == expected
