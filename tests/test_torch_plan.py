"""The port's forward execution plans against the reference's.

``GraphExecutionPlan`` forward on the port's ``cuda`` (kernel; its plain
version on CPU tensors), ``torch`` (the plain version on float32 tiles) and
``coo`` backends, in gcn and mean modes, against the reference's
``pallas``-interpret, ``jnp`` and ``coo`` plans on the same graphs and
inputs; then ``LayerExecutionPlan.apply`` in both computation orders.
Tolerance 1e-5 (fp32 sums in another order).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.exec import build_layer_plan as ref_build_layer_plan
from repro.exec import build_plan as ref_build_plan
from repro.exec.plan import choose_order as ref_choose_order
from repro_torch.exec import build_layer_plan, build_plan, choose_order
from repro_torch.kernels import spmm_blockell as sk

from _torch_parity import GRAPHS, to_port

TOL = 1e-5
BM = 32
PORT_BACKENDS = ["cuda", "torch", "coo"]


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
    # the offsets handed to the kernel cover every active slot
    offs = p._fwd["row_offsets"]
    assert offs.dtype == torch.int32 and int(offs[-1]) == p.n_active


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
    with pytest.raises(NotImplementedError, match="backward"):
        p.apply(torch.zeros(g.num_nodes, 4, requires_grad=True))


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
