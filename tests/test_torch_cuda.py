"""The port on the card: each CUDA kernel against its plain version (the
compact kernels at bm 16-512, with and without the bucket overrides; the
padded kernels ``spmm_blockell``, ``spmm_blockell_fused`` and
``spmm_blockell_update``; ``embedding_bag``, ``sddmm`` and
``decode_attention``), the plans' backwards through the kernels (compact,
padded and degree-bucketed) and ``ops.embedding_bag``'s transposed
backward, GraphSAGE's two-W layer plans forward and backward and its
serving session, a tiny autotune on the card, the serving slice, wide & deep's
``bag`` lookup against its ``dense`` one, an LM decode step with the
kernel against the plain attention, and the reuse layer: ``blockell_aggregate``
(``spmm_blockell`` forward, the same kernel over Aᵀ backward) and GCN's
bare-``BlockEll`` path against their plain versions, and the shared-set
executor, which launches no kernel.  LM training on the card (no kernel of
the port): the donated (in-place) ``train_4k`` step against the functional
one, ``lm_loss``'s remat and chunks against the plain cross-entropy, a
checkpoint of card tensors restored on the CPU bit-equal, and the
``Prefetcher``'s side-stream copies.  The fallback chain and the GNN zoo:
weighted ``sum`` plans (float32 tiles) on ``cuda`` against ``torch``,
values and gradients; ``ResilientPlan``'s two drills on the card; the
float64 loss and gradients of GAT, PNA and NequIP on the card against the
CPU.  The MoE LMs at ``REDUCED``: decode steps with the kernel against the
plain attention (logits and routes), and bit-identical reruns of a decode
step and of ``lm_loss`` with its gradients.

Every test here needs an NVIDIA GPU with nvcc; it is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false.  The file imports
neither jax nor the reference package, so it also runs where only the port
is installed (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Kernel against plain version: 1e-5 (fp32 sums of at most a row's slots x bk
terms in another order); the layer kernel at d_in = 1433 sums 1433 products
more per output, so it is held to 1e-4 there.  Plans on the ``cuda``
backend against the ``torch`` backend, values and gradients: 1e-4 (sums of
up to 1433 terms, then a second product).  Served answers against the
kernel-computed oracle: 1e-4, the launcher's own bar.  Decode attention
against its plain version: fp32 1e-4 and bf16 3e-2, the reference's bars
(``tests/test_kernels.py``), each times the largest |entry| of its (b, h)
row.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import build_blockell, minhash_reorder
from repro_torch.exec import build_layer_plan, build_plan
from repro_torch.graph import DatasetSpec, Graph, cora_like, synthesize
from repro_torch.kernels import spmm_blockell as sk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (spmm_blockell_compact_ref,
                                     spmm_blockell_fused_ref,
                                     spmm_blockell_ref,
                                     spmm_blockell_update_compact_ref,
                                     spmm_blockell_update_ref)
from repro_torch.serve import (EmbeddingCache, MicroBatcher, ServeEngine,
                               make_session, zipfian_trace)

pytestmark = pytest.mark.cuda
TOL = 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _random_graph(n=300, e=2000, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    return Graph(src=rng.integers(0, n, e).astype(np.int32),
                 dst=rng.integers(0, n, e).astype(np.int32), num_nodes=n,
                 edge_weight=(rng.random(e).astype(np.float32) if weighted
                              else None))


def _case(g, bm, d, tiles, override, seed=0):
    ell = build_blockell(g, bm=bm, bk=bm,
                         storage="auto" if tiles == "u8" else "dense")
    comp = ell.compact(np.uint8 if tiles == "u8" else np.float32)
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    t = lambda a: None if a is None else torch.as_tensor(a).cuda()
    xd = rng.standard_normal((n, d)).astype(np.float32) if override else None
    sd = rng.uniform(0.2, 1, n).astype(np.float32) if override else None
    args = (t(comp.row_offsets.astype(np.int32)), t(comp.cols),
            t(comp.blocks), t(rng.standard_normal((n, d)).astype(np.float32)),
            t(rng.uniform(0.2, 1, n).astype(np.float32)),
            t(rng.uniform(0.2, 1, n).astype(np.float32)), t(xd), t(sd))
    written = t(np.repeat(comp.row_active, bm)[:n])
    return args, written


@pytest.mark.parametrize("bm", [16, 32, 128])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("d,add_diag,override", [
    (64, True, False), (16, True, False), (72, False, False),
    (5, True, True), (200, True, True)])
def test_kernel_matches_plain_version(bm, tiles, d, add_diag, override):
    _need_cuda()
    g = _random_graph(weighted=tiles == "f32")
    args, written = _case(g, bm, d, tiles, override)
    kw = dict(bm=bm, bk=bm, add_diag=add_diag)
    before = sk.spmm_blockell_compact.launches
    y = sk.spmm_blockell_compact(*args, **kw)
    torch.cuda.synchronize()
    assert sk.spmm_blockell_compact.launches == before + 1
    ref = spmm_blockell_compact_ref(*args, **kw)
    torch.testing.assert_close(y[written], ref[written], atol=TOL, rtol=TOL)
    # no atomics: a second run is bit-identical
    assert torch.equal(sk.spmm_blockell_compact(*args, **kw)[written],
                       y[written])


def test_kernel_rejects_tensors_on_two_devices():
    _need_cuda()
    args, _ = _case(_random_graph(), 32, 16, "u8", False)
    args = list(args)
    args[4] = args[4].cpu()
    with pytest.raises(ValueError, match="x is on"):
        sk.spmm_blockell_compact(*args, bm=32, bk=32, add_diag=True)


@pytest.mark.parametrize("mode", ["gcn", "mean", "sum"])
def test_cuda_plan_matches_torch_plan_on_cora(mode):
    _need_cuda()
    g = cora_like(seed=0)
    x = torch.randn(g.num_nodes, 64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    y = build_plan(g, mode, bm=128, backend="cuda", device="cuda").apply(x)
    ref = build_plan(g, mode, bm=128, backend="torch", device="cuda").apply(x)
    torch.testing.assert_close(y, ref, atol=TOL, rtol=TOL)


def test_session_serves_through_the_kernel():
    _need_cuda()
    g = synthesize(DatasetSpec("t", 600, 4000, 32, 4, community=0.9,
                               num_communities=6, seed=4))
    sess = make_session("gcn", g, hidden=16, out_dim=8, device="cuda")
    cpu = make_session("gcn", g, hidden=16, out_dim=8, device="cpu",
                       params={"layers": [{k: v.cpu() for k, v in p.items()}
                                          for p in sess.params["layers"]]})
    sk.spmm_blockell_compact.launches = 0
    np.testing.assert_allclose(sess.layer_values(2), cpu.layer_values(2),
                               atol=1e-4, rtol=1e-4)
    assert sk.spmm_blockell_compact.launches == 2     # one per layer
    cache = EmbeddingCache(sess.layer_dims, 60_000, num_nodes=g.num_nodes)
    eng = ServeEngine(sess, cache, MicroBatcher(max_batch=8, max_wait=1e-3))
    rep = eng.serve(zipfian_trace(g.num_nodes, 80, seed=1))
    assert rep.num_requests == 80 and rep.max_oracle_err < 1e-4


# ---------------------------------------------------------------------------
# spmm_blockell_update_compact
# ---------------------------------------------------------------------------
# (d_in, d_out, add_diag, epilogue, overrides): d_in 16 / 128 / 1433 (the
# chunk loop), d_out 200 (two output strips), GIN's w_self-is-w epilogue,
# SAGE's two W, and the bucket overrides
UPDATE_CASES = [(16, 7, True, "none", False),
                (128, 128, False, "self_coeff", False),
                (1433, 16, True, "none", False),
                (64, 200, False, "two_w", False),
                (128, 128, True, "self_coeff", True),
                (1433, 130, True, "two_w", True)]


def _update_case(g, bm, tiles, d_in, d_out, add_diag, epilogue, override,
                 seed=0):
    (ro, cols, blocks, _, s_in, s_out, _, _), written = _case(
        g, bm, 1, tiles, False, seed)
    rng = np.random.default_rng(seed + 1)
    n = g.num_nodes
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).cuda()
    mat = lambda a, b: t(rng.standard_normal((a, b)) / np.sqrt(a))
    x, w, b = (t(rng.standard_normal((n, d_in))), mat(d_in, d_out),
               t(rng.standard_normal(d_out)))
    # no bias at d_out = 7 and no ReLU at d_in = 64: both epilogue flags
    # are seen on and off
    kw = {"bias": b if d_out != 7 else None, "w_self": None,
          "self_coeff": None, "x_self": None, "x_diag": None,
          "s_in_diag": None}
    if epilogue == "two_w":
        kw["w_self"] = mat(d_in, d_out)
    elif epilogue == "self_coeff":
        kw["w_self"], kw["self_coeff"] = w, t(1.3)
    if override:
        if kw["w_self"] is not None:
            kw["x_self"] = t(rng.standard_normal((n, d_in)))
        if add_diag:
            kw["x_diag"] = t(rng.standard_normal((n, d_in)))
            kw["s_in_diag"] = t(rng.uniform(0.2, 1, n))
    args = (ro, cols, blocks, x, s_in, s_out, w)
    opts = dict(bm=bm, bk=bm, add_diag=add_diag, relu=d_in != 64)
    return args, kw, opts, written


@pytest.mark.parametrize("bm", [32, 128])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("d_in,d_out,add_diag,epilogue,override",
                         UPDATE_CASES)
def test_update_kernel_matches_plain_version(bm, tiles, d_in, d_out,
                                             add_diag, epilogue, override):
    _need_cuda()
    g = _random_graph(weighted=tiles == "f32")
    args, kw, opts, written = _update_case(g, bm, tiles, d_in, d_out,
                                           add_diag, epilogue, override)
    before = sk.spmm_blockell_update_compact.launches
    y = sk.spmm_blockell_update_compact(*args, **kw, **opts)
    torch.cuda.synchronize()
    assert sk.spmm_blockell_update_compact.launches == before + 1
    assert y.shape == (g.num_nodes, d_out)
    ref = spmm_blockell_update_compact_ref(*args, **kw, **opts)
    tol = 1e-4 if d_in > 128 else TOL
    torch.testing.assert_close(y[written], ref[written], atol=tol, rtol=tol)
    # no atomics: a second run is bit-identical
    again = sk.spmm_blockell_update_compact(*args, **kw, **opts)
    assert torch.equal(again[written], y[written])


@pytest.mark.parametrize("bad", ["dtype", "device", "contiguity"])
def test_update_kernel_wrapper_rejects_bad_operands(bad):
    _need_cuda()
    args, kw, opts, _ = _update_case(_random_graph(), 32, "u8", 16, 8, True,
                                     "two_w", False)
    args = list(args)
    if bad == "dtype":
        args[6] = args[6].double()
    elif bad == "device":
        kw["w_self"] = kw["w_self"].cpu()
    else:
        args[6] = args[6].T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        sk.spmm_blockell_update_compact(*args, **kw, **opts)


def _leaves(*ts):
    return [t.detach().clone().requires_grad_() for t in ts]


@pytest.mark.parametrize("mode", ["gcn", "sum"])
def test_graph_plan_gradient_on_the_card(mode):
    _need_cuda()
    g = cora_like(seed=0)
    gen = torch.Generator("cuda").manual_seed(1)
    x0 = torch.randn(g.num_nodes, 16, device="cuda", generator=gen)
    proj = torch.randn(g.num_nodes, 16, device="cuda", generator=gen)
    grads = {}
    for backend in ("cuda", "torch"):
        (x,) = _leaves(x0)
        (build_plan(g, mode, bm=128, backend=backend, device="cuda")
         .apply(x) * proj).sum().backward()
        grads[backend] = x.grad
    torch.testing.assert_close(grads["cuda"], grads["torch"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("mode,d_in,d_out,epilogue", [
    ("gcn", 1433, 16, "none"),          # gcn-cora layer 0: update-first
    ("sum", 128, 128, "self_coeff"),    # GIN convs 2-5: fused
    ("mean", 64, 16, "two_w")])         # SAGE's two-W layer, update-first
def test_layer_plan_autograd_on_the_card(mode, d_in, d_out, epilogue):
    """Both layer plans on the kernel backend against the plain backend on
    the card: values and the gradient of every operand."""
    _need_cuda()
    g0 = cora_like(seed=0)
    g = g0.permute(minhash_reorder(g0))
    gen = torch.Generator("cuda").manual_seed(2)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x0, w0, b0 = r(g.num_nodes, d_in), r(d_in, d_out) / d_in ** 0.5, r(d_out)
    ws0 = r(d_in, d_out) / d_in ** 0.5 if epilogue == "two_w" else None
    proj = r(g.num_nodes, d_out)
    out = {}
    for backend in ("cuda", "torch"):
        lp = build_layer_plan(g, mode, d_in=d_in, d_out=d_out, bm=128,
                              backend=backend, device="cuda")
        if backend == "cuda" and epilogue == "self_coeff":
            assert lp.fuse
        x, w, b = _leaves(x0, w0, b0)
        ops = {"x": x, "w": w, "b": b}
        kw = {}
        if epilogue == "two_w":
            (ops["ws"],) = _leaves(ws0)
            kw["w_self"] = ops["ws"]
        elif epilogue == "self_coeff":
            (ops["c"],) = _leaves(torch.tensor(1.2, device="cuda"))
            kw.update(w_self=w, self_coeff=ops["c"])
        sk.spmm_blockell_update_compact.launches = 0
        y = lp.apply(x, w, b, relu=True, **kw)
        (y * proj).sum().backward()
        if backend == "cuda":
            assert sk.spmm_blockell_update_compact.launches == int(lp.fuse)
        out[backend] = (y.detach(), {k: v.grad for k, v in ops.items()})
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], atol=1e-4,
                               rtol=1e-4)
    for k, gk in out["cuda"][1].items():
        scale = max(1.0, float(out["torch"][1][k].abs().max()))
        torch.testing.assert_close(gk, out["torch"][1][k], rtol=0,
                                   atol=1e-4 * scale, msg=f"d{k}")


@pytest.mark.parametrize("order", ["aggregate_first", "update_first"])
def test_sage_fused_forward_and_backward_on_the_card(order):
    """GraphSAGE through the two-W layer plans on the kernel backend against
    the plain backend and the segment executor on the card: embeddings, the
    loss and every gradient.  Aggregate-first layers are one
    ``spmm_blockell_update_compact`` launch forward, update-first layers one
    ``spmm_blockell_compact``; each takes one transposed compact launch
    backward, but the first layer's (the features take no gradient)."""
    _need_cuda()
    from repro_torch.models import sage_apply, sage_init, sage_loss
    g0 = cora_like(seed=0)
    g = g0.permute(minhash_reorder(g0))
    dims = [64, 32, 7]
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn(g.num_nodes, dims[0], device="cuda", generator=gen)
    labels = torch.as_tensor(g.labels % 7, device="cuda")
    mask = torch.as_tensor(g.train_mask, device="cuda")
    params0 = sage_init(torch.Generator().manual_seed(0), dims,
                        device="cuda")
    graph = {"src": torch.as_tensor(g.src.astype(np.int64), device="cuda"),
             "dst": torch.as_tensor(g.dst.astype(np.int64), device="cuda")}
    out = {}
    for backend in ("cuda", "torch", "segment"):
        plans = None
        if backend != "segment":
            gplan = build_plan(g, "mean", bm=128, backend=backend,
                               device="cuda")
            plans = [build_layer_plan(g, "mean", d_in=a, d_out=b,
                                      order=order, gplan=gplan)
                     for a, b in zip(dims[:-1], dims[1:])]
        executor = "segment" if backend == "segment" else "fused"
        params = {"layers": [dict(zip(p, _leaves(*p.values())))
                             for p in params0["layers"]]}
        sk.spmm_blockell_compact.launches = 0
        sk.spmm_blockell_update_compact.launches = 0
        emb = sage_apply(params, x, graph, executor, plans)
        loss = sage_loss(params, x, graph, labels, mask, executor=executor,
                         plan=plans)
        loss.backward()
        if backend == "cuda":
            fused = order == "aggregate_first"
            # forward twice (sage_apply, then the loss's), backward once
            assert sk.spmm_blockell_update_compact.launches == (
                2 * 2 if fused else 0)
            assert sk.spmm_blockell_compact.launches == (
                2 if fused else 2 * 2 + 2)
        out[backend] = (emb.detach(), loss.detach(),
                        [t.grad for p in params["layers"]
                         for t in p.values()])
    for other in ("torch", "segment"):
        torch.testing.assert_close(out["cuda"][0], out[other][0], atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(out["cuda"][1], out[other][1], atol=1e-4,
                                   rtol=1e-4)
        for i, (a, b) in enumerate(zip(out["cuda"][2], out[other][2])):
            scale = max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale,
                                       msg=f"grad {i} vs {other}")


def test_sage_session_serves_through_the_kernels():
    _need_cuda()
    g = synthesize(DatasetSpec("t", 600, 4000, 32, 4, community=0.9,
                               num_communities=6, seed=4))
    sess = make_session("sage_gin", g, hidden=16, out_dim=8, device="cuda")
    cpu = make_session("sage_gin", g, hidden=16, out_dim=8, device="cpu",
                       executor="segment",
                       params={"layers": [{k: v.cpu() for k, v in p.items()}
                                          for p in sess.params["layers"]]})
    sk.spmm_blockell_compact.launches = 0
    sk.spmm_blockell_update_compact.launches = 0
    for l in (1, 2):
        np.testing.assert_allclose(sess.layer_values(l), cpu.layer_values(l),
                                   atol=1e-4, rtol=1e-4)
    # one kernel launch per layer, whichever order the DP picked
    assert (sk.spmm_blockell_compact.launches
            + sk.spmm_blockell_update_compact.launches) == 2
    cache = EmbeddingCache(sess.layer_dims, 60_000, num_nodes=g.num_nodes)
    eng = ServeEngine(sess, cache, MicroBatcher(max_batch=8, max_wait=1e-3))
    rep = eng.serve(zipfian_trace(g.num_nodes, 80, seed=1))
    assert rep.num_requests == 80 and rep.max_oracle_err < 1e-4


# ---------------------------------------------------------------------------
# the compact kernels at the bucketed tiles (bm 256 and 512)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bm", [256, 512])
@pytest.mark.parametrize("override", [False, True])
def test_compact_kernels_at_bucketed_tiles(bm, override):
    """Bucketed plans run both compact kernels at bm = bk = 256 and 512 with
    the destination overrides; on Cora, as the bucketed candidates do."""
    _need_cuda()
    g = cora_like(seed=0)
    args, written = _case(g, bm, 48, "u8", override)
    kw = dict(bm=bm, bk=bm, add_diag=True)
    y = sk.spmm_blockell_compact(*args, **kw)
    torch.cuda.synchronize()
    ref = spmm_blockell_compact_ref(*args, **kw)
    torch.testing.assert_close(y[written], ref[written], atol=TOL, rtol=TOL)
    uargs, ukw, opts, written = _update_case(g, bm, "u8", 128, 128, True,
                                             "self_coeff", override)
    opts.update(bm=bm, bk=bm)
    y = sk.spmm_blockell_update_compact(*uargs, **ukw, **opts)
    torch.cuda.synchronize()
    ref = spmm_blockell_update_compact_ref(*uargs, **ukw, **opts)
    torch.testing.assert_close(y[written], ref[written], atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the padded kernels
# ---------------------------------------------------------------------------
def _padded(g, bm, tiles, seed=0):
    ell = build_blockell(g, bm=bm, bk=bm,
                         storage="auto" if tiles == "u8" else "dense")
    t = lambda a: torch.as_tensor(a).cuda()
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    return ell, (t(ell.block_cols),
                 t(ell.dense_blocks(np.uint8 if tiles == "u8"
                                    else np.float32))), \
        (t(rng.uniform(0.2, 1, n).astype(np.float32)),
         t(rng.uniform(0.2, 1, n).astype(np.float32)))


@pytest.mark.parametrize("bm", [32, 128])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("d,add_diag", [(64, True), (7, True), (72, False),
                                        (200, True)])
def test_padded_kernels_match_plain_versions(bm, tiles, d, add_diag):
    _need_cuda()
    g = _random_graph(weighted=tiles == "f32")
    _, (cols, blocks), (s_in, s_out) = _padded(g, bm, tiles)
    x = torch.randn(g.num_nodes, d, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    before = (sk.spmm_blockell_fused.launches, sk.spmm_blockell.launches)
    y = sk.spmm_blockell_fused(cols, blocks, x, s_in, s_out, bm=bm, bk=bm,
                               add_diag=add_diag)
    z = sk.spmm_blockell(cols, blocks, x, bm=bm, bk=bm, n_dst=g.num_nodes)
    torch.cuda.synchronize()
    assert (sk.spmm_blockell_fused.launches,
            sk.spmm_blockell.launches) == (before[0] + 1, before[1] + 1)
    # every row is written, blocks with no active slot included
    torch.testing.assert_close(
        y, spmm_blockell_fused_ref(cols, blocks, x, s_in, s_out, bm=bm,
                                   bk=bm, add_diag=add_diag),
        atol=TOL, rtol=TOL)
    torch.testing.assert_close(
        z, spmm_blockell_ref(cols, blocks, x, bm=bm, bk=bm,
                             n_dst=g.num_nodes), atol=TOL, rtol=TOL)
    assert torch.equal(sk.spmm_blockell_fused(cols, blocks, x, s_in, s_out,
                                              bm=bm, bk=bm,
                                              add_diag=add_diag), y)
    assert torch.equal(sk.spmm_blockell(cols, blocks, x, bm=bm, bk=bm,
                                        n_dst=g.num_nodes), z)


# ---------------------------------------------------------------------------
# the zero-skipping walk of blockell_spmm.cuh at its worst
# ---------------------------------------------------------------------------
def _worst_case_graph(weighted, n=768, bm=128, seed=0):
    """Row 5 takes an edge from every node (a tile row of ones in each of
    the 6 source blocks: 768 listed entries, more than one warp's list);
    destination block 1 takes every edge of source block 1 (a fully dense
    tile); 2000 random edges land in rows < 512, so blocks 4 and 5 have no
    active slot."""
    rng = np.random.default_rng(seed)
    blk = np.arange(bm, 2 * bm)
    src = np.concatenate([np.arange(n), np.tile(blk, bm),
                          rng.integers(0, n, 2000)])
    dst = np.concatenate([np.full(n, 5), np.repeat(blk, bm),
                          rng.integers(0, 4 * bm, 2000)])
    _, keep = np.unique(dst * n + src, return_index=True)
    w = rng.uniform(0.1, 1, keep.size).astype(np.float32)
    return Graph(src=src[keep].astype(np.int32), dst=dst[keep].astype(np.int32),
                 num_nodes=n, edge_weight=w if weighted else None)


def _close_rows(got, ref):
    """|got - ref| <= 1e-5 of each row's largest |entry| (at least 1e-5):
    the hub row sums 768 products in another order than the plain
    version's, so its entries, and their rounding, are ~5x a mean row's."""
    bar = TOL * ref.abs().amax(-1, keepdim=True).clamp_min(1.0)
    worst = float(((got - ref).abs() / bar).max())
    assert worst <= 1.0, f"error {worst:.3g} x the bar"


@pytest.mark.parametrize("walk", ["compact", "padded"])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("d", [1, 7, 16, 33, 128, 129])
def test_zero_skipping_walk_at_dense_rows_and_hubs(walk, tiles, d):
    """All-ones tile rows, a fully dense tile and a hub row of degree 768
    (the mean is ~26) through both walks, at widths on and off the float4
    path (d = 129 takes two column strips): the kernels against their
    plain versions, one launch a call, bit-identical reruns; the compact
    walk leaves the rows of empty blocks unwritten (NaN kept), the padded
    walks write them (self term, or zero for y = A x)."""
    _need_cuda()
    g = _worst_case_graph(weighted=tiles == "f32")
    n, bm = g.num_nodes, 128
    gen = torch.Generator("cuda").manual_seed(d)
    x = torch.randn(n, d, device="cuda", generator=gen)
    s_in = torch.rand(n, device="cuda", generator=gen) + 0.2
    s_out = torch.rand(n, device="cuda", generator=gen) + 0.2
    empty = torch.arange(n, device="cuda") >= 4 * bm
    if walk == "compact":
        args, written = _case(g, bm, d, tiles, False)
        ro, cols, blocks = args[:3]
        assert bool((written == ~empty).all())
        kw = dict(bm=bm, bk=bm, add_diag=True)
        ref = spmm_blockell_compact_ref(ro, cols, blocks, x, s_in, s_out,
                                        **kw)
        before = sk.spmm_blockell_compact.launches
        y = sk.spmm_blockell_compact(ro, cols, blocks, x, s_in, s_out, **kw)
        torch.cuda.synchronize()
        assert sk.spmm_blockell_compact.launches == before + 1
        _close_rows(y[written], ref[written])
        again = sk.spmm_blockell_compact(ro, cols, blocks, x, s_in, s_out,
                                         **kw)
        assert torch.equal(again[written], y[written])
        # the raw entry point into a NaN-filled y: empty blocks stay NaN
        raw = torch.full((n, d), float("nan"), device="cuda")
        err = sk._kernel_fn("spmm_blockell_compact")(
            ro.data_ptr(), cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
            s_in.data_ptr(), s_out.data_ptr(), x.data_ptr(), s_in.data_ptr(),
            raw.data_ptr(), int(tiles == "u8"), ro.numel() - 1, n, n, bm, bm,
            d, 1, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(raw[written], y[written])
        assert bool(raw[empty].isnan().all())
        return
    _, (cols, blocks), _ = _padded(g, bm, tiles)
    before = (sk.spmm_blockell_fused.launches, sk.spmm_blockell.launches)
    y = sk.spmm_blockell_fused(cols, blocks, x, s_in, s_out, bm=bm, bk=bm,
                               add_diag=True)
    z = sk.spmm_blockell(cols, blocks, x, bm=bm, bk=bm, n_dst=n)
    torch.cuda.synchronize()
    assert (sk.spmm_blockell_fused.launches,
            sk.spmm_blockell.launches) == (before[0] + 1, before[1] + 1)
    _close_rows(y, spmm_blockell_fused_ref(cols, blocks, x, s_in, s_out,
                                           bm=bm, bk=bm, add_diag=True))
    _close_rows(z, spmm_blockell_ref(cols, blocks, x, bm=bm, bk=bm, n_dst=n))
    torch.testing.assert_close(y[empty], x[empty] * (s_in * s_out)[empty,
                                                                    None],
                               atol=TOL, rtol=TOL)
    assert not z[empty].any()
    assert torch.equal(sk.spmm_blockell_fused(cols, blocks, x, s_in, s_out,
                                              bm=bm, bk=bm, add_diag=True), y)
    assert torch.equal(sk.spmm_blockell(cols, blocks, x, bm=bm, bk=bm,
                                        n_dst=n), z)


def _offset(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("walk", ["compact", "padded"])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("ragged", ["bk=18", "offset"])
def test_zero_skipping_walk_off_16_byte_chunks(walk, tiles, ragged):
    """Where a tile row cannot be read 16 bytes at a time (bm = bk = 18 is
    no multiple of 16 uint8 or 4 fp32 entries; or tiles and x that start
    off a 16-byte boundary, which also keeps x off the float4 path), the
    walk reads one entry a lane, with the same results."""
    _need_cuda()
    g = _random_graph(n=200, e=1500, seed=3, weighted=tiles == "f32")
    bm, d = (18, 9) if ragged == "bk=18" else (16, 8)
    if walk == "compact":
        args, written = _case(g, bm, d, tiles, False)
        if ragged == "offset":
            args = (*args[:2], _offset(args[2]), _offset(args[3]), *args[4:])
        kw = dict(bm=bm, bk=bm, add_diag=True)
        y = sk.spmm_blockell_compact(*args, **kw)
        ref = spmm_blockell_compact_ref(*args, **kw)
        torch.testing.assert_close(y[written], ref[written], atol=TOL,
                                   rtol=TOL)
        assert torch.equal(sk.spmm_blockell_compact(*args, **kw)[written],
                           y[written])
        return
    _, (cols, blocks), (s_in, s_out) = _padded(g, bm, tiles)
    x = torch.randn(g.num_nodes, d, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    if ragged == "offset":
        blocks, x = _offset(blocks), _offset(x)
    torch.testing.assert_close(
        sk.spmm_blockell(cols, blocks, x, bm=bm, bk=bm, n_dst=g.num_nodes),
        spmm_blockell_ref(cols, blocks, x, bm=bm, bk=bm, n_dst=g.num_nodes),
        atol=TOL, rtol=TOL)
    torch.testing.assert_close(
        sk.spmm_blockell_fused(cols, blocks, x, s_in, s_out, bm=bm, bk=bm,
                               add_diag=True),
        spmm_blockell_fused_ref(cols, blocks, x, s_in, s_out, bm=bm, bk=bm,
                                add_diag=True), atol=TOL, rtol=TOL)


def test_padded_kernels_write_rows_of_empty_blocks():
    _need_cuda()
    rng = np.random.default_rng(2)
    g = Graph(src=rng.integers(0, 256, 400).astype(np.int32),
              dst=rng.integers(0, 32, 400).astype(np.int32), num_nodes=256)
    _, (cols, blocks), (s_in, s_out) = _padded(g, 32, "u8")
    x = torch.ones(256, 8, device="cuda")
    y = sk.spmm_blockell_fused(cols, blocks, x, s_in, s_out, bm=32, bk=32,
                               add_diag=True)
    torch.testing.assert_close(y[32:], (s_in * s_out)[32:, None].expand(
        -1, 8), atol=TOL, rtol=TOL)
    w = torch.ones(8, 3, device="cuda")
    u = sk.spmm_blockell_update(cols, blocks, x, s_in, s_out, w,
                                torch.full((3,), 0.5, device="cuda"),
                                bm=32, bk=32, add_diag=False)
    torch.testing.assert_close(u[32:], torch.full((224, 3), 0.5,
                                                  device="cuda"))


@pytest.mark.parametrize("bm", [32, 128])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("d_in,d_out,add_diag,epilogue", [
    (16, 7, True, "none"), (128, 128, False, "self_coeff"),
    (1433, 16, True, "none"), (64, 200, False, "two_w"),
    (1433, 130, True, "self_coeff")])
def test_padded_update_kernel_matches_plain_version(bm, tiles, d_in, d_out,
                                                    add_diag, epilogue):
    _need_cuda()
    g = _random_graph(weighted=tiles == "f32")
    _, (cols, blocks), (s_in, s_out) = _padded(g, bm, tiles)
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).cuda()
    mat = lambda a, b: t(rng.standard_normal((a, b)) / np.sqrt(a))
    x, w = t(rng.standard_normal((g.num_nodes, d_in))), mat(d_in, d_out)
    b = t(rng.standard_normal(d_out)) if d_out != 7 else None
    ws = c = None
    if epilogue == "two_w":
        ws = mat(d_in, d_out)
    elif epilogue == "self_coeff":
        ws, c = w, t(1.3)
    args = (cols, blocks, x, s_in, s_out, w, b, ws, c)
    kw = dict(bm=bm, bk=bm, add_diag=add_diag, relu=d_in != 64)
    before = sk.spmm_blockell_update.launches
    y = sk.spmm_blockell_update(*args, **kw)
    torch.cuda.synchronize()
    assert sk.spmm_blockell_update.launches == before + 1
    tol = 1e-4 if d_in > 128 else TOL
    torch.testing.assert_close(y, spmm_blockell_update_ref(*args, **kw),
                               atol=tol, rtol=tol)
    assert torch.equal(sk.spmm_blockell_update(*args, **kw), y)


# ---------------------------------------------------------------------------
# the zero-skipping update body (blockell_update.cuh) at its worst
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("walk", ["compact", "padded"])
@pytest.mark.parametrize("tiles", ["u8", "f32"])
@pytest.mark.parametrize("d_in,d_out,add_diag,epilogue", [
    (16, 7, False, "two_w"), (130, 128, False, "self_coeff"),
    (1433, 130, True, "none")])
def test_update_walk_at_dense_rows_and_hubs(walk, tiles, d_in, d_out,
                                            add_diag, epilogue):
    """The worst-case graph through both update walks: a row of 768 set
    entries (more than one warp's list of 512 holds: the warp gathers as
    the list fills and scans again for every 128-column chunk of d_in), a
    fully dense tile, and two blocks with no active slot, at d_in 16 (lane
    groups), 130 (two chunks, off the float4 path) and 1433 (12 chunks),
    against the plain versions row by row; one launch a call, reruns
    bit-identical; the padded walk writes the empty blocks' rows."""
    _need_cuda()
    g = _worst_case_graph(weighted=tiles == "f32")
    n, bm = g.num_nodes, 128
    empty = torch.arange(n, device="cuda") >= 4 * bm
    tol = 1e-4 if d_in > 128 else TOL
    if walk == "compact":
        args, kw, opts, written = _update_case(g, bm, tiles, d_in, d_out,
                                               add_diag, epilogue, False)
        assert bool((written == ~empty).all())
        kernel, ref_fn = (sk.spmm_blockell_update_compact,
                          spmm_blockell_update_compact_ref)
    else:
        _, (cols, blocks), (s_in, s_out) = _padded(g, bm, tiles)
        rng = np.random.default_rng(7)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).cuda()
        mat = lambda a, b: t(rng.standard_normal((a, b)) / np.sqrt(a))
        w = mat(d_in, d_out)
        ws, c = ((mat(d_in, d_out), None) if epilogue == "two_w" else
                 (w, t(1.3)) if epilogue == "self_coeff" else (None, None))
        args = (cols, blocks, t(rng.standard_normal((n, d_in))), s_in, s_out,
                w)
        kw = dict(bias=t(rng.standard_normal(d_out)), w_self=ws,
                  self_coeff=c)
        opts = dict(bm=bm, bk=bm, add_diag=add_diag, relu=True)
        written = torch.ones(n, dtype=torch.bool, device="cuda")
        kernel, ref_fn = sk.spmm_blockell_update, spmm_blockell_update_ref
    before = kernel.launches
    y = kernel(*args, **kw, **opts)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = ref_fn(*args, **kw, **opts)
    bar = tol * ref.abs().amax(-1, keepdim=True).clamp_min(1.0)
    worst = float(((y - ref).abs() / bar)[written].max())
    assert worst <= 1.0, f"error {worst:.3g} x the bar"
    assert torch.equal(kernel(*args, **kw, **opts)[written], y[written])
    if walk == "padded":
        assert bool(torch.isfinite(y[empty]).all())


@pytest.mark.parametrize("walk", ["compact", "padded"])
def test_update_kernels_on_a_transposed_hub(walk):
    """The transposed plan of the MinHash-reordered Cora (the GIN and
    gcn-cora backwards' side) lists its hub's out-edges in one destination
    row: the update kernels there, 128 -> 128 with GIN's epilogue."""
    _need_cuda()
    from repro_torch.launch.train import training_graph
    g = training_graph()
    assert int(np.bincount(g.src).max()) == 337      # the hub's list
    plan = build_plan(g, "sum", bm=128, backend="cuda",
                      compact=walk == "compact", device="cuda")
    a = plan._bwd
    n = g.num_nodes
    gen = torch.Generator("cuda").manual_seed(11)
    x = torch.randn(n, 128, device="cuda", generator=gen)
    w = torch.randn(128, 128, device="cuda", generator=gen) / 128 ** 0.5
    b = torch.randn(128, device="cuda", generator=gen)
    c = torch.tensor(1.3, device="cuda")
    kw = dict(bm=128, bk=128, add_diag=False, relu=True)
    if walk == "compact":
        args = (a["row_offsets"], a["cols"], a["blocks"], x, a["s_in"],
                a["s_out"], w, b, w, c)
        y = sk.spmm_blockell_update_compact(*args, **kw)
        ref = spmm_blockell_update_compact_ref(*args, **kw)
        rows = a["node_active"]
    else:
        args = (a["block_cols"], a["blocks"], x, a["s_in"], a["s_out"], w, b,
                w, c)
        y = sk.spmm_blockell_update(*args, **kw)
        ref = spmm_blockell_update_ref(*args, **kw)
        rows = torch.ones(n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    _close_rows(y[rows], ref[rows])


def test_ops_spmm_on_the_card():
    _need_cuda()
    g = cora_like(seed=0)
    ell = build_blockell(g, bm=128, bk=128, storage="auto")
    x = torch.randn(g.num_nodes, 64, device="cuda")
    torch.testing.assert_close(ops.spmm(ell, x), ops.spmm_ref(ell, x),
                               atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# padded and bucketed plans through the kernels, forward and backward
# ---------------------------------------------------------------------------
PLAN_FORMS = [dict(compact=False), dict(buckets="128@7+256"),
              dict(buckets="128@7+512")]


@pytest.mark.parametrize("form", PLAN_FORMS, ids=["padded", "b256", "b512"])
@pytest.mark.parametrize("mode", ["gcn", "sum"])
def test_padded_and_bucketed_plan_gradients_on_the_card(form, mode):
    _need_cuda()
    g0 = cora_like(seed=0)
    g = g0.permute(minhash_reorder(g0))
    gen = torch.Generator("cuda").manual_seed(1)
    x0 = torch.randn(g.num_nodes, 16, device="cuda", generator=gen)
    proj = torch.randn(g.num_nodes, 16, device="cuda", generator=gen)
    out = {}
    for backend in ("cuda", "torch"):
        (x,) = _leaves(x0)
        y = build_plan(g, mode, bm=128, backend=backend, device="cuda",
                       **form).apply(x)
        (y * proj).sum().backward()
        out[backend] = (y.detach(), x.grad)
    for a, b in zip(out["cuda"], out["torch"]):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("form", PLAN_FORMS, ids=["padded", "b256", "b512"])
@pytest.mark.parametrize("mode,d_in,d_out,epilogue", [
    ("gcn", 1433, 16, "none"), ("sum", 128, 128, "self_coeff")])
def test_padded_and_bucketed_fused_layers_on_the_card(form, mode, d_in,
                                                      d_out, epilogue):
    """The fused padded layer (``spmm_blockell_update``) and the fused
    bucketed layer (one ``spmm_blockell_update_compact`` per bucket)
    against the unfused plain backend: values and every gradient."""
    _need_cuda()
    g0 = cora_like(seed=0)
    g = g0.permute(minhash_reorder(g0))
    gen = torch.Generator("cuda").manual_seed(2)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x0, w0, b0 = r(g.num_nodes, d_in), r(d_in, d_out) / d_in ** 0.5, r(d_out)
    proj = r(g.num_nodes, d_out)
    out = {}
    for backend in ("cuda", "torch"):
        lp = build_layer_plan(g, mode, d_in=d_in, d_out=d_out,
                              order="aggregate_first", bm=128,
                              backend=backend, device="cuda", **form)
        assert lp.fuse == (backend == "cuda")
        x, w, b = _leaves(x0, w0, b0)
        ops_ = {"x": x, "w": w, "b": b}
        kw = {}
        if epilogue == "self_coeff":
            (ops_["c"],) = _leaves(torch.tensor(1.2, device="cuda"))
            kw.update(w_self=w, self_coeff=ops_["c"])
        launches = (sk.spmm_blockell_update.launches
                    + sk.spmm_blockell_update_compact.launches)
        y = lp.apply(x, w, b, relu=True, **kw)
        (y * proj).sum().backward()
        if backend == "cuda":
            assert (sk.spmm_blockell_update.launches
                    + sk.spmm_blockell_update_compact.launches) > launches
        out[backend] = (y.detach(), {k: v.grad for k, v in ops_.items()})
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], atol=1e-4,
                               rtol=1e-4)
    for k, gk in out["cuda"][1].items():
        scale = max(1.0, float(out["torch"][1][k].abs().max()))
        torch.testing.assert_close(gk, out["torch"][1][k], rtol=0,
                                   atol=1e-4 * scale, msg=f"d{k}")


def test_autotune_layer_races_every_candidate_on_the_card(tmp_path):
    """The card's grid on a small graph: every candidate (compact, padded,
    fused, coo) is measured, none drops out."""
    _need_cuda()
    import importlib
    at = importlib.import_module("repro_torch.exec.autotune")
    g = _random_graph()
    cands = at.default_layer_candidates("cuda", 32, 16)
    rec = at.autotune_layer(g, 32, 16, "gcn", candidates=cands, iters=1,
                            cache_dir=str(tmp_path), device="cuda")
    assert sorted(tuple(r[:-1]) for r in rec.table) == sorted(cands)
    assert at.device_sig("cuda").startswith("cuda-")


# ---------------------------------------------------------------------------
# embedding_bag and sddmm
# ---------------------------------------------------------------------------
def _bag_case(case, d, V=5000, seed=0):
    """Entries sorted by bag, on the card: single-id bags (the deep lookup),
    40-id bags (the wide one), random bag sizes with a third of the bags
    empty (runs of empty bags, one at the end too), a few bags of 1000+
    ids, and the backward's shape: 500,000 bags over 3,000 entries (runs of
    empty bags longer than a warp's range, at the start, the middle and
    the end, the last row not empty), 64 MB and more of output at d >= 32,
    so that the stores stream.  Below one id a bag but too dense for the
    zero pass, ``sparse``: 60 ids over 400 bags, empty runs at the start
    (0-49), the middle (150-299) and the end (390-399), each longer than a
    warp's range at this size; ``one_bag``: every id in bag 17 of 48;
    ``single_bag``: num_bags = 1."""
    rng = np.random.default_rng(seed)
    if case in ("backward", "sparse"):
        nb = 500_000 if case == "backward" else 400
        bags = (np.concatenate([rng.integers(3_000, 200_000, 1500),
                                rng.integers(260_000, nb - 1000, 1499),
                                [nb - 1]]) if case == "backward" else
                np.concatenate([rng.integers(50, 150, 30),
                                rng.integers(300, 390, 30)]))
        sizes = np.bincount(bags, minlength=nb)
    elif case in ("one_bag", "single_bag"):
        sizes = np.zeros(48 if case == "one_bag" else 1, np.int64)
        sizes[17 if case == "one_bag" else 0] = 120
    else:
        sizes = {"single": np.ones(3000, np.int64),
                 "fields": np.full(700, 40),
                 "empty": rng.integers(0, 6, 2000) * (rng.random(2000) > 0.33),
                 "long": rng.integers(900, 1300, 9)}[case]
        if case == "empty":
            sizes[-1] = 0
    L = int(sizes.sum())
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).cuda()
    bag_ids = t(np.repeat(np.arange(len(sizes)), sizes), np.int32)
    ids = t(rng.integers(0, V, L), np.int32)
    weights = t(rng.uniform(-1, 2, L), np.float32)
    table = t(rng.standard_normal((V, d)), np.float32)
    return ids, bag_ids, weights, table, len(sizes)


def _bag_check(ids, bag_ids, weights, table, nb):
    """The kernel against ``embedding_bag_ref``: every row written, empty
    bags zero, one launch, and a rerun bit-identical (no atomics)."""
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels.ref import embedding_bag_ref
    before = kb.embedding_bag.launches
    y = kb.embedding_bag(ids, bag_ids, weights, table, nb)
    assert kb.embedding_bag.launches == before + 1
    ref = embedding_bag_ref(ids, bag_ids, weights, table, nb)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(y, ref, rtol=0, atol=TOL * scale)
    empty = torch.bincount(bag_ids.long(), minlength=nb) == 0
    assert not y[empty].any()
    assert torch.equal(kb.embedding_bag(ids, bag_ids, weights, table, nb), y)
    return y


@pytest.mark.parametrize("case", ["single", "fields", "empty", "long",
                                  "backward", "sparse", "one_bag",
                                  "single_bag"])
@pytest.mark.parametrize("d", [1, 3, 4, 7, 32, 33, 37, 64, 128, 1027, 1028])
def test_embedding_bag_kernel_matches_plain_version(case, d):
    """Both mappings (lane groups over float4 columns where d % 4 == 0, a
    lane per entry elsewhere) against ``embedding_bag_ref``; runs longer
    than a 32-entry window ("long", "one_bag", "single_bag"); d = 1027 and
    1028, wider than the lanes mapping's tile and than a warp of float4."""
    _need_cuda()
    from repro_torch.kernels import embedding_bag as kb
    ids, bag_ids, weights, table, nb = _bag_case(case, d)
    y = _bag_check(ids, bag_ids, weights, table, nb)
    plan = kb.plan(ids.numel(), nb, table, y)
    assert plan["mapping"] == ("rows" if d % 4 == 0 else "lanes")
    # the rows mapping zeroes a mostly empty output first
    assert plan["zero_pass"] == (d % 4 == 0 and case == "backward")


@pytest.mark.parametrize("case", ["fields", "empty", "backward"])
@pytest.mark.parametrize("d", [1, 4, 32])
def test_embedding_bag_kernel_off_16_byte_rows(case, d):
    """A table that is a view starting one float past a 16-byte boundary
    (as a column view of a 1-D parameter can be): the same kernel takes
    the lane-per-entry mapping with scalar loads."""
    _need_cuda()
    from repro_torch.kernels import embedding_bag as kb
    ids, bag_ids, weights, table, nb = _bag_case(case, d, seed=1)
    table = _offset(table)
    y = _bag_check(ids, bag_ids, weights, table, nb)
    assert kb.plan(ids.numel(), nb, table, y)["mapping"] == "lanes"


@pytest.mark.parametrize("d", [1, 32])
def test_embedding_bag_backward_on_the_card(d):
    """``ops.embedding_bag``'s table gradient (the kernel on the transposed
    bag list) against autograd through ``embedding_bag_ref``; unsorted bag
    ids, empty bags, untouched table rows."""
    _need_cuda()
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels.ref import embedding_bag_ref
    rng = np.random.default_rng(3)
    V, L, nb = 4000, 6000, 900
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).cuda()
    ids = t(rng.integers(0, V - 100, L), np.int32)
    bags = t(rng.integers(0, nb - 50, L), np.int32)
    w = t(rng.uniform(-1, 2, L), np.float32)
    table0 = t(rng.standard_normal((V, d)), np.float32)
    proj = t(rng.standard_normal((nb, d)), np.float32)
    grads, outs = {}, {}
    for name in ("kernel", "plain"):
        table = table0.clone().requires_grad_()
        before = kb.embedding_bag.launches
        if name == "kernel":
            out = ops.embedding_bag(ids, bags, table, nb, w)
        else:
            out = embedding_bag_ref(ids, bags, w, table, nb)
        (out * proj).sum().backward()
        if name == "kernel":
            assert kb.embedding_bag.launches == before + 2   # fwd + bwd
        grads[name], outs[name] = table.grad, out.detach()
    for a, b in ((outs["kernel"], outs["plain"]),
                 (grads["kernel"], grads["plain"])):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TOL * max(1.0, float(b.abs().max())))
    assert not grads["kernel"][V - 100:].any()


def _sddmm_check(src, dst, q, k):
    from repro_torch.kernels import sddmm as ks
    from repro_torch.kernels.ref import sddmm_ref
    before = ks.sddmm.launches
    y = ops.sddmm(src, dst, q, k)
    assert ks.sddmm.launches == before + 1
    ref = sddmm_ref(src, dst, q, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref, rtol=0,
                               atol=TOL * max(1.0, float(ref.abs().max())))
    assert torch.equal(ops.sddmm(src, dst, q, k), y)


def _sddmm_case(E, d, seed):
    """E edges over 2708 nodes, the second half repeating the first."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).cuda()
    idx = [rng.integers(0, 2708, E) for _ in range(2)]
    for a in idx:
        a[E // 2:] = a[:E - E // 2]
    q, k = (t(rng.standard_normal((2708, d)), np.float32) for _ in range(2))
    return t(idx[0], np.int32), t(idx[1], np.int32), q, k


@pytest.mark.parametrize("E", [1, 300, 10556])
@pytest.mark.parametrize("d", [1, 4, 7, 64, 128, 130, 256])
def test_sddmm_kernel_matches_plain_version(E, d):
    """Lane groups matched to d (a lane per edge below d = 16), float4 rows
    where d % 4 == 0; repeated edges; a rerun bit-identical."""
    _need_cuda()
    _sddmm_check(*_sddmm_case(E, d, E + d))


@pytest.mark.parametrize("d", [4, 64, 128])
def test_sddmm_kernel_off_16_byte_rows(d):
    """q and k starting one float past a 16-byte boundary: scalar loads in
    the same kernel."""
    _need_cuda()
    src, dst, q, k = _sddmm_case(10556, d, d)
    _sddmm_check(src, dst, _offset(q), _offset(k))


def test_wide_deep_bag_matches_dense_on_the_card():
    """The reduced model's logits and every gradient, ``lookup="bag"``
    (the kernel, 4 launches: two lookups and their backwards) against
    ``lookup="dense"``."""
    _need_cuda()
    from repro_torch.configs.wide_deep import REDUCED
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.models import recsys
    from repro_torch.train import tree_leaves, tree_map
    gen = torch.Generator("cuda").manual_seed(0)
    params = recsys.widedeep_init(gen, REDUCED, device="cuda")
    B = 300
    sparse = torch.randint(0, REDUCED.rows_per_field, (B, REDUCED.n_sparse),
                           device="cuda", generator=gen)
    dense = torch.randn(B, REDUCED.n_dense, device="cuda", generator=gen)
    labels = (torch.rand(B, device="cuda", generator=gen) > 0.5).float()
    out = {}
    for lookup in recsys.LOOKUPS:
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(),
                        params)
        before = kb.embedding_bag.launches
        loss = recsys.widedeep_loss(tree, sparse, dense, labels, REDUCED,
                                    lookup)
        loss.backward()
        launched = kb.embedding_bag.launches - before
        assert launched == (4 if lookup == "bag" else 0)
        out[lookup] = (loss.detach(),
                       [leaf.grad for leaf in tree_leaves(tree)])
    torch.testing.assert_close(out["bag"][0], out["dense"][0], rtol=1e-5,
                               atol=0)
    for a, b in zip(out["bag"][1], out["dense"][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TOL * max(1e-30, float(b.abs().max())))


def test_widedeep_session_serves_on_the_card():
    _need_cuda()
    from repro_torch.kernels import embedding_bag as kb
    sess = make_session("wide_deep", None, num_users=512, device="cuda")
    before = kb.embedding_bag.launches
    cache = EmbeddingCache(sess.layer_dims, capacity_bytes=64_000,
                           line_size=1, num_nodes=512)
    eng = ServeEngine(sess, cache, MicroBatcher(max_batch=8, max_wait=1e-3))
    rep = eng.serve(zipfian_trace(512, 120, a=1.3, seed=4))
    assert rep.max_oracle_err < 1e-4 and rep.cache.hits > 0
    assert kb.embedding_bag.launches > before


# ------------------------------------------------------ decode attention
def _decode_inputs(B, S, H, KV, d, dtype, seed=0):
    gen = torch.Generator("cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                   ).to(dtype)
    return r(B, H, d), r(B, S, KV, d), r(B, S, KV, d)


def _decode_check(q, k, v, cl, dtype):
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels.ref import decode_attention_ref
    before = kd.decode_attention.launches
    y = kd.decode_attention(q, k, v, cl)
    assert kd.decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, cl)
    torch.cuda.synchronize()
    assert y.dtype == q.dtype and y.shape == q.shape
    # each (b, h) row to tol x its own largest |entry| (a zero row exactly):
    # an output's size falls as 1 / sqrt(length), so no absolute bar holds
    # a long row
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    ref = ref.float()
    bar = tol * ref.abs().amax(-1, keepdim=True)
    err = (y.float() - ref).abs()
    assert (err <= bar).all(), \
        f"error / row bar up to {float((err / bar.clamp_min(1e-30)).max())}"
    assert torch.equal(kd.decode_attention(q, k, v, cl), y)   # rerun
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,d", [
    (1, 256, 2, 2, 64), (2, 1024, 4, 4, 128), (3, 512, 1, 1, 32),
    (2, 4096, 8, 2, 128), (1, 20000, 12, 1, 64), (2, 37, 8, 2, 36),
    (2, 300, 4, 4, 33), (2, 5, 24, 2, 256), (1, 1, 4, 1, 128)])
def test_decode_attention_kernel_matches_plain_version(dtype, B, S, H, KV,
                                                       d):
    """The reference's shapes, GQA (G = 4, 12), one and many chunks, d not
    a multiple of 8 (narrower loads) and up to 256, S = 1; ragged
    lengths."""
    _need_cuda()
    q, k, v = _decode_inputs(B, S, H, KV, d, dtype, seed=S + d)
    gen = torch.Generator("cuda").manual_seed(S)
    cl = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    _decode_check(q, k, v, cl, dtype)


@pytest.mark.parametrize("S", [64, 5000])
def test_decode_attention_kernel_edge_lengths(S):
    """cache_len 0 (zeros), 1, S and above S, in one batch; one chunk and
    many."""
    _need_cuda()
    q, k, v = _decode_inputs(4, S, 8, 2, 128, torch.bfloat16)
    cl = torch.tensor([0, 1, S, S + 100], dtype=torch.int32, device="cuda")
    y = _decode_check(q, k, v, cl, torch.bfloat16)
    assert not y[0].any()


def test_decode_attention_kernel_on_a_stacked_cache_view():
    """A layer's view of the stacked cache (strided over b and s) and a
    cache whose head axis is strided, as given, with no copy."""
    _need_cuda()
    q, _, _ = _decode_inputs(2, 1, 8, 2, 64, torch.bfloat16)
    stack = torch.randn(3, 2, 700, 2, 64, device="cuda").to(torch.bfloat16)
    cl = torch.tensor([700, 333], dtype=torch.int32, device="cuda")
    _decode_check(q, stack[1], stack[2], cl, torch.bfloat16)
    wide = torch.randn(2, 700, 4, 64, device="cuda")
    _decode_check(q.float(), wide[:, :, ::2], wide[:, :, 1::2], cl,
                  torch.float32)


@pytest.mark.parametrize("G", [1, 4, 12, 24, 40])
@pytest.mark.parametrize("d", [33, 36, 64, 128, 256])
def test_decode_attention_tensor_cores_at_every_group_and_width(G, d):
    """The bf16 tensor-core body at G = 1 (7 of 8 MMA columns idle), 4
    (granite-8b), 12, 24 (three n-tiles of 8 heads: 6 of 8 warps busy) and
    40 (two CTAs a KV head), d off the 16-deep k-step (33, 36) and up to 256 (the wide
    instantiation), four chunks merged by pass 2, with lengths 0, 1, S and
    above S in one batch."""
    _need_cuda()
    S = 777
    q, k, v = _decode_inputs(4, S, 2 * G, 2, d, torch.bfloat16, seed=G + d)
    cl = torch.tensor([0, 1, S, S + 123], dtype=torch.int32, device="cuda")
    y = _decode_check(q, k, v, cl, torch.bfloat16)
    assert not y[0].any()


def test_launch_plan_splits_long_caches():
    """One chunk (one pass) for a short cache; at granite-8b's decode_32k
    layer shape (B = 8, 8 KV heads, G = 4, d = 128, bf16), 128-position
    tiles and chunks of whole tiles that cover S, one wave of one CTA an SM
    (the tensor-core body's double buffer takes 136 KB of shared memory);
    the same at long_500k; at d = 256 the bf16 tile halves to fit, and
    heads beyond 32 a KV head take more CTAs; the fp32 body's tile shrinks
    where a CTA's shared memory would not fit, and a shape that fits at no
    tile raises."""
    _need_cuda()
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    short = kd.plan(2, 64, 2, 4, 16, f32, 16, dev)
    assert short["n_split"] == 1 and short["ws"] == 1
    assert kd.plan(2, 200, 2, 4, 128, bf16, 16, dev)["n_split"] == 1
    p = kd.plan(8, 32768, 8, 4, 128, bf16, 16, dev)
    assert p["tile"] == 128 and p["chunk"] % p["tile"] == 0
    assert (p["n_split"] - 1) * p["chunk"] < 32768 <= p["n_split"] * p["chunk"]
    assert sms // 2 < 8 * 8 * p["n_split"] <= sms
    assert p["ws"] == 8 * 8 * p["n_split"] * 4 * (128 + 2)
    long = kd.plan(1, 524288, 8, 4, 128, bf16, 16, dev)
    assert long["n_split"] * long["chunk"] >= 524288
    assert sms // 2 < 8 * long["n_split"] <= sms
    many = kd.plan(1, 65536, 1, 96, 256, bf16, 16, dev)
    assert many["tile"] == 64 and sms // 2 < 3 * many["n_split"] <= sms
    big = kd.plan(1, 4096, 1, 24, 256, f32, 16, dev)
    assert big["tile"] < 64
    with pytest.raises(ValueError, match="shared memory"):
        kd.plan(1, 4096, 1, 96, 256, f32, 16, dev)


def test_decode_attention_wrapper_raises_on_the_card():
    _need_cuda()
    from repro_torch.kernels import decode_attention as kd
    q, k, v = _decode_inputs(2, 16, 4, 2, 8, torch.float32)
    cl = torch.tensor([3, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="is on"):
        kd.decode_attention(q, k.cpu(), v, cl)
    with pytest.raises(TypeError, match="int32"):
        kd.decode_attention(q, k, v, cl.cpu())
    with pytest.raises(NotImplementedError, match="backward"):
        kd.decode_attention(q.requires_grad_(), k, v, cl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_decode_kernel_matches_plain_attention(dtype):
    """``REDUCED`` granite-8b: prefill, then 4 decode steps with the
    kernel (2 launches a step, one per layer) against the same steps on
    ``attn="plain"`` (the reference's einsums), logits within 1e-4 (fp32)
    or 3e-2 (bf16) of their largest entry."""
    _need_cuda()
    import dataclasses
    from repro_torch.configs.granite_8b import REDUCED
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(REDUCED, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = tf.lm_init(gen, cfg, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen).cuda()
    steps = torch.randint(0, cfg.vocab, (2, 4), generator=gen).cuda()
    out = {}
    with torch.inference_mode():
        _, caches = tf.lm_prefill(params, prompt, cfg)
        for attn in ("kernel", "plain"):
            full = tf.make_kv_caches(cfg, 2, 64, device="cuda")
            for buf, c in zip(full["dense"], caches["dense"]):
                buf[:, :, :16] = c
            before = kd.decode_attention.launches
            out[attn] = torch.stack([
                tf.lm_decode_step(params, steps[:, i:i + 1], full, 16 + i,
                                  cfg, 64, attn=attn)[0] for i in range(4)])
            launched = kd.decode_attention.launches - before
            assert launched == (8 if attn == "kernel" else 0)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    ref = out["plain"].float()
    torch.testing.assert_close(out["kernel"].float(), ref, rtol=0,
                               atol=tol * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# the reuse layer: blockell_aggregate through spmm_blockell, shared sets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("storage", ["dense", "auto"])
@pytest.mark.parametrize("d", [1, 16, 129, 1433])
def test_blockell_aggregate_and_backward_on_the_card(storage, d):
    """One ``spmm_blockell`` launch forward and one over Aᵀ backward, both
    within 1e-5 of the plain version (1e-4 at d = 1433, as for the other
    wide cases) of the largest entry."""
    _need_cuda()
    from repro_torch.core import blockell_aggregate
    g0 = _random_graph(n=700, e=6000, seed=3)
    g = g0.with_sym_norm() if storage == "dense" else g0
    ell = build_blockell(g, bm=128, bk=128, storage=storage)
    gen = torch.Generator().manual_seed(d)
    x0 = torch.randn(g.num_nodes, d, generator=gen)
    w = torch.randn(g.num_nodes, d, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        x = x0.to(dev).requires_grad_()
        before = sk.spmm_blockell.launches
        y = blockell_aggregate(ell, x)
        (y * w.to(dev)).sum().backward()
        torch.cuda.synchronize()
        out[dev] = (y.detach().cpu(), x.grad.cpu(),
                    sk.spmm_blockell.launches - before)
    tol = 1e-4 if d > 512 else TOL
    for i, what in enumerate(("forward", "backward")):
        ref = out["cpu"][i]
        torch.testing.assert_close(out["cuda"][i], ref, rtol=0,
                                   atol=tol * max(1.0, float(ref.abs().max())),
                                   msg=what)
    assert (out["cuda"][2], out["cpu"][2]) == (2, 0)
    before = sk.spmm_blockell.launches
    blockell_aggregate(ell, x0.cuda())          # no gradient: forward only
    assert sk.spmm_blockell.launches - before == 1


def test_gcn_blockell_ell_path_on_the_card():
    """GCN [1433, 16, 7] on the reordered Cora through a bare adjacency
    ``BlockEll``: 3 ``spmm_blockell`` launches a step (2 forward, 1 backward
    for layer 2's input), loss and gradients within 1e-5 of the largest
    entry of the plain path on the CPU."""
    _need_cuda()
    from repro_torch.models import gcn_init, gcn_loss
    from repro_torch.models.gcn import make_graph_inputs
    g0 = cora_like(seed=0)
    g = g0.permute(minhash_reorder(g0))
    ell = build_blockell(g, bm=128, bk=128, storage="auto")
    out = {}
    for dev in ("cuda", "cpu"):
        params = gcn_init(torch.Generator().manual_seed(0), [1433, 16, 7],
                          device=dev)
        for p in params["layers"]:
            for t in p.values():
                t.requires_grad_()
        t = lambda a: torch.as_tensor(a).to(dev)
        before = sk.spmm_blockell.launches
        loss = gcn_loss(params, t(g.node_feat), make_graph_inputs(g, dev),
                        t(g.labels.astype(np.int64)), t(g.train_mask),
                        "blockell", ell)
        loss.backward()
        torch.cuda.synchronize()
        out[dev] = (loss.detach().cpu(),
                    [p[k].grad.cpu() for p in params["layers"]
                     for k in sorted(p)],
                    sk.spmm_blockell.launches - before)
    assert (out["cuda"][2], out["cpu"][2]) == (3, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=TOL)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TOL * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_shared_aggregate_on_the_card(op):
    """The G-C executor on the card: the CPU's answer within 1e-5, and no
    kernel of the port launched (the reference runs it on segment sums
    too)."""
    _need_cuda()
    from repro_torch.core import build_shared_plan, shared_aggregate
    g0 = cora_like(seed=0)
    g = g0.permute(minhash_reorder(g0))
    plan = build_shared_plan(g, levels=2)
    x = torch.randn(g.num_nodes, 33, generator=torch.Generator().manual_seed(2))
    counts = lambda: (sk.spmm_blockell.launches,
                      sk.spmm_blockell_compact.launches,
                      sk.spmm_blockell_update_compact.launches)
    before = counts()
    y = shared_aggregate(x.cuda(), plan, op)
    torch.cuda.synchronize()
    assert counts() == before
    ref = shared_aggregate(x, plan, op)
    torch.testing.assert_close(y.cpu(), ref, rtol=0,
                               atol=TOL * max(1.0, float(ref.abs().max())))


# ------------------------------------------------------------ LM training
def _lm_reduced(seed=0):
    from repro_torch.configs.granite_8b import REDUCED
    from repro_torch.models import lm_init
    return REDUCED, lm_init(torch.Generator().manual_seed(seed), REDUCED,
                            device="cuda")


def test_donated_lm_step_matches_functional_on_the_card():
    """granite-8b ``REDUCED`` on the card, 3 in-place (donated) steps
    against 3 functional ones from the same params: the bundle's Adam step
    (``LMBundle.loss_fn``, ``opt()``, clip 1.0) gives the same losses within 1e-6 (relative) with a lower peak; with
    SGD, every parameter agrees within 1e-6 of its leaf's largest entry.
    (Adam's first steps divide by |g| + 1e-8, so its parameters magnify
    the run-to-run rounding of tiny gradients; the CPU tests hold the two
    forms bit-equal on equal gradients.)"""
    _need_cuda()
    from repro_torch.configs.families import LMBundle
    from repro_torch.train import (lm_token_batches, make_train_step, sgd,
                                   tree_leaves, tree_map)
    cfg, params = _lm_reduced()
    bundle = LMBundle(cfg)
    batches = [next(lm_token_batches(cfg.vocab, 4, 64, start_step=s))
               for s in range(3)]
    out = {}
    for opt_name in ("adam", "sgd"):
        for donate in (False, True):
            p = tree_map(lambda x: x.clone(), params)
            opt = bundle.opt() if opt_name == "adam" else sgd(1e-2)
            step = make_train_step(bundle.loss_fn, opt,
                                   clip_norm=1.0 if opt_name == "adam"
                                   else None, donate=donate)
            state = opt.init(p)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            losses = []
            for b in batches:
                p, state, loss = step(p, state, b)
                losses.append(float(loss))
            out[opt_name, donate] = (losses, p,
                                     torch.cuda.max_memory_allocated() - base)
    for name in ("adam", "sgd"):
        (lf, pf, mf), (ld, pd, md) = out[name, False], out[name, True]
        np.testing.assert_allclose(ld, lf, rtol=1e-6)
        assert md < mf, (name, md, mf)
    for a, b in zip(tree_leaves(out["sgd", True][1]),
                    tree_leaves(out["sgd", False][1])):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


def test_lm_loss_remat_and_chunks_on_the_card():
    """``lm_loss`` (remat, 8 chunks) against the plain full cross-entropy
    over ``lm_forward(remat=False)`` on the card: loss and gradients within
    1e-5 of the largest entry."""
    _need_cuda()
    from repro_torch.models import lm_forward, lm_loss
    from repro_torch.nn.layers import cross_entropy
    from repro_torch.train import tree_leaves
    cfg, params = _lm_reduced(1)
    rng = np.random.default_rng(4)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device="cuda")
    tgt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device="cuda")
    res = []
    for remat in (True, False):
        leaves = [t.detach().clone().requires_grad_()
                  for t in tree_leaves(params)]
        from repro_torch.train.optimizer import tree_unflatten
        p = tree_unflatten(params, leaves)
        loss = (lm_loss(p, tok, tgt, cfg) if remat else
                cross_entropy(lm_forward(p, tok, cfg, remat=False)[0], tgt))
        loss.backward()
        res.append((loss.detach(), [t.grad for t in leaves]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-5, atol=0)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_checkpoint_from_card_tensors_restores_on_the_cpu(tmp_path):
    """Leaves on the card (fp32, bf16, int32) written by ``save_checkpoint``
    and restored into CPU templates: bit-equal to their host copies; and
    back onto the card into card templates."""
    _need_cuda()
    from repro_torch.train import checkpoint
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = {"w": torch.randn(33, 7, generator=gen, device="cuda"),
              "h": torch.randn(5, 9, generator=gen,
                               device="cuda").to(torch.bfloat16)}
    opt = {"m": [torch.randn(33, 7, generator=gen, device="cuda")],
           "step": torch.tensor(17, dtype=torch.int32, device="cuda")}
    checkpoint.save_checkpoint(str(tmp_path), 17, params, opt)
    zeros = lambda t, dev: torch.zeros(t.shape, dtype=t.dtype, device=dev)
    for dev in ("cpu", "cuda"):
        tp = {k: zeros(v, dev) for k, v in params.items()}
        to = {"m": [zeros(opt["m"][0], dev)], "step": zeros(opt["step"], dev)}
        p, o, step = checkpoint.restore_checkpoint(str(tmp_path), tp, to)
        assert step == 17
        pairs = [(p["w"], params["w"]), (p["h"], params["h"]),
                 (o["m"][0], opt["m"][0]), (o["step"], opt["step"])]
        for got, want in pairs:
            assert got.device.type == dev and got.dtype == want.dtype
            assert torch.equal(got.cpu(), want.cpu())


def test_prefetcher_copies_on_a_side_stream():
    """The ``Prefetcher`` on the card: every array lands on the device with
    its values, after the consumer's stream waited on the copy."""
    _need_cuda()
    from repro_torch.train import Prefetcher, lm_token_batches
    src = lm_token_batches(512, 4, 256)
    want = [next(lm_token_batches(512, 4, 256, start_step=s))
            for s in range(5)]
    got = [b for _, b in zip(range(5), Prefetcher(src, device="cuda"))]
    for g, w in zip(got, want):
        assert g["tokens"].is_cuda and g["step"] == w["step"]
        total = g["tokens"].sum() + g["targets"].sum()   # consumer's stream
        assert int(total) == int(w["tokens"].sum() + w["targets"].sum())


# ---------------------------------------------------------------------------
# the fallback chain, weighted sum plans and the GNN zoo on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", [dict(compact=True), dict(compact=False),
                                  dict(buckets="32@8+128")],
                         ids=["compact", "padded", "bucketed"])
def test_weighted_sum_plan_gradient_on_the_card(form):
    """A weighted ``sum`` plan (float32 tiles) on ``cuda`` against the same
    plan on ``torch``: values and the gradient through the transpose plan
    (1e-5 of the largest entry)."""
    _need_cuda()
    import dataclasses
    g = _random_graph(seed=7)
    g = dataclasses.replace(g, edge_weight=np.random.default_rng(7).random(
        g.num_edges).astype(np.float32))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((g.num_nodes, 40), generator=gen, device="cuda")
    cot = torch.randn((g.num_nodes, 40), generator=gen, device="cuda")
    out = {}
    for backend in ("cuda", "torch"):
        plan = build_plan(g, "sum", backend=backend, weighted=True,
                          device="cuda", **form)
        if backend == "cuda" and not form.get("buckets"):
            assert plan._fwd["blocks"].dtype == torch.float32
        xg = x.clone().requires_grad_()
        y = plan.apply(xg)
        y.backward(cot)
        out[backend] = (y.detach(), xg.grad)
    for a, b in zip(out["cuda"], out["torch"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TOL * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("site,kind,reason", [
    ("exec.pallas_launch", "kernel_launch", "kernel_launch"),
    ("exec.kernel_result", "nan_backend", "nonfinite_output")])
def test_resilient_plan_drill_on_the_card(tmp_path, site, kind, reason):
    """On a CUDA device the chain starts at ``cuda``; a fault at either site
    demotes the call to ``torch`` (same answer), quarantines ``cuda`` under
    the card's signature, and a fresh plan starts below it."""
    _need_cuda()
    from repro_torch.chaos import Fault, FaultPlan, armed
    from repro_torch.exec import (ResilientPlan, graph_fingerprint,
                                  quarantined_backends)
    g = _random_graph(seed=8)
    x = torch.randn((g.num_nodes, 16), device="cuda")
    rp = ResilientPlan(g, "gcn", device="cuda", cache_dir=str(tmp_path))
    assert rp.chain == ["cuda", "torch", "coo"]
    healthy = rp.apply(x)
    assert rp.verdict.backend == "cuda" and not rp.verdict.degraded
    with armed(FaultPlan.of(Fault(site, kind))):
        y = rp.apply(x)
    assert rp.verdict.backend == "torch"
    assert rp.verdict.attempts == (("cuda", reason),)
    torch.testing.assert_close(y, healthy, rtol=0, atol=1e-5)
    assert quarantined_backends(graph_fingerprint(g),
                                cache_dir=str(tmp_path)) == {"cuda"}
    assert ResilientPlan(g, "gcn", device="cuda",
                         cache_dir=str(tmp_path)).backend == "torch"


@pytest.mark.parametrize("form", [dict(), dict(compact=False),
                                  dict(buckets="32@8+128")],
                         ids=["compact", "padded", "bucketed"])
def test_real_kernel_failure_propagates_on_the_card(tmp_path, form):
    """A failure of the kernels that no drill injected (here the wrapper
    rejecting a float64 x) propagates from ``ResilientPlan`` on the card:
    no ``torch`` answer, no quarantine written, the chain unchanged."""
    _need_cuda()
    from repro_torch.exec import (ResilientPlan, graph_fingerprint,
                                  quarantined_backends)
    g = _random_graph(seed=9)
    rp = ResilientPlan(g, "gcn", device="cuda", cache_dir=str(tmp_path),
                       **form)
    with pytest.raises(TypeError, match="float32"):
        rp.apply(torch.randn((g.num_nodes, 16), device="cuda",
                             dtype=torch.float64))
    assert rp.verdict is None and rp.chain == ["cuda", "torch", "coo"]
    assert quarantined_backends(graph_fingerprint(g),
                                cache_dir=str(tmp_path)) == set()
    assert not (tmp_path / "autotune.json").exists()
    rp.apply(torch.randn((g.num_nodes, 16), device="cuda"))
    assert rp.verdict.backend == "cuda" and not rp.verdict.degraded


@pytest.mark.parametrize("arch", ["gat-cora", "pna", "nequip"])
def test_gnn_zoo_step_on_the_card_matches_the_cpu(arch):
    """The loss and every gradient of each new arch at full width on a
    small products-shaped graph (NequIP: 8 molecules), in float64 on the
    card and on the CPU.  GAT's and PNA's cross-entropy is fp32 on both,
    as the reference takes it, so their loss is held to 1e-6 and each
    gradient to 1e-6 of its leaf's largest entry; NequIP's loss is float64
    throughout: 1e-9.  (Not the params after an Adam step: its first
    update is g / (|g| + 1e-8), which turns the rounding of a near-zero
    gradient entry into ~1e-7.)"""
    _need_cuda()
    from repro_torch.configs import get
    from repro_torch.graph import molecules_like, pack, products_like
    from repro_torch.launch.train import gnn_batch
    from repro_torch.train import tree_leaves, tree_map
    bundle = get(arch).bundle()
    if arch == "nequip":
        mols = molecules_like(8)
        gb, _ = pack([m[0] for m in mols])
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
        batch = {"src": t(gb.src).long(), "dst": t(gb.dst).long(),
                 "edge_mask": t(gb.edge_mask), "train_mask": t(gb.node_mask),
                 "labels": torch.zeros(gb.num_nodes, dtype=torch.long),
                 "species": t(np.concatenate([m[2] for m in mols])).long(),
                 "pos": t(np.concatenate([m[1] for m in mols])),
                 "energy_target": torch.zeros(())}
        shape = "molecule"
    else:
        batch = gnn_batch(products_like(0.001), bundle.n_classes, "cpu")
        shape = "ogb_products"
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda v: v.double().requires_grad_(),
                          bundle.init_params(torch.Generator().manual_seed(0),
                                             100, device=dev))
        b = {k: (v.double() if v.is_floating_point() else v).to(dev)
             for k, v in batch.items()}
        loss = bundle.loss_fn(shape)(params, b)
        loss.backward()
        out[dev] = (loss.detach(), [p.grad for p in tree_leaves(params)])
    tol = 1e-9 if arch == "nequip" else 1e-6
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               rtol=tol, atol=0)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        if b is None:                 # a leaf the loss does not reach
            assert a is None
            continue
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=tol * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the MoE LMs: decode_attention on every layer, deterministic MoE steps
# ---------------------------------------------------------------------------
MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]


def _moe_reduced(arch, seed=0):
    import importlib
    from repro_torch.models import lm_init
    cfg = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_")).REDUCED
    return cfg, lm_init(torch.Generator().manual_seed(seed), cfg,
                        device="cuda")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_kernel_matches_plain_attention(arch):
    """``REDUCED`` (fp32): prefill, the caches copied into padded ones
    along the sequence axis of every stack, then 4 decode steps with the
    kernel (n_layers launches a step, dense and MoE layers alike) against
    the same steps on ``attn="plain"``: logits within 1e-4 of their
    largest entry, the same routes."""
    _need_cuda()
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.models import transformer as tf
    from repro_torch.nn import moe
    cfg, params = _moe_reduced(arch)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (3, 16), generator=gen).cuda()
    steps = torch.randint(0, cfg.vocab, (3, 4), generator=gen).cuda()
    out, routes = {}, {}
    inner = moe.moe_routes
    with torch.inference_mode():
        _, caches = tf.lm_prefill(params, prompt, cfg)
        for attn in ("kernel", "plain"):
            seen = []

            def recording(p, x, *a, **kw):
                r = inner(p, x, *a, **kw)
                seen.append(r.expert_ids.clone())
                return r
            moe.moe_routes = recording
            try:
                full = tf.make_kv_caches(cfg, 3, 64, device="cuda")
                tf.fill_caches(full, caches)
                before = kd.decode_attention.launches
                out[attn] = torch.stack([
                    tf.lm_decode_step(params, steps[:, i:i + 1], full,
                                      16 + i, cfg, 64, attn=attn)[0]
                    for i in range(4)])
                launched = kd.decode_attention.launches - before
            finally:
                moe.moe_routes = inner
            routes[attn] = seen
            assert launched == (4 * cfg.n_layers if attn == "kernel" else 0)
    ref = out["plain"]
    torch.testing.assert_close(out["kernel"], ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    assert len(routes["kernel"]) == 4 * cfg.n_moe_layers
    for a, b in zip(routes["kernel"], routes["plain"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_reruns_are_bit_identical_on_the_card(arch):
    """The MoE forward and backward use no atomics where several terms meet
    a row: a decode step rerun over the same caches, and ``lm_loss`` with
    its gradients (remat: the checkpointed recompute routes as the forward
    did) computed twice, give the same bits; in bf16 too."""
    _need_cuda()
    import dataclasses
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree_leaves
    from repro_torch.train.optimizer import tree_unflatten
    base, _ = _moe_reduced(arch)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = tf.lm_init(torch.Generator().manual_seed(2), cfg,
                            device="cuda")
        rng = np.random.default_rng(3)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64)),
                              device="cuda")
        tgt = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64)),
                              device="cuda")
        with torch.inference_mode():
            _, caches = tf.lm_prefill(params, tok[:, :32], cfg)
            full = tf.make_kv_caches(cfg, 4, 64, device="cuda")
            tf.fill_caches(full, caches)
            a = tf.lm_decode_step(params, tok[:, 32:33], full, 32, cfg, 64)[0]
            b = tf.lm_decode_step(params, tok[:, 32:33], full, 32, cfg, 64)[0]
        assert torch.equal(a, b)
        runs = []
        for _ in range(2):
            leaves = [t.detach().clone().requires_grad_()
                      for t in tree_leaves(params)]
            loss = tf.lm_loss(tree_unflatten(params, leaves), tok, tgt, cfg)
            loss.backward()
            runs.append((loss.detach(), [t.grad for t in leaves]))
        assert torch.equal(runs[0][0], runs[1][0])
        for x, y in zip(runs[0][1], runs[1][1]):
            assert torch.equal(x, y)
