"""GAT's attention kernels on the card (``csrc/gat_attention.cu``,
``csrc/gat_attention_bwd.cu``) against their plain versions
(``kernels/ref.py``), on an attention plan with hubs both ways (a row and
a source of 1,500 entries, over the list walk's 512), duplicate edges, an
isolated node and self loops, at float4 and scalar column widths.

The plain versions run in float64 as the yardstick: each kernel output is
within 1e-5 of it, scaled by the largest entry of that output.  A rerun is
bit-identical, each call counts once on the wrapper's ``launches``, a
layer makes no host sync, and the fused model's loss and gradients on the
card equal the segment path's there.

Every test needs an NVIDIA GPU with nvcc; it is marked ``cuda`` and skips
without one.  No jax here (``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_gat.py
"""
import numpy as np
import pytest
import torch

from repro_torch.exec.gat import build_attention_plan
from repro_torch.graph import Graph
from repro_torch.kernels import gat_attention as ga
from repro_torch.kernels.ref import gat_attention_bwd_ref, gat_attention_ref
from repro_torch.kernels.spmm_blockell import Lists
from repro_torch.models.gat import gat_init, gat_loss

pytestmark = pytest.mark.cuda
TOL = 1e-5
SLOPE = 0.2
# (heads, width): float4 at 2, 1 and 4 loads a lane; scalar at 1 and 2
SHAPES = [(4, 256), (8, 8), (1, 300), (6, 6), (2, 41)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _graph(n=3000, e=40000, seed=0):
    """Random edges, some twice, a destination (5) and a source (7) of
    1,500 entries each, node 11 with no edge."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), rng.choice(n, 1500, False),
                          np.full(1500, 7)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(1500, 5),
                          rng.choice(n, 1500, False)])
    src, dst = np.concatenate([src, src[:500]]), np.concatenate([dst,
                                                                 dst[:500]])
    keep = (src != 11) & (dst != 11)
    return Graph(src=src[keep].astype(np.int32),
                 dst=dst[keep].astype(np.int32), num_nodes=n)


@pytest.fixture(scope="module")
def plan():
    _need_cuda()
    p = build_attention_plan(_graph(), self_loops=True, device="cuda")
    assert p.describe()["hubs"] >= 1 and p.describe()["hubs_t"] >= 1
    return p


def _inputs(plan, H, F, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = plan.num_nodes
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return r(n, H, F), r(n, H), r(n, H), r(n, H, F)


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= TOL * max(scale, 1e-30), f"{what}: {err} of {scale}"


@pytest.mark.parametrize("H,F", SHAPES)
def test_forward_matches_plain_version(plan, H, F):
    z, s_src, s_dst, _ = _inputs(plan, H, F)
    out, lse = ga.gat_attention(Lists.of(plan.fwd), z, s_src, s_dst,
                                negative_slope=SLOPE)
    want_out, want_lse = gat_attention_ref(
        plan.fwd["row_ptr"], plan.fwd["src"], z.double(), s_src.double(),
        s_dst.double(), negative_slope=SLOPE)
    _close(out, want_out, "out")
    _close(lse, want_lse, "lse")
    assert float(out[11].abs().max()) > 0          # its self loop


@pytest.mark.parametrize("H,F", SHAPES)
def test_backward_matches_plain_version(plan, H, F):
    z, s_src, s_dst, dout = _inputs(plan, H, F)
    out, lse = ga.gat_attention(Lists.of(plan.fwd), z, s_src, s_dst,
                                negative_slope=SLOPE)
    got = ga.gat_attention_bwd(Lists.of(plan.fwd), Lists.of(plan.bwd),
                               plan.bwd["fwd_pos"], z, s_src, s_dst, lse,
                               out, dout, negative_slope=SLOPE)
    d = lambda t: t.double()
    want = gat_attention_bwd_ref(
        plan.fwd["row_ptr"], plan.bwd["row_ptr"], plan.bwd["src"],
        plan.bwd["fwd_pos"], d(z), d(s_src), d(s_dst), d(lse),
        torch.sum(d(dout) * d(out), dim=-1), d(dout), negative_slope=SLOPE)
    for g, w, what in zip(got, want, ("dz", "ds_src", "ds_dst")):
        _close(g, w, what)


def test_reruns_are_bit_identical_and_counted(plan):
    z, s_src, s_dst, dout = _inputs(plan, 4, 256)
    f0, b0 = ga.gat_attention.launches, ga.gat_attention_bwd.launches
    runs = []
    for _ in range(2):
        out, lse = ga.gat_attention(Lists.of(plan.fwd), z, s_src, s_dst)
        grads = ga.gat_attention_bwd(Lists.of(plan.fwd), Lists.of(plan.bwd),
                                     plan.bwd["fwd_pos"], z, s_src, s_dst,
                                     lse, out, dout)
        runs.append((out, lse) + tuple(grads))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert ga.gat_attention.launches == f0 + 2
    assert ga.gat_attention_bwd.launches == b0 + 2


def _model(g, plan, seed=3):
    gen = torch.Generator().manual_seed(seed)
    params = gat_init(gen, 24, 16, 4, 5, 3, device="cuda", out_heads=6)
    x = torch.randn(g.num_nodes, 24, generator=gen).cuda()
    labels = torch.randint(0, 5, (g.num_nodes,), generator=gen).cuda()
    mask = (torch.rand(g.num_nodes, generator=gen) < 0.6).cuda()
    graph = {"src": torch.as_tensor(g.src).long().cuda(),
             "dst": torch.as_tensor(g.dst).long().cuda()}
    leaves = [t.requires_grad_(True) for lay in params["layers"]
              for t in (lay["w"]["w"], lay["a_src"], lay["a_dst"])]
    return params, leaves, x, labels, mask, graph


def test_fused_model_matches_the_segment_path_on_the_card(plan):
    g = _graph()
    params, leaves, x, labels, mask, graph = _model(g, plan)
    kw = {"skip": True, "self_loops": True}
    seg = gat_loss(params, x, graph, labels, mask, **kw)
    g_seg = torch.autograd.grad(seg, leaves)
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")     # no host sync in a layer
    try:
        fused = gat_loss(params, x, None, labels, mask, executor="fused",
                         plan=plan, **kw)
        g_fused = torch.autograd.grad(fused, leaves)
    finally:
        torch.cuda.set_sync_debug_mode(was)
    assert abs(float(fused) - float(seg)) <= TOL * abs(float(seg))
    for a, b in zip(g_fused, g_seg):
        _close(a, b.double(), "gradient")
