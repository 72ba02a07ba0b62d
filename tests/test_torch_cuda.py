"""The port on the card: each CUDA kernel against its plain version, and
the serving slice through the kernel.

Every test here needs an NVIDIA GPU with nvcc; it is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false.  The file imports
neither jax nor the reference package, so it also runs where only the port
is installed (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Kernel against plain version: 1e-5 (fp32 sums of at most a row's slots x bk
terms in another order).  Served answers against the kernel-computed
oracle: 1e-4, the launcher's own bar.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import build_blockell
from repro_torch.exec import build_plan
from repro_torch.graph import DatasetSpec, Graph, cora_like, synthesize
from repro_torch.kernels import spmm_blockell as sk
from repro_torch.kernels.ref import spmm_blockell_compact_ref
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
