"""The distributed slice on the card: the elastic aggregator's four shards
through ``spmm_blockell_compact`` (uint8 tiles for unit weights, float32
for the symmetric-normalised graph) against the ``torch`` backend on the
same card, values and gradients, with the launches each shard's plan
needs; and a one-rank NCCL group's ``halo_aggregate`` /
``allgather_aggregate`` / ``resilient_halo_aggregate`` against the
single-device segment-sum.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_dist.py

Tolerance 1e-5 of the largest |entry| (fp32 sums in another order).
"""
import datetime
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import minhash_reorder
from repro_torch.core.aggregate import segment_sum
from repro_torch.graph import DatasetSpec, synthesize

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repository's root)

pytestmark = pytest.mark.cuda
TOL = 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _close(got, ref, tol=TOL):
    err = float((got - ref).abs().max())
    assert err <= tol * max(1.0, float(ref.abs().max())), err


def _graph(n=1024):
    g = synthesize(DatasetSpec("t", n, 16000, 16, 4, community=0.9,
                               num_communities=8, seed=5))
    return g.permute(minhash_reorder(g))


def _oracle(g, x):
    src = torch.as_tensor(g.src.astype(np.int64), device=x.device)
    dst = torch.as_tensor(g.dst.astype(np.int64), device=x.device)
    msgs = x[src]
    if g.edge_weight is not None:
        msgs = msgs * torch.as_tensor(g.edge_weight, device=x.device)[:, None]
    return segment_sum(msgs, dst, g.num_nodes)


@pytest.mark.parametrize("d", [16, 200])
@pytest.mark.parametrize("normed", [False, True], ids=["u8", "f32"])
def test_elastic_shards_on_the_card(tmp_path, monkeypatch, d, normed):
    _need_cuda()
    from repro_torch.dist import ElasticAggregator
    from repro_torch.kernels import spmm_blockell as sk
    monkeypatch.setenv("REPRO_TORCH_EXEC_CACHE", str(tmp_path))
    g = _graph().with_sym_norm() if normed else _graph()
    agg = ElasticAggregator(g, 4, device="cuda")
    plain = ElasticAggregator(g, 4, backend="torch", device="cuda")
    plans = [s.plan.plan_for(s.plan.backend) for s in agg.topology.shards]
    tiles = torch.float32 if normed else torch.uint8
    assert all(p.backend == "cuda" for p in plans)
    # the shards' plans hold entry lists; their tiles, as the tile walk
    # would read them, are the bitmask or the weights
    assert all(p.meta_fwd.lists and p.meta_bwd.lists for p in plans)
    assert all(("coef" in p._fwd) == normed for p in plans)
    assert all(chip_smoke.tile_arrays(p)["blocks"].dtype == tiles
               for p in plans)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn((g.num_nodes, d), generator=gen, device="cuda")
    r = torch.randn((g.num_nodes, d), generator=gen, device="cuda")
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    sk.spmm_blockell_compact.launches = 0
    y = agg.aggregate_fn("halo")(xk)
    (y * r).sum().backward()
    torch.cuda.synchronize()
    want = (sum(p.meta_fwd.n_active > 0 for p in plans)
            + sum(p.meta_bwd.n_active > 0 for p in plans))
    assert sk.spmm_blockell_compact.launches == want
    yp = plain.aggregate_fn("halo")(xp)
    (yp * r).sum().backward()
    _close(y, yp)
    _close(y, _oracle(g, x))
    _close(xk.grad, xp.grad)


@pytest.fixture()
def nccl_rank(tmp_path):
    _need_cuda()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_nccl_rank_halo_and_allgather(nccl_rank):
    from repro_torch.chaos import Fault, FaultPlan, armed
    from repro_torch.dist import (allgather_aggregate, build_send_plan,
                                  halo_aggregate, resilient_halo_aggregate)
    from repro_torch.graph import build_halo_plan
    from repro_torch.launch.mesh import make_halo_debug_mesh
    g = _graph()
    plan = build_halo_plan(g, 1)
    send = build_send_plan(plan)
    mesh = make_halo_debug_mesh(1, device="cuda")
    assert dist.get_backend() == "nccl"
    x = torch.randn((g.num_nodes, 32), device="cuda")
    ref = _oracle(g, x)
    n = g.num_nodes
    _close(halo_aggregate(mesh, x, plan, send, n), ref)
    _close(allgather_aggregate(mesh, x, plan, n), ref)
    with armed(FaultPlan.of(Fault("dist.halo", "shard_loss", count=3))):
        _close(resilient_halo_aggregate(mesh, x, plan, send, n), ref)
    xg = x.clone().requires_grad_(True)
    halo_aggregate(mesh, xg, plan, send, n).sum().backward()
    xo = x.clone().requires_grad_(True)
    _oracle(g, xo).sum().backward()
    _close(xg.grad, xo.grad)
