"""Quickstart on the PyTorch port: the Rubik pipeline on a Cora-scale graph,
the four steps of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. LSH (MinHash) reordering and the G-D cache's off-chip traffic, Index
   order against LR (64 PEs, 128 KB each, 1433 features);
2. the shared-set plan (G-C computation reuse) and its executor against the
   segment executor;
3. the block-ELL tiling of the normalized adjacency and its traffic model;
4. 30 steps of a GCN [1433, 16, 7] on the reordered graph.

Runs on ``cuda`` unless ``--device cpu`` is given.  Exits with an
``AssertionError`` if the shared-set executor disagrees with the segment
executor or the loss does not fall.
"""
import argparse

import torch

from repro_torch.core import (build_blockell, build_shared_plan,
                              minhash_reorder, segment_aggregate,
                              shared_aggregate, simulate_gd, traffic_model)
from repro_torch.device import resolve_device
from repro_torch.graph import cora_like
from repro_torch.models import gcn_init, gcn_loss
from repro_torch.models.gcn import make_graph_inputs
from repro_torch.train import adam, fit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)

    g = cora_like()
    print(f"graph: {g.num_nodes} nodes, {g.num_valid_edges} edges")

    # 1. Rubik step 1 — LSH reordering (paper §IV-A)
    g_lr = g.permute(minhash_reorder(g))
    base = simulate_gd(g, 64, 128 << 10, 1433)
    lr = simulate_gd(g_lr, 64, 128 << 10, 1433)
    print(f"off-chip traffic: index={base.offchip_bytes / 1e6:.1f}MB "
          f"-> LR={lr.offchip_bytes / 1e6:.1f}MB "
          f"({1 - lr.offchip_bytes / base.offchip_bytes:.1%} eliminated)")

    # 2. Rubik step 2 — shared-set computation reuse (G-C cache)
    plan = build_shared_plan(g_lr)
    print(f"shared-set plan: {plan.shared_edges} shared edges, "
          f"{plan.reduction_ratio:.1%} reductions eliminated")
    t = lambda a: torch.as_tensor(a).to(dev)
    x = t(g_lr.node_feat)
    a = segment_aggregate(x, t(g_lr.src), t(g_lr.dst), g.num_nodes)
    b = shared_aggregate(x, plan)
    exact = bool(torch.allclose(a, b, atol=1e-3))
    print("CR executor exact:", exact)

    # 3. block-sparse aggregation (the block-ELL tiles the kernels walk)
    ell = build_blockell(g_lr.with_sym_norm(), bm=128, bk=128)
    tm = traffic_model(ell, 128)
    print(f"block-ELL: {tm['active_blocks']} active blocks, "
          f"mean density {tm['mean_block_density']:.4f}")

    # 4. train a GCN on the reordered graph
    graph = make_graph_inputs(g_lr, device=dev)
    params = gcn_init(torch.Generator().manual_seed(0), [1433, 16, 7],
                      device=dev)
    batch = {"x": x, "labels": t(g_lr.labels.astype("int64")),
             "mask": t(g_lr.train_mask)}
    loss_fn = lambda p, b: gcn_loss(p, b["x"], graph, b["labels"], b["mask"])
    res = fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
              steps=30, log_every=10)
    print(f"GCN loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    assert exact, "the shared-set executor disagrees with the segment one"
    assert res.losses[-1] < res.losses[0], res.losses
    return {"index": base, "lr": lr, "plan": plan, "traffic": tm,
            "losses": res.losses}


if __name__ == "__main__":
    main()
