"""Training launcher: full-graph GNN training on the port (the GNN path of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --steps 50 [--executor fused|blockell|segment] [--device cpu]

The graph is ``cora_like()`` permuted by ``minhash_reorder``, as in the
reference.  ``--executor fused`` (the default) builds one
``LayerExecutionPlan`` per layer with ``order="auto"`` over one shared
``GraphExecutionPlan`` on the ``cuda`` backend: for gcn-cora that is the
schedule the reference's whole-forward DP picks (both layers update-first,
one ``spmm_blockell_compact`` launch per layer forward and one per layer
backward).  On ``--device cpu`` the same plans run the kernels' plain
versions.  ``blockell`` and ``segment`` work as in the reference.
``auto`` and ``forward`` choose by racing measured candidates
(``repro/exec/autotune.py``, ``repro/exec/forward.py``), which is not
ported yet.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from ..configs import get
from ..core import minhash_reorder
from ..device import resolve_device
from ..exec import build_layer_plan, build_plan
from ..graph import cora_like
from ..train import TrainResult, adam, fit

NOT_PORTED_EXECUTORS = ("auto", "forward")


def training_graph():
    """``cora_like()`` permuted by ``minhash_reorder``, as the reference's
    launcher trains on."""
    return cora_like().permute(minhash_reorder(cora_like()))


def gnn_batch(g, n_classes: int, device="cuda") -> dict:
    """The full-graph batch of the reference's ``gnn_driver``."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a).to(dev)
    deg = g.in_degrees().astype(np.float32) + 1.0
    return {"src": t(g.src.astype(np.int64)),
            "dst": t(g.dst.astype(np.int64)),
            "edge_mask": torch.ones(g.num_edges, dtype=torch.bool,
                                    device=dev),
            "labels": t(g.labels % n_classes), "train_mask": t(g.train_mask),
            "x": t(g.node_feat), "deg": t(deg)}


def layer_plans(g, mode: str, dims, *, backend: str = "cuda",
                device="cuda") -> list:
    """One ``LayerExecutionPlan`` per layer of ``dims = [d_in, ..., d_out]``
    over one shared graph plan, each with ``order="auto"`` at bm = 128."""
    plans, gplan = [], None
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lp = build_layer_plan(g, mode, d_in=d_in, d_out=d_out, order="auto",
                              bm=128, backend=backend, gplan=gplan,
                              device=device)
        plans.append(lp)
        gplan = lp.gplan
    return plans


def gnn_driver(arch: str, steps: int, ckpt=None, executor: str = "fused",
               device="cuda") -> TrainResult:
    dev = resolve_device(device)
    if executor in NOT_PORTED_EXECUTORS:
        raise NotImplementedError(
            f"--executor {executor} races measured schedules (autotune and "
            "the whole-forward DP), which are not ported yet (ROADMAP §1 "
            "item 5); use fused, blockell or segment")
    bundle = get(arch).bundle()
    g = training_graph()
    exec_plan = None
    if executor == "fused":
        exec_plan = layer_plans(g, "gcn", [g.node_feat.shape[1],
                                           *bundle.model_kw["hidden"],
                                           bundle.n_classes], device=dev)
        for i, lp in enumerate(exec_plan):
            print(f"layer {i} ({lp.d_in}->{lp.d_out}): order={lp.order} "
                  f"fuse={lp.fuse} {lp.backend} bm={lp.gplan.bm} "
                  f"compact=True")
    elif executor == "blockell":
        exec_plan = build_plan(g, "gcn", bm=128, backend="cuda", device=dev)
    elif executor != "segment":
        raise ValueError(f"unknown executor {executor!r}")
    loss_fn = bundle.loss_fn("full_graph_sm", executor=executor,
                             exec_plan=exec_plan)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                g.node_feat.shape[1], device=dev)
    batch = gnn_batch(g, bundle.n_classes, dev)
    return fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
               steps=steps, ckpt_dir=ckpt, clip_norm=1.0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (not ported yet)")
    ap.add_argument("--dist", action="store_true",
                    help="shard the graph over devices (not ported yet)")
    ap.add_argument("--executor", default="fused",
                    choices=["auto", "segment", "blockell", "fused",
                             "forward"],
                    help="GNN execution engine: 'fused' (default) runs one "
                         "layer plan per layer with the FLOP/byte model's "
                         "order; 'blockell' one aggregation plan plus a "
                         "separate matmul; 'segment' the edge list; 'auto' "
                         "and 'forward' wait for the ported autotune")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    if args.dist:
        raise NotImplementedError("--dist is not ported yet (ROADMAP §1 "
                                  "item 9)")
    spec = get(args.arch)
    if spec.family != "gnn":
        raise NotImplementedError(f"the {spec.family} family is not ported "
                                  "yet (ROADMAP §1 item 8)")
    res = gnn_driver(args.arch, args.steps, args.ckpt,
                     executor=args.executor, device=args.device)
    print(f"{args.arch}: {res.steps} steps, loss "
          f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"{res.wall_time:.1f}s, stragglers={res.straggler_flags}")
    return res


if __name__ == "__main__":
    main()
