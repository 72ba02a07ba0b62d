"""Training launcher: full-graph GNN training and wide & deep on the port
(the GNN and recsys paths of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --steps 50 [--executor auto|forward|fused|blockell|segment] \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep \\
      --steps 50 [--device cpu]

The graph is ``cora_like()`` permuted by ``minhash_reorder``, as in the
reference.  ``--executor auto`` (the default, as in the reference) and
``forward`` schedule the WHOLE forward by measurement
(``exec.autotune_forward``): every layer's (order, fusion, backend, block
shape, compaction, degree buckets) is raced on the device over the
candidate grid — compact, padded and bucketed plans on ``cuda`` on the card,
``coo`` and ``torch`` on the CPU — then the per-layer-greedy, warm-DP and
cold-DP schedules race as whole-chain forward+backward passes, and the
verdict is cached on disk (``$REPRO_TORCH_EXEC_CACHE`` or
``~/.cache/repro_torch/exec``; delete it to tune afresh).  ``fused`` trusts
the DP over the cache or, cold, the FLOP/byte model, without measuring
(``exec.plan_forward``).  ``blockell`` (one aggregation plan plus a separate
matmul) and ``segment`` (the edge list) work as in the reference.

``--arch wide-deep`` trains the ``REDUCED`` config as the reference does:
batches of 256 from ``recsys_batches``, ``adam(1e-3)``, both sparse lookups
through the ``embedding_bag`` kernel (forward and the table's gradient).
Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from ..configs import get
from ..configs.wide_deep import REDUCED
from ..core import minhash_reorder
from ..device import resolve_device
from ..exec import autotune_forward, build_plan, gcn_chain, plan_forward
from ..graph import cora_like
from ..models.recsys import widedeep_init, widedeep_loss
from ..train import TrainResult, adam, fit, recsys_batches


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


def schedule_plans(g, specs, executor: str, device="cuda"):
    """The whole-forward plan of ``--executor``: ``autotune_forward`` for
    ``auto`` / ``forward`` (printing the verdict), ``plan_forward`` for
    ``fused``; then one line per layer, as the reference prints them."""
    if executor in ("auto", "forward"):
        fplan, rec = autotune_forward(g, specs, device=device)
        greedy = rec.greedy_us
        print(f"forward autotune: schedule={rec.source} "
              f"{rec.us:.0f}us whole-chain"
              + (f" (per-layer-greedy {greedy:.0f}us, "
                 f"{rec.speedup_vs_greedy:.2f}x)"
                 if greedy is not None else "")
              + (" (cached)" if rec.from_cache else ""))
    else:
        fplan = plan_forward(g, specs, device=device)
    for i, (s, lp) in enumerate(zip(specs, fplan.layers)):
        print(f"layer {i} ({s.d_in}->{s.d_out}): order={lp.order} "
              f"fuse={lp.fuse} {lp.backend} bm={lp.gplan.bm} "
              f"compact={lp.gplan.compact}"
              + (f" buckets={lp.gplan.buckets}" if lp.gplan.buckets else ""))
    return fplan


def gnn_driver(arch: str, steps: int, ckpt=None, executor: str = "auto",
               device="cuda") -> TrainResult:
    dev = resolve_device(device)
    bundle = get(arch).bundle()
    g = training_graph()
    exec_plan = None
    loss_executor = executor
    if executor in ("auto", "forward", "fused"):
        specs = gcn_chain([g.node_feat.shape[1], *bundle.model_kw["hidden"],
                           bundle.n_classes])
        exec_plan = schedule_plans(g, specs, executor, dev)
        loss_executor = "fused"
    elif executor == "blockell":
        exec_plan = build_plan(g, "gcn", bm=128, backend="cuda", device=dev)
    elif executor != "segment":
        raise ValueError(f"unknown executor {executor!r}")
    loss_fn = bundle.loss_fn("full_graph_sm", executor=loss_executor,
                             exec_plan=exec_plan)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                g.node_feat.shape[1], device=dev)
    batch = gnn_batch(g, bundle.n_classes, dev)
    return fit(loss_fn, adam(1e-2), params, iter(lambda: batch, None),
               steps=steps, ckpt_dir=ckpt, clip_norm=1.0)


def recsys_driver(arch: str, steps: int, ckpt=None, device="cuda",
                  lookup: str = "bag") -> TrainResult:
    """The reference's ``recsys_driver``: ``REDUCED``, batch 256, adam(1e-3),
    seed-0 weights; ``lookup`` as in ``models.recsys``."""
    cfg = REDUCED
    dev = resolve_device(device)
    params = widedeep_init(torch.Generator().manual_seed(0), cfg, device=dev)
    t = lambda a: torch.as_tensor(a).to(dev)

    def loss_fn(p, b):
        return widedeep_loss(p, t(b["sparse"]), t(b["dense"]),
                             t(b["labels"]), cfg, lookup)
    return fit(loss_fn, adam(1e-3), params, recsys_batches(cfg, 256),
               steps=steps, ckpt_dir=ckpt)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (not ported yet)")
    ap.add_argument("--dist", action="store_true",
                    help="shard the graph over devices (not ported yet)")
    ap.add_argument("--executor", default="auto",
                    choices=["auto", "segment", "blockell", "fused",
                             "forward"],
                    help="GNN execution engine: 'auto' (default) and "
                         "'forward' schedule the whole forward by measured "
                         "whole-chain fwd+bwd races, cached on disk; "
                         "'fused' trusts the DP over the cache or the "
                         "FLOP/byte model without measuring; 'blockell' one "
                         "aggregation plan plus a separate matmul; "
                         "'segment' the edge list")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    if args.dist:
        raise NotImplementedError("--dist is not ported yet (ROADMAP §1 "
                                  "item 9)")
    if args.ckpt:
        raise NotImplementedError("--ckpt is not ported yet (ROADMAP §1 "
                                  "item 6)")
    spec = get(args.arch)
    if spec.family == "gnn":
        res = gnn_driver(args.arch, args.steps, args.ckpt,
                         executor=args.executor, device=args.device)
    elif spec.family == "recsys":
        res = recsys_driver(args.arch, args.steps, args.ckpt,
                            device=args.device)
    else:
        raise NotImplementedError(f"the {spec.family} family is not ported "
                                  "yet (ROADMAP §1 item 8)")
    print(f"{args.arch}: {res.steps} steps, loss "
          f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"{res.wall_time:.1f}s, stragglers={res.straggler_flags}")
    return res


if __name__ == "__main__":
    main()
