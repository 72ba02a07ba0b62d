"""Training launcher: full-graph GNN training (one card, or sharded over
ranks with ``--dist``), wide & deep and the LMs (dense and MoE) on the port
(``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --steps 50 [--executor auto|forward|fused|blockell|segment] \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora \\
      --steps 50 [--device cpu]          (also pna, nequip)
  PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep \\
      --steps 50 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --reduced --steps 10 [--ckpt DIR] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --dist [--parts N] [--aggregator halo|allgather|resilient] \\
      [--device cpu]

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
``gat-cora``, ``pna`` and ``nequip`` train on the same graph through their
segment ops (no kernel, as in the reference); an explicit kernel executor
(``forward``, ``fused``, ``blockell``) raises for them.

``--arch wide-deep`` trains the ``REDUCED`` config as the reference does:
batches of 256 from ``recsys_batches``, ``adam(1e-3)``, both sparse lookups
through the ``embedding_bag`` kernel (forward and the table's gradient).
An LM arch (``granite-8b``, ``minitron-8b``, ``mistral-large-123b``, and
the MoE ``granite-moe-3b-a800m`` and ``llama4-maverick-400b-a17b``) trains
its ``REDUCED`` config as the reference does (``--reduced`` is always on):
batches of 4 x 64 tokens from ``lm_token_batches``, ``adam(1e-3)``,
``lm_loss`` (with the MoE layers' aux loss at weight 0.01).  ``--ckpt DIR`` resumes from the latest
checkpoint in DIR and writes one every 100 steps and at the end.  Runs on
``cuda`` unless ``--device cpu`` is given.  ``--metrics-out`` /
``--trace`` / ``--summary`` work as in ``launch.serve``: the registry
(``train.steps``, ``exec.plan.compiles``, ``exec.autotune.trials``, the
schedule's ``exec.forward.verdict{source}``, ...) and a trace of the
``train.step`` and ``exec.autotune.trial`` spans, stamped with the run's
provenance.

``--dist`` (GCN/SAGE only, as in the reference) trains the sharded layer of
``dist.gnn.train_distributed``: the reordered Cora in ``--parts``
contiguous windows, one rank each (NCCL, one rank per card, on ``cuda``:
``--parts`` defaults to the card count and more raise; gloo processes on
the CPU, one part by default), every aggregation through
``--aggregator``'s collective.  It prints the reference's ``dist[...]``
line (cut fraction, halo vs all-gather bytes per chip), the backend, the
first and last loss, then every loss as JSON; ``--ckpt`` writes
buddy-mirrored checkpoints every 10 steps, and rank 0 writes
``--metrics-out`` / ``--trace``.
"""
import argparse
import importlib
import json

import numpy as np
import torch

from .. import obs
from ..configs import get
from ..configs.wide_deep import REDUCED
from ..core import minhash_reorder
from ..device import resolve_device
from ..exec import autotune_forward, build_plan, gcn_chain, plan_forward
from ..graph import cora_like
from ..models.recsys import widedeep_init, widedeep_loss
from ..models.transformer import lm_init, lm_loss
from ..train import TrainResult, adam, fit, lm_token_batches, recsys_batches


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
    ``auto`` / ``forward`` (printing the verdict and counting it in
    ``exec.forward.verdict{source}`` / ``exec.forward.verdict_us``, as the
    reference does), ``plan_forward`` for ``fused``; then one line per
    layer, as the reference prints them."""
    if executor in ("auto", "forward"):
        fplan, rec = autotune_forward(g, specs, device=device)
        obs.counter("exec.forward.verdict", source=rec.source).inc()
        obs.gauge("exec.forward.verdict_us").set(rec.us)
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
    """The reference's ``gnn_driver``: seed-0 weights, ``adam(1e-2)``, clip
    1.0, the full-graph batch of the reordered Cora.  GCN runs
    ``executor``'s plans; GAT, PNA and NequIP run their segment ops under
    ``auto`` and ``segment``, and their ``GNNBundle.loss_fn`` raises for a
    kernel executor (the reference prints a warning and runs the segment
    path).  NequIP takes
    ``species = labels % 10``, ``pos = node_feat[:, :3]`` and an energy
    target of 0."""
    dev = resolve_device(device)
    bundle = get(arch).bundle()
    if executor not in ("auto", "forward", "fused", "blockell", "segment"):
        raise ValueError(f"unknown executor {executor!r}")
    g = training_graph()
    exec_plan = None
    loss_executor = executor
    if bundle.arch != "gcn":
        loss_executor = "segment" if executor == "auto" else executor
    elif executor in ("auto", "forward", "fused"):
        specs = gcn_chain([g.node_feat.shape[1], *bundle.model_kw["hidden"],
                           bundle.n_classes])
        exec_plan = schedule_plans(g, specs, executor, dev)
        loss_executor = "fused"
    elif executor == "blockell":
        exec_plan = build_plan(g, "gcn", bm=128, backend="cuda", device=dev)
    loss_fn = bundle.loss_fn("full_graph_sm", executor=loss_executor,
                             exec_plan=exec_plan)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                g.node_feat.shape[1], device=dev)
    batch = gnn_batch(g, bundle.n_classes, dev)
    if bundle.arch == "nequip":
        batch["species"] = torch.as_tensor(g.labels % 10).to(dev)
        batch["pos"] = torch.as_tensor(
            np.ascontiguousarray(g.node_feat[:, :3])).to(dev)
        batch["energy_target"] = torch.zeros((), device=dev)
        for k in ("x", "deg"):
            batch.pop(k)
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


def lm_reduced_driver(arch: str, steps: int, ckpt=None, device="cuda"
                      ) -> TrainResult:
    """The reference's ``lm_reduced_driver``: the arch's ``REDUCED``
    config, seed-0 weights, adam(1e-3), 4 x 64-token batches."""
    cfg = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_")).REDUCED
    dev = resolve_device(device)
    params = lm_init(torch.Generator().manual_seed(0), cfg, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)

    def loss_fn(p, b):
        return lm_loss(p, t(b["tokens"]), t(b["targets"]), cfg)
    return fit(loss_fn, adam(1e-3), params,
               lm_token_batches(cfg.vocab, 4, 64), steps=steps,
               ckpt_dir=ckpt)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: resume from its latest "
                         "checkpoint, save every 100 steps and at the end")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the arch's smoke config (always on, as in "
                         "the reference)")
    ap.add_argument("--dist", action="store_true",
                    help="shard the graph over ranks and route aggregation "
                         "through the halo exchange (GNN only): NCCL, one "
                         "rank per card, or gloo processes with --device "
                         "cpu")
    ap.add_argument("--parts", type=int, default=None,
                    help="number of graph shards (ranks) for --dist "
                         "(default: the card count; 1 with --device cpu)")
    ap.add_argument("--aggregator", default="halo",
                    choices=["halo", "allgather", "resilient"],
                    help="collective for --dist: the halo exchange, the "
                         "full-table allgather baseline, or the resilient "
                         "ladder (retry then per-step allgather fallback)")
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
    obs.add_cli_flags(ap)
    ap.add_argument("--summary", action="store_true",
                    help="after the run, print the repro_torch.obs.summary "
                         "one-pager for --metrics-out / --trace files")
    args = ap.parse_args(argv)
    if args.summary and not (args.metrics_out or args.trace):
        ap.error("--summary needs --metrics-out and/or --trace")
    if args.dist and get(args.arch).family != "gnn":
        ap.error(f"--dist supports GNN archs; {args.arch} is family "
                 f"'{get(args.arch).family}'")
    return args


def main(argv=None):
    args = parse_args(argv)
    spec = get(args.arch)
    try:
        if args.dist:
            return _train_dist(args)
        with obs.observed_run(args.metrics_out, args.trace,
                              device=args.device):
            return _train(args, spec)
    finally:
        if args.summary:
            from ..obs import summary as _summary
            _summary.main([f for f in (args.metrics_out, args.trace) if f])


def _train_dist(args) -> dict:
    """``--dist``: the ranks write the telemetry files (rank 0)."""
    from ..dist import train_distributed
    res = train_distributed(args.arch, steps=args.steps, parts=args.parts,
                            aggregator=args.aggregator, ckpt_dir=args.ckpt,
                            ckpt_every=10 if args.ckpt else 0,
                            device=args.device, metrics_out=args.metrics_out,
                            trace=args.trace)
    losses = res["losses"]
    print(f"{args.arch} [dist]: {len(losses)} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"{args.arch} [dist] losses: {json.dumps(losses)}")
    return res


def _train(args, spec) -> TrainResult:
    if spec.family == "gnn":
        res = gnn_driver(args.arch, args.steps, args.ckpt,
                         executor=args.executor, device=args.device)
    elif spec.family == "recsys":
        res = recsys_driver(args.arch, args.steps, args.ckpt,
                            device=args.device)
    else:
        res = lm_reduced_driver(args.arch, args.steps, args.ckpt,
                                device=args.device)
    if not res.losses:
        print(f"{args.arch}: nothing to train, the checkpoint in "
              f"{args.ckpt} is at or past step {args.steps}")
        return res
    print(f"{args.arch}: {res.steps} steps, loss "
          f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"{res.wall_time:.1f}s, stragglers={res.straggler_flags}")
    return res


if __name__ == "__main__":
    main()
