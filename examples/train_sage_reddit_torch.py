"""End-to-end example on the PyTorch port: train GraphSAGE on a REDDIT-style
community graph — MinHash reordering, sampled minibatches (fanouts 15, 10),
Adam with gradient clipping and the straggler watchdog — as
``examples/train_sage_reddit.py`` does with the JAX package.

  PYTHONPATH=src python examples/train_sage_reddit_torch.py \\
      [--steps 200] [--scale 0.01] [--batch-nodes 512] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  The reference's
``AsyncCheckpointer`` is left out: checkpoints are not ported yet.  Exits
with an ``AssertionError`` if the mean of the last 10 losses is not below
that of the first 10.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import minhash_reorder
from repro_torch.device import resolve_device
from repro_torch.graph import NeighborSampler, reddit_like
from repro_torch.models import sage_block_apply, sage_init
from repro_torch.nn.layers import cross_entropy, linear_apply, linear_init
from repro_torch.train import (StepWatchdog, adam, make_train_step,
                               minibatch_tensors)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--batch-nodes", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = reddit_like(scale=args.scale)
    g = g.permute(minhash_reorder(g))     # Rubik preprocessing (one-off)
    d = g.node_feat.shape[1]
    classes = int(g.labels.max()) + 1
    print(f"graph: {g.num_nodes} nodes {g.num_valid_edges} edges d={d}")

    sampler = NeighborSampler(g, fanouts=(15, 10), seed=0)
    gen = torch.Generator().manual_seed(0)
    params = {"sage": sage_init(gen, [d, 256, 256], device=dev),
              "head": linear_init(gen, 256, classes, device=dev)}

    def loss_fn(p, batch):
        h = sage_block_apply(p["sage"], batch["x"], batch["blocks"])
        logits = linear_apply(p["head"], h[batch["seed_rows"]])
        return cross_entropy(logits, batch["labels"])

    opt = adam(1e-3)
    step = make_train_step(loss_fn, opt)
    opt_state = opt.init(params)
    watchdog = StepWatchdog()
    losses = []
    for i, mb in enumerate(sampler.batches(args.batch_nodes, args.steps)):
        batch = minibatch_tensors(g, mb, dev)
        t0 = time.time()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))       # waits for the step to finish
        watchdog.observe(time.time() - t0)
        if i % 20 == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f}")
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(start {np.mean(losses[:10]):.4f}); "
          f"stragglers flagged: {watchdog.flagged}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "did not learn"
    return losses


if __name__ == "__main__":
    main()
