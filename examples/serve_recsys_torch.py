"""Serving example on the PyTorch port: wide & deep CTR scoring and
retrieval (batched requests), as ``examples/serve_recsys.py`` runs it on
the JAX package.

Both sparse lookups go through ``repro_torch.kernels.ops.embedding_bag``
(``lookup="bag"``: the hand-written kernel on the card, its plain version
on the CPU) and are checked within 1e-4 against the dense-lookup path
(``lookup="dense"``): the deep part's per-field gather is a bag of exactly
one id per (row, field) slot, the wide part a true F-id bag sum over the
embed_dim = 1 table.  Inputs are drawn in numpy from a seed.

  PYTHONPATH=src python examples/serve_recsys_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.wide_deep import REDUCED as CFG
from repro_torch.device import resolve_device
from repro_torch.models import retrieval_score, widedeep_init, widedeep_logits

TOL = 1e-4


def _inputs(rng, batch, dev):
    ids = rng.integers(0, CFG.rows_per_field, (batch, CFG.n_sparse))
    dense = rng.standard_normal((batch, CFG.n_dense)).astype(np.float32)
    return (torch.as_tensor(ids.astype(np.int32), device=dev),
            torch.as_tensor(dense, device=dev))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    params = widedeep_init(torch.Generator().manual_seed(0), CFG, device=dev)

    @torch.no_grad()
    def serve(ids, dense, lookup="bag"):
        return widedeep_logits(params, ids, dense, CFG, lookup)

    # bag path (embedding_bag) vs the dense lookup
    ids, dense = _inputs(rng, 16, dev)
    ker, ref = serve(ids, dense), serve(ids, dense, "dense")
    err = float((ker - ref).abs().max())
    assert err <= TOL * max(1.0, float(ref.abs().max())), err
    print(f"embedding_bag path matches dense lookup (max_err={err:.2e})")

    # batched online scoring (serve_p99 shape, reduced)
    times = {}
    for batch in (64, 512):
        ids, dense = _inputs(rng, batch, dev)
        serve(ids, dense)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            serve(ids, dense)
        sync()
        dt = (time.perf_counter() - t0) / 5
        times[batch] = dt
        print(f"batch={batch:5d}: {dt * 1e3:.2f} ms/batch "
              f"({batch / dt:.0f} req/s)")

    # retrieval: one query against a candidate corpus (one matvec)
    cand = torch.as_tensor(rng.standard_normal(
        (100_000, CFG.mlp_dims[-1])).astype(np.float32), device=dev)
    ids, dense = _inputs(rng, 1, dev)
    with torch.no_grad():
        s = retrieval_score(params, ids, dense, cand, CFG)
    top = torch.argsort(-s)[:5].tolist()
    print("retrieval top-5 candidates:", top)
    return {"max_err": err, "seconds": times, "top5": top}


if __name__ == "__main__":
    main()
