"""Serving launcher: online GCN and wide & deep inference on the port
(graph path of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --graph cora \\
      --model gcn|wide_deep --requests 200 --cache-kb 500 --warm reorder \\
      [--device cpu]

Micro-batcher -> reorder-aware embedding cache -> sampled forward, every
answer checked against the offline forward; exits 1 if they differ by 1e-4
or more.  ``gcn``: the offline full-graph forward runs through the
block-ELL kernels on ``cuda``.  ``wide_deep``: each of Cora's nodes is a
user of the reduced wide & deep model, scored by the user tower, whose
field lookup is the ``embedding_bag`` kernel on ``cuda``.  Runs on
``cuda`` unless ``--device cpu`` is given.  The LM path, the other graphs
and models, and ``--metrics-out`` / ``--trace`` are not ported yet.
"""
import argparse

from ..core import identity_order, minhash_reorder
from ..device import resolve_device
from ..graph import cora_like
from ..serve import (EmbeddingCache, MicroBatcher, ServeEngine, ServeReport,
                     make_session, zipfian_trace)


def serve_graph(args) -> ServeReport:
    resolve_device(args.device)
    if args.graph != "cora":
        raise SystemExit(f"unknown --graph {args.graph!r} (ported: cora)")
    g = cora_like(seed=0)
    print(f"graph {args.graph}: {g.num_nodes} nodes, {g.num_edges} edges; "
          f"model={args.model} device={args.device}")
    sess = make_session(args.model, g, seed=0, device=args.device)
    order = (minhash_reorder(g) if args.warm != "index"
             else identity_order(g))
    cache = EmbeddingCache(sess.layer_dims, args.cache_kb * 1024,
                           order=order, line_size=args.line_size,
                           num_nodes=g.num_nodes)
    eng = ServeEngine(sess, cache,
                      MicroBatcher(max_batch=args.max_batch,
                                   max_wait=args.max_wait_ms * 1e-3),
                      oracle_check=not args.no_oracle)
    if args.warm != "none":
        warmed = eng.warm(order)
        print(f"warmed {warmed} entries along {args.warm} order")
    trace = zipfian_trace(g.num_nodes, args.requests, a=args.zipf_a, seed=1)
    rep = eng.serve(trace)
    print(f"served {rep.num_requests} requests in {rep.num_batches} "
          f"micro-batches: hit_rate={rep.hit_rate:.3f} "
          f"offchip={rep.cache.bytes_missed / 1e6:.2f}MB "
          f"p50={rep.p50_ms:.2f}ms p99={rep.p99_ms:.2f}ms "
          f"req/s={rep.req_per_s:.0f}")
    if not args.no_oracle:
        ok = rep.max_oracle_err < 1e-4
        print(f"oracle check (vs offline full-graph forward): "
              f"max_err={rep.max_oracle_err:.2e} -> "
              f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)
    return rep


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="cora", help="dataset (ported: cora)")
    ap.add_argument("--model", default="gcn",
                    help="registered serve session (ported: gcn, "
                         "wide_deep)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--zipf-a", type=float, default=1.1)
    ap.add_argument("--cache-kb", type=int, default=500)
    ap.add_argument("--line-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--warm", default="reorder",
                    choices=["reorder", "index", "none"])
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> ServeReport:
    return serve_graph(parse_args(argv))


if __name__ == "__main__":
    main()
