"""Serving launcher: an LM's prefill + decode loop, or online GCN,
GraphSAGE and wide & deep inference on the port (``repro/launch/serve.py``).

LM path (the ``REDUCED`` config, as the reference runs it), taken when
``--graph`` is absent:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --tokens 16 --batch 2 --prompt-len 16 [--device cpu]

Parameters and the prompt come from a generator seeded 0 (on the CPU, so
every device gets the same ones); ``lm_prefill`` fills caches padded to
``max(64, prompt + tokens + 1)`` positions, then ``--tokens`` greedy
``lm_decode_step``s run, each layer's attention through the flash-decode
kernel on ``cuda``.  Prints the generated ids and tokens/s.

Graph path:

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --graph cora|citeseer-s|reddit [--scale 0.02] \\
      --model gcn|sage_gin|wide_deep --requests 200 --cache-kb 500 \\
      --warm reorder [--device cpu]

``citeseer-s`` and ``reddit`` are the paper's Table I stand-ins at
``--scale`` (nodes and edges scaled by it, features by ``min(4 scale,
1)``).  Micro-batcher -> reorder-aware embedding cache -> sampled forward,
every answer checked against the offline forward; exits 1 if they differ by
1e-4 or more.  ``gcn`` and ``sage_gin`` (GraphSAGE, dims [d, 64, 16]): the
offline full-graph forward runs through the block-ELL kernels on ``cuda``.
``wide_deep``: each of the graph's nodes is a user of the reduced wide &
deep model, scored by the user tower, whose field lookup is the
``embedding_bag`` kernel on ``cuda``.  Runs on ``cuda`` unless ``--device
cpu`` is given.  The MoE LMs and ``--metrics-out`` / ``--trace`` are not
ported yet.
"""
import argparse
import dataclasses
import importlib
import time

import torch

from ..configs import get
from ..core import identity_order, minhash_reorder
from ..device import resolve_device
from ..graph import citeseer_s_like, cora_like, reddit_like
from ..models.transformer import (lm_decode_step, lm_init, lm_prefill,
                                  make_kv_caches)
from ..serve import (EmbeddingCache, MicroBatcher, ServeEngine, ServeReport,
                     make_session, zipfian_trace)


@dataclasses.dataclass
class LMServeResult:
    tokens: torch.Tensor      # (batch, tokens + 1): prefill's, then steps'
    logits: torch.Tensor      # (tokens, batch, vocab): each decode step's
    seconds: float            # the decode loop, synchronised


def serve_lm(args, attn: str = "kernel") -> LMServeResult:
    """The reference's ``serve_lm`` at ``REDUCED``; ``attn`` picks the
    decode attention (``"plain"``: the reference's einsums)."""
    dev = resolve_device(args.device)
    get(args.arch)                      # raises for an arch not ported
    mod = importlib.import_module(
        "repro_torch.configs." + args.arch.replace("-", "_"))
    cfg = mod.REDUCED
    prompt_len = args.prompt_len
    max_seq = max(64, prompt_len + args.tokens + 1)
    gen = torch.Generator().manual_seed(0)
    params = lm_init(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, prompt_len),
                           generator=gen).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.inference_mode():
        logits, caches = lm_prefill(params, prompt, cfg)
        full = make_kv_caches(cfg, args.batch, max_seq, device=dev)
        for buf, c in zip(full["dense"], caches["dense"]):
            buf[:, :, :prompt_len] = c
        del caches
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out_tokens, out_logits = [tok], []
        sync()
        t0 = time.perf_counter()
        for i in range(args.tokens):
            logits, full = lm_decode_step(params, tok, full, prompt_len + i,
                                          cfg, max_seq, attn=attn)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out_tokens.append(tok)
            out_logits.append(logits[:, 0])
        sync()
        dt = time.perf_counter() - t0
    seq = torch.cat(out_tokens, dim=1).cpu()
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print("generated:", seq[0].tolist())
    print(f"{args.tokens} tokens x {args.batch} batch in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s on {where})")
    return LMServeResult(seq, torch.stack(out_logits), dt)


def load_graph(name: str, scale: float):
    """The ``--graph`` dataset at ``--scale`` (Cora ignores the scale)."""
    if name == "cora":
        return cora_like(seed=0)
    if name == "citeseer-s":
        return citeseer_s_like(scale=scale, seed=0)
    if name == "reddit":
        return reddit_like(scale=scale, seed=0)
    raise SystemExit(f"unknown --graph {name!r} "
                     "(choices: cora, citeseer-s, reddit)")


def serve_graph(args, g=None) -> ServeReport:
    """The graph path; ``g`` is ``load_graph(args.graph, args.scale)``
    when the caller has loaded it already."""
    resolve_device(args.device)
    if g is None:
        g = load_graph(args.graph, args.scale)
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
    # LM path
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt length (also the decode cache offset)")
    # graph path
    ap.add_argument("--graph", default=None,
                    help="serve a GNN/recsys session over this dataset "
                         "(cora | citeseer-s | reddit) instead of the LM")
    ap.add_argument("--model", default="gcn",
                    help="registered serve session: gcn | sage_gin | "
                         "wide_deep")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--zipf-a", type=float, default=1.1)
    ap.add_argument("--cache-kb", type=int, default=500)
    ap.add_argument("--line-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--warm", default="reorder",
                    choices=["reorder", "index", "none"])
    ap.add_argument("--scale", type=float, default=0.02,
                    help="dataset scale for the citeseer-s/reddit stand-ins")
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    """The graph path's ``ServeReport``, or the LM path's
    ``LMServeResult``."""
    args = parse_args(argv)
    if args.graph is not None:
        return serve_graph(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
