"""The LM mesh path's training step on one device at several depths:
granite-8b's ``train_4k`` step (batch 1 of 4,096 tokens, weights and batch
from seed 27, the donated step) through ``dist.sharding.use_mesh`` on a
(1, 1) data x model mesh of a one-rank process group, and its peak memory
at each depth, or the out-of-memory error the card gives.

  PYTHONPATH=src python examples/lm_mesh_depth_torch.py [--layers 2 4 12]
  PYTHONPATH=src python examples/lm_mesh_depth_torch.py --device cpu --reduced

Runs on ``cuda`` (NCCL) unless ``--device cpu`` is given (gloo; no memory
readings).  ``--reduced`` takes granite-8b's ``REDUCED`` widths.  Point
``PYTHONPATH`` at another checkout's ``src`` to measure that commit's mesh
path on the same card.  Prints one JSON line a depth: ``layers``, the
state's GB before the step and the step's peak GB
(``memory_allocated`` / ``max_memory_allocated``), and the step's ``loss``
or ``oom``.
"""
import argparse
import dataclasses
import datetime
import gc
import json
import os
import tempfile

import torch
import torch.distributed as dist


def run_depth(cfg, n_layers: int, mesh, dev) -> dict:
    """One donated mesh train step of ``cfg`` cut to ``n_layers``."""
    from repro_torch.configs.families import LMBundle
    from repro_torch.dist.sharding import use_mesh
    bundle = LMBundle(dataclasses.replace(cfg, n_layers=n_layers))
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(27)
    params = bundle.init_params(gen, dev)
    state = bundle.opt().init(params)
    batch = bundle.make_batch("train_4k", gen, dev, batch=1)
    with use_mesh(mesh):
        step = bundle.step_fn("train_4k")
    out = {"layers": n_layers}
    if cuda:
        torch.cuda.synchronize(dev)
        out["state_gb"] = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with use_mesh(mesh):
            _, _, loss = step(params, state, batch)
        out["loss"] = float(loss)
    except torch.OutOfMemoryError as e:
        out["oom"] = str(e).splitlines()[0]
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state, batch, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 12])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="granite-8b's REDUCED widths")
    args = ap.parse_args(argv)
    from repro_torch.configs import granite_8b
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_debug_mesh

    dev = resolve_device(args.device)
    cfg = granite_8b.REDUCED if args.reduced else granite_8b.CONFIG
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_debug_mesh((1, 1), device=dev)
            for n in args.layers:
                print(json.dumps(run_depth(cfg, n, mesh, dev)), flush=True)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
