"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): "lower" and
"compile" EVERY (architecture x input shape) cell on the single-pod (16, 16)
mesh AND the multi-pod (2, 16, 16) mesh, print the memory and cost counts,
and dump the records ``launch.roofline_run`` consumes.

The reference forces 512 host devices and lowers one SPMD program.  The port
is one process per rank, so this process plays rank 0 of a *fake* process
group of the mesh's size (``torch.testing``'s ``fake`` backend: its
collectives return at once and move nothing), and each cell is:

* lower: the rank's block of every state leaf and input, as a ``meta``
  tensor of ``NamedSharding.shard_shape`` under the bundle's
  ``shardings`` (this raises ``ValueError`` where the reference's does: a
  dimension its axes do not divide);
* compile: one trace of the bundle's eager step on those blocks
  (``roofline.count.count_step``: fake tensors, nothing allocated), under
  ``dist.sharding.use_mesh``: every family's step runs its manual mesh
  path, with the collectives GSPMD would insert.  The steps are the
  reference's own, which reach no hand-written kernel: LM decode on
  ``attn="plain"``, the GNNs on segment ops, wide & deep on
  ``lookup="dense"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gcn-cora --shape molecule
  PYTHONPATH=src python -m repro_torch.launch.dryrun --single-pod-only --json out.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback

import torch

from ..configs import get
from ..configs.registry import ALL_ARCHS
from ..configs.base import LM_SHAPES
from ..dist.sharding import NamedSharding, as_mesh, use_mesh
from ..roofline import hw
from ..roofline.count import count_step
from .mesh import make_production_mesh


def _is_spec(x) -> bool:
    """An ``input_specs`` leaf: ``(shape, dtype)``."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def _local(tree, shardings):
    """The rank's block of each leaf of ``tree`` (``meta`` tensors or
    ``(shape, dtype)`` specs) under the matching ``NamedSharding`` of
    ``shardings``, as ``meta`` tensors; also their total bytes."""
    total = 0

    def walk(t, sh):
        nonlocal total
        if isinstance(t, dict):
            return {k: walk(v, sh[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not _is_spec(t):
            return type(t)(walk(v, s) for v, s in zip(t, sh))
        shape, dtype = (t if _is_spec(t) else (t.shape, t.dtype))
        if not isinstance(sh, NamedSharding):
            raise TypeError(f"no sharding for a leaf of shape {shape}")
        block = sh.shard_shape(shape)
        total += math.prod(block) * dtype.itemsize
        return torch.empty(block, dtype=dtype, device="meta")
    return walk(tree, shardings), total


def _step(bundle, spec, shape: str):
    """The cell's step on the reference's own route (no kernel)."""
    if spec.family == "lm":
        if LM_SHAPES[shape]["kind"] == "decode":
            return bundle.step_fn(shape, attn="plain")
        return bundle.step_fn(shape)
    if spec.family == "recsys":
        return bundle.step_fn(shape, lookup="dense")
    return bundle.step_fn(shape)


def lower_cell(bundle, spec, shape: str, mesh, compile_: bool = True):
    """Lower (and optionally compile) one cell on ``mesh`` (a
    ``DeviceMesh`` over the process group of its size; the dry-run's is a
    fake one).  Returns ``(result, trace, counts)``: ``result`` with the
    reference's keys, ``trace`` the rank-local arguments and the step,
    ``counts`` ``count_step``'s dict (None without ``compile_``)."""
    t0 = time.time()
    m = as_mesh(mesh)
    state = bundle.abstract_state(shape)
    inputs = bundle.input_specs(shape)
    arg_sh, _ = bundle.shardings(m, shape)
    if state[1] is not None:       # train: (params, opt, batch)
        args, arg_bytes = _local((state[0], state[1], inputs), arg_sh)
        donate = (0, 1)            # params/opt update in place
    else:                          # serve: (params, batch)
        args, arg_bytes = _local((state[0], inputs), arg_sh)
        # decode updates its KV caches (batch arg) in place
        donate = (1,) if "caches" in inputs else ()
    if "cache_len" in inputs:      # the decode step takes it as an int
        args[1]["cache_len"] = LM_SHAPES[shape]["seq"] - 1
    t_lower = time.time() - t0
    result = {"arch": spec.name, "shape": shape,
              "mesh": "x".join(map(str, m.shape.values())),
              "lower_s": round(t_lower, 1)}
    with use_mesh(m):
        fn = _step(bundle, spec, shape)
        trace = {"args": args, "fn": fn, "donate": donate}
        if not compile_:
            return result, trace, None
        counts = count_step(fn, args, donate=donate)
    result["compile_s"] = round(time.time() - t0 - t_lower, 1)
    mem = counts["memory"]
    out_new = max(mem["output_gb_per_device"] - mem["alias_gb_per_device"],
                  0.0)
    result["memory"] = {
        "argument_gb_per_device": arg_bytes / 1e9,
        "output_gb_per_device": mem["output_gb_per_device"],
        "temp_gb_per_device": mem["temp_gb_per_device"],
        "peak_gb_per_device": (arg_bytes / 1e9 + out_new
                               + mem["temp_gb_per_device"]),
    }
    result["cost"] = {"flops_per_device": counts["flops"],
                      "bytes_per_device": counts["bytes"]}
    return result, trace, counts


def _init_fake(n: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake process group of ``n`` ranks (the
    counterpart of the reference's forced host devices); only one default
    group may live in a process, so the group is destroyed on exit."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run makes a fake one of its own")
    _init_fake(n)
    try:
        yield
    finally:
        dist.destroy_process_group()


MESHES = (("1-pod(16x16)", False), ("2-pod(2x16x16)", True))
MAX_WORKERS = 8
_MESH = None      # this process's production mesh, while map_cells runs


def _join_world(multi_pod: bool) -> None:
    """A pool worker's set-up: rank 0 of its own fake group and the
    production mesh over it."""
    global _MESH
    _init_fake(512 if multi_pod else 256)
    _MESH = make_production_mesh(multi_pod=multi_pod, device="cpu")


def production_mesh():
    """The production mesh ``map_cells`` set up in this process."""
    return _MESH


def _try_cell(job):
    """One cell on this process's mesh: ``("ok", result)`` or ``("fail",
    failure)``, as ``run`` records them."""
    name, shape, mesh_name, compile_ = job
    spec = get(name)
    try:
        res, _, _ = lower_cell(spec.bundle(), spec, shape, _MESH,
                               compile_=compile_)
        res["mesh_name"] = mesh_name
        return "ok", res
    except Exception as e:
        return "fail", {"arch": name, "shape": shape, "mesh": mesh_name,
                        "error": str(e), "type": type(e).__name__,
                        "traceback": traceback.format_exc()}


def map_cells(fn, jobs, multi_pod: bool):
    """``fn(job)`` for each of ``jobs`` on one production mesh
    (``production_mesh()``), results in ``jobs``' order.  The traces are
    host-bound and independent, so they run in a pool of fresh processes,
    one a core up to ``MAX_WORKERS``, each rank 0 of its own fake group;
    a single job (or core) runs in this process."""
    global _MESH
    workers = min(MAX_WORKERS, os.cpu_count() or 1, len(jobs))
    if workers <= 1:
        with fake_world(512 if multi_pod else 256):
            _MESH = make_production_mesh(multi_pod=multi_pod, device="cpu")
            try:
                return [fn(j) for j in jobs]
            finally:
                _MESH = None
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(workers, initializer=_join_world,
                                      initargs=(multi_pod,)) as pool:
        return pool.map(fn, jobs, chunksize=1)


def run(arch_names, shapes_filter, multi_pod_too=True, compile_=True,
        out_json=None, log=print):
    results = []
    failures = []
    meshes = MESHES if multi_pod_too else MESHES[:1]
    for mesh_name, multi_pod in meshes:
        jobs = [(name, shape, mesh_name, compile_)
                for name in arch_names for shape in get(name).shapes
                if shapes_filter is None or shape in shapes_filter]
        for (name, shape, _, _), (status, rec) in zip(
                jobs, map_cells(_try_cell, jobs, multi_pod)):
            tag = f"{name:28s} {shape:14s} {mesh_name}"
            if status == "fail":
                log(f"FAIL {tag}  {rec.pop('type')}: {rec['error']}")
                failures.append(rec)
                continue
            mem = rec.get("memory", {})
            peak = mem.get("peak_gb_per_device", 0)
            flops = rec.get("cost", {}).get("flops_per_device", 0)
            log(f"OK   {tag}  lower={rec['lower_s']}s "
                f"compile={rec.get('compile_s', '-')}s  "
                f"peak={peak:.2f}GB/dev flops/dev={flops:.3g}")
            if peak > hw.HBM_BYTES / 1e9:
                log(f"WARN {tag}  exceeds the H100's "
                    f"{hw.HBM_BYTES / 1e9:.0f}GB HBM!")
                rec["hbm_overflow"] = True
            results.append(rec)
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
        log(f"wrote {out_json}")
    log(f"\n{len(results)} cells OK, {len(failures)} failed")
    return results, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    archs = args.arch or list(ALL_ARCHS)
    _, failures = run(archs, args.shape,
                      multi_pod_too=not args.single_pod_only,
                      compile_=not args.no_compile, out_json=args.json)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
