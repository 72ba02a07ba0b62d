"""Rank bodies for ``tests/test_torch_dist_mesh.py``: gloo ranks started
with ``torch.multiprocessing`` (spawn), each joining a ``FileStore`` under
the test's temporary directory, reading the test's inputs from
``inputs.npz`` there and writing its results to ``rank<r>.npz`` /
``rank<r>.json``.

Imports torch and the port only (no jax, no reference): a spawned rank
imports this module afresh.
"""
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 120


def spawn(fn, world: int, tmp: str, timeout_s: float = 240.0) -> None:
    """Run ``fn(rank, world, tmp)`` on ``world`` spawned ranks; raise if a
    rank fails or the ranks outlive ``timeout_s`` (then they are
    terminated)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, tmp), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
                p.join(10)
            raise TimeoutError(f"{world} ranks did not finish in "
                               f"{timeout_s:.0f}s")


def _init(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def _graph(inp):
    from repro_torch.graph import Graph
    return Graph(src=inp["src"], dst=inp["dst"],
                 num_nodes=int(inp["num_nodes"]))


def _dist_counters() -> dict:
    from repro_torch import obs
    return {k: v for k, v in obs.snapshot()["counters"].items()
            if k.startswith("dist.")}


def _save(tmp: str, rank: int, arrays: dict, info: dict) -> None:
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def aggregate_suite(rank: int, world: int, tmp: str) -> None:
    """halo / allgather / resilient aggregates and their gradients on this
    rank's window, then the resilient drills: a transient fault, a fault
    that outlives the ladder, a zero delay budget, and a local exception on
    rank 1 only."""
    _init(rank, world, tmp)
    try:
        from repro_torch import obs
        from repro_torch.chaos import Fault, FaultPlan, armed
        from repro_torch.dist import (ModeledClock, RetryPolicy,
                                      allgather_aggregate, build_send_plan,
                                      halo_aggregate,
                                      resilient_halo_aggregate)
        from repro_torch.dist import halo as halo_mod
        from repro_torch.graph import build_halo_plan
        from repro_torch.launch.mesh import make_halo_debug_mesh

        inp = np.load(os.path.join(tmp, "inputs.npz"))
        plan = build_halo_plan(_graph(inp), world)
        send = build_send_plan(plan)
        mesh = make_halo_debug_mesh(world, device="cpu")
        n = plan.parts.sizes()[0]
        win = slice(rank * n, (rank + 1) * n)
        x = torch.as_tensor(inp["x"][win])
        r = torch.as_tensor(inp["r"][win])
        fns = {"halo": lambda a: halo_aggregate(mesh, a, plan, send, n),
               "allgather": lambda a: allgather_aggregate(mesh, a, plan, n),
               "resilient": lambda a: resilient_halo_aggregate(
                   mesh, a, plan, send, n)}
        out, info = {}, {}
        for name, fn in fns.items():
            xx = x.clone().requires_grad_(True)
            y = fn(xx)
            (gx,) = torch.autograd.grad((y * r).sum(), xx)
            out[name], out[name + "_grad"] = y.detach().numpy(), gx.numpy()

        obs.enable()
        pol = RetryPolicy()
        drills = {
            "transient": (FaultPlan.of(Fault("dist.halo", "shard_loss")),
                          {}),
            "persistent": (FaultPlan.of(Fault(
                "dist.halo", "shard_loss", count=pol.max_retries + 1)),
                {"policy": pol}),
            "budget": (FaultPlan.of(Fault("dist.halo", "straggler")),
                       {"timeout_s": 1e-12})}
        for name, (fplan, kw) in drills.items():
            obs.reset()
            clock = ModeledClock()
            with armed(fplan) as inj:
                y = resilient_halo_aggregate(mesh, x, plan, send, n,
                                             clock=clock, **kw)
            out["drill_" + name] = y.numpy()
            info[name] = {"fired": len(inj.fired), "clock": clock.now(),
                          "counters": _dist_counters()}
        obs.reset()
        original = halo_mod.send_rows
        if rank == 1:
            def broken(*a, **kw):
                raise RuntimeError("a local failure on rank 1")
            halo_mod.send_rows = broken
        try:
            y = resilient_halo_aggregate(mesh, x, plan, send, n)
        finally:
            halo_mod.send_rows = original
        out["drill_exchange_error"] = y.numpy()
        info["exchange_error"] = {"counters": _dist_counters()}
        _save(tmp, rank, out, info)
    finally:
        dist.destroy_process_group()


def train_suite(rank: int, world: int, tmp: str) -> None:
    """On 4 ranks: the train step's first loss and gradients, 10 steps of
    each aggregator on the reference's weights; ``elastic_mesh``; then
    ``distributed_decode_attention`` on a (2, 2) mesh and
    ``int8_allreduce_psum``."""
    _init(rank, world, tmp)
    try:
        from repro_torch.dist import (build_send_plan,
                                      distributed_decode_attention,
                                      int8_allreduce_psum,
                                      make_dist_train_step)
        from repro_torch.dist.gnn import dist_value_and_grad
        from repro_torch.graph import build_halo_plan
        from repro_torch.launch.mesh import make_debug_mesh, make_halo_debug_mesh
        from repro_torch.train import adam, elastic_mesh, tree_leaves

        inp = np.load(os.path.join(tmp, "inputs.npz"))
        plan = build_halo_plan(_graph(inp), world)
        send = build_send_plan(plan)
        mesh = make_halo_debug_mesh(world, device="cpu")
        n = plan.parts.sizes()[0]
        win = slice(rank * n, (rank + 1) * n)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
        batch = {"x": t(inp["feat"][win]),
                 "labels": t(inp["labels"][win].astype(np.int64)),
                 "train_mask": t(inp["train_mask"][win]),
                 "deg": t(inp["deg"][win])}
        n_layers = int(inp["n_layers"])
        params = [{k: t(inp[f"{k}_{i}"]) for k in ("w_self", "w_neigh", "b")}
                  for i in range(n_layers)]
        out, info = {}, {}
        loss0, grads = dist_value_and_grad(mesh, params, batch, plan, send, n)
        out["loss0"] = loss0.numpy()
        for i, gl in enumerate(tree_leaves(grads)):
            out[f"grad_{i}"] = gl.numpy()
        for agg in ("halo", "allgather", "resilient"):
            opt = adam(1e-2)
            step = make_dist_train_step(mesh, plan, send, n, opt, agg)
            p, s, losses = params, opt.init(params), []
            for _ in range(10):
                p, s, loss = step(p, s, batch)
                losses.append(float(loss))
            out[f"losses_{agg}"] = np.asarray(losses)
            out[f"final_{agg}"] = torch.cat(
                [a.reshape(-1) for a in tree_leaves(p)]).numpy()

        info["elastic_mesh"] = {}
        for shape in ((8, 1), (16, 2), (1, 4)):
            m = elastic_mesh(shape, ("data", "model"), device="cpu")
            info["elastic_mesh"][str(shape)] = list(m.shape)
        try:
            elastic_mesh((1, 8), ("data", "model"), device="cpu")
        except RuntimeError as err:
            info["elastic_mesh"]["(1, 8)"] = str(err)

        dmesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")
        i, j = (dmesh.get_local_rank("data"), dmesh.get_local_rank("model"))
        q, k, v, lens = inp["q"], inp["k"], inp["v"], inp["cache_lens"]
        bl, sl = q.shape[0] // 2, k.shape[1] // 2
        rows, cols = slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl)
        o = distributed_decode_attention(dmesh, t(q[rows]), t(k[rows, cols]),
                                         t(v[rows, cols]), t(lens[rows]))
        out["decode"] = o.numpy()
        info["decode_rows"] = [i * bl, (i + 1) * bl]
        out["int8_psum"] = int8_allreduce_psum(
            t(inp["gvec"] * (rank + 1)),
            group=mesh.get_group("data")).numpy()
        _save(tmp, rank, out, info)
    finally:
        dist.destroy_process_group()
