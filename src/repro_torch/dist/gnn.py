"""Sharded GCN/SAGE training: aggregation routed through the halo exchange
(port of ``repro/dist/gnn.py``).

Node features, edges and the aggregation live in contiguous windows, one
per rank (the paper's graph-level mapping with mesh ranks as PEs); every
layer's neighborhood sum runs through ``halo_aggregate`` and the backward
differentiates through the exchange.  Parameters stay replicated: each
rank computes its term of the global masked-mean loss (its numerator over
the all-reduced count of training nodes), the parameter gradients are
all-reduced (SUM) and clipped to global norm 1.0 after the reduce, so
every rank applies the same Adam update.  (Differentiating through an
all-reduce of the loss instead would scale every gradient by the rank
count: torch's all-reduce backward all-reduces again.)

``train_distributed`` is multi-controller: when a process group is
initialised it trains as this rank; otherwise it starts ``parts`` ranks
(``torch.multiprocessing``, spawn: the caller may hold CUDA) over a
``FileStore`` in a temporary directory, NCCL with one rank per card on
``cuda`` and gloo on the CPU, and returns rank 0's result.

Usage (four gloo ranks on the CPU; one NCCL rank per card without
``--device``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --dist --parts 4 --device cpu
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..chaos import inject as chaos
from ..device import resolve_device
from ..graph.partition import HaloPlan, build_halo_plan
from ..graph.structure import Graph
from ..train.optimizer import (adam, apply_updates, clip_by_global_norm,
                               tree_leaves, tree_unflatten)
from .halo import allgather_aggregate, axis_group, halo_aggregate
from .plan import SendPlan, build_send_plan, collective_bytes_estimate

DIST_ARCHS = ("gcn-cora", "graphsage", "sage")
# how long a rank waits for its group (init, each collective) and the
# caller for its ranks
RANK_TIMEOUT_S = 600.0


# ---------------------------------------------------------------- graph prep
def pad_graph_nodes(g: Graph, multiple: int) -> Graph:
    """Append isolated padding nodes so num_nodes divides ``multiple``.

    Padding nodes have zero features, label 0, and train_mask False, so they
    never contribute to the loss; they receive no edges, so aggregation over
    them is zero.  Required because the window partition hands every rank
    an identical node count.
    """
    n = g.num_nodes
    target = int(math.ceil(n / multiple) * multiple)
    if target == n:
        return g
    pad = target - n

    def pad_rows(a, fill=0):
        if a is None:
            return None
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)])

    return dataclasses.replace(
        g, num_nodes=target,
        node_feat=pad_rows(g.node_feat, 0),
        labels=pad_rows(g.labels, 0),
        train_mask=pad_rows(g.train_mask, False))


# ------------------------------------------------------------------- model
def dist_gnn_init(generator: torch.Generator, dims: List[int],
                  device="cuda") -> List[Dict[str, torch.Tensor]]:
    """SAGE-style layers: h' = h W_self + AGG(h) W_neigh + b, weights
    N(0, 1/d_in) drawn on the CPU from ``generator`` (so every rank and
    every device draws the same), then moved to ``device``."""
    dev = resolve_device(device)
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        s = 1.0 / math.sqrt(din)
        w_self = torch.randn((din, dout), generator=generator) * s
        w_neigh = torch.randn((din, dout), generator=generator) * s
        params.append({"w_self": w_self.to(dev), "w_neigh": w_neigh.to(dev),
                       "b": torch.zeros((dout,), device=dev)})
    return params


def dist_gnn_apply(mesh, params, x: torch.Tensor, plan: HaloPlan,
                   send: SendPlan, local_n: int,
                   deg: Optional[torch.Tensor] = None,
                   aggregator: str = "halo") -> torch.Tensor:
    """Forward pass with sharded aggregation, on this rank's window of x
    (``deg`` likewise its window).

    ``deg`` switches the neighborhood sum to a mean (GraphSAGE-mean); None
    keeps the raw (edge-weighted) sum.  ``aggregator`` selects the
    collective: "halo", the "allgather" baseline, or "resilient" (halo with
    per-step fallback to allgather on shard loss/straggler,
    :mod:`repro_torch.dist.resilient`).
    """
    if aggregator == "resilient":
        from .resilient import resilient_halo_aggregate as agg_fn
    else:
        agg_fn = (halo_aggregate if aggregator == "halo"
                  else allgather_aggregate)
    h = x
    for i, lp in enumerate(params):
        a = (agg_fn(mesh, h, plan, send, local_n)
             if aggregator in ("halo", "resilient")
             else agg_fn(mesh, h, plan, local_n))
        if deg is not None:
            a = a / torch.clamp(deg, min=1.0)[:, None]
        h = h @ lp["w_self"] + a @ lp["w_neigh"] + lp["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def dist_gnn_loss(mesh, params, batch, plan, send, local_n,
                  aggregator: str = "halo") -> torch.Tensor:
    """This rank's term of the masked softmax cross-entropy over training
    nodes: its numerator over the group's count of training nodes
    (all-reduced, outside autograd).  The terms of all ranks sum to the
    reference's loss."""
    group, _ = axis_group(mesh, None, plan.parts.num_parts)
    logits = dist_gnn_apply(mesh, params, batch["x"], plan, send, local_n,
                            deg=batch.get("deg"), aggregator=aggregator)
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(1, batch["labels"][:, None])[:, 0]
    mask = batch["train_mask"].to(torch.float32)
    count = mask.sum().detach().clone()
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    return -(picked * mask).sum() / torch.clamp(count, min=1.0)


def dist_value_and_grad(mesh, params, batch, plan, send, local_n,
                        aggregator: str = "halo"):
    """(global loss, global gradient tree), the same on every rank: one
    backward of this rank's loss term, then one all-reduce (SUM) of every
    gradient with the term."""
    group, _ = axis_group(mesh, None, plan.parts.num_parts)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    term = dist_gnn_loss(mesh, tree_unflatten(params, live), batch, plan,
                         send, local_n, aggregator)
    grads = torch.autograd.grad(term, live, allow_unused=True)
    with torch.no_grad():
        flat = torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1) for p, g in zip(live, grads)]
                         + [term.detach().reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        sizes = [p.numel() for p in live]
        parts = torch.split(flat[:-1], sizes)
        grads = tree_unflatten(params, [g.reshape(p.shape)
                                        for g, p in zip(parts, live)])
    return flat[-1], grads


def make_dist_train_step(mesh, plan, send, local_n, opt,
                         aggregator: str = "halo"):
    """(params, opt_state, batch) -> (params, opt_state, loss): the global
    loss and gradient (:func:`dist_value_and_grad`), clip to global norm
    1.0, then ``opt``'s update, identical on every rank."""

    def step(params, opt_state, batch):
        loss, grads = dist_value_and_grad(mesh, params, batch, plan, send,
                                          local_n, aggregator)
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, 1.0)
            updates, opt_state2 = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state2, loss

    return step


# ---------------------------------------------------------------- training
def training_setup(parts: int):
    """The reordered Cora padded to a multiple of ``parts``, its halo and
    send plans and their collective-bytes estimate (the reference's
    ``train_distributed`` set-up, host numpy only)."""
    from ..core.reorder import minhash_reorder
    from ..graph.datasets import cora_like
    g = cora_like()
    g = g.permute(minhash_reorder(g))
    g = pad_graph_nodes(g, parts)
    plan = build_halo_plan(g, parts)
    send = build_send_plan(plan)
    est = collective_bytes_estimate(plan, send, d=g.node_feat.shape[1])
    return g, plan, send, est


def _train_rank(cfg: Dict, log) -> Dict:
    """One rank of ``train_distributed`` in an initialised process group."""
    from ..launch.mesh import make_halo_debug_mesh
    parts = dist.get_world_size()
    rank = dist.get_rank()
    dev = resolve_device(cfg["device"])
    mesh = make_halo_debug_mesh(parts, device=dev.type)
    arch, steps = cfg["arch"], cfg["steps"]
    aggregator = cfg["aggregator"]
    g, plan, send, est = training_setup(parts)
    if rank == 0:
        log(f"dist[{arch}] parts={parts} "
            f"cut={est['cut_edge_fraction']:.3f} "
            f"halo={est['halo_bytes_per_chip_real'] / 1e3:.1f}kB/chip "
            f"vs allgather={est['allgather_bytes_per_chip'] / 1e3:.1f}"
            "kB/chip")
        log(f"dist backend={dist.get_backend()} ranks={parts} "
            f"device={dev.type}")
    local_n = g.num_nodes // parts
    lo, hi = rank * local_n, (rank + 1) * local_n
    n_classes = int(g.labels.max()) + 1
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    batch = {"x": t(g.node_feat[lo:hi]),
             "labels": t(g.labels[lo:hi].astype(np.int64)),
             "train_mask": t(g.train_mask[lo:hi]),
             "deg": t(g.in_degrees().astype(np.float32)[lo:hi])}
    params = dist_gnn_init(torch.Generator().manual_seed(0),
                           [g.node_feat.shape[1], cfg["hidden"], n_classes],
                           device=dev)
    opt = adam(cfg["lr"])
    opt_state = opt.init(params)
    obs.gauge("dist.parts").set(parts)
    step = make_dist_train_step(mesh, plan, send, local_n, opt, aggregator)
    losses: List[float] = []
    step_hist = obs.histogram("dist.step_seconds")
    for i in range(steps):
        with obs.span("dist.step", cat="dist", aggregator=aggregator):
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
        step_hist.observe(time.perf_counter() - t0)
        if (rank == 0 and cfg["ckpt_dir"] and cfg["ckpt_every"]
                and (i + 1) % cfg["ckpt_every"] == 0):
            from ..train.checkpoint import save_mirrored_checkpoint
            save_mirrored_checkpoint(cfg["ckpt_dir"], i + 1, params,
                                     opt_state, num_shards=parts)
    obs.counter("dist.steps").inc(steps)
    if rank == 0:
        log(f"dist[{arch}]: {steps} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")
    return {"losses": losses, "collective_estimate": est, "params": params,
            "metrics": obs.snapshot() if obs.enabled() else None}


def _spawned_rank(rank: int, world: int, store_path: str, result_path: str,
                  cfg: Dict) -> None:
    """The body of a rank started by ``train_distributed``: join the group,
    train with the caller's fault plan armed and its telemetry switches,
    and (rank 0) write the result for the caller."""
    dev_type = torch.device(cfg["device"]).type
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        cfg = dict(cfg, device=f"cuda:{rank}")
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "nccl" if dev_type == "cuda" else "gloo",
        store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        if cfg["obs"]:
            obs.enable()
        lines: List[str] = []
        ours = rank == 0
        with contextlib.ExitStack() as stack:
            if cfg["fault_plan"] is not None:
                stack.enter_context(chaos.armed(cfg["fault_plan"]))
            stack.enter_context(obs.observed_run(
                cfg["metrics_out"] if ours else None,
                cfg["trace"] if ours else None, log=lines.append,
                device=cfg["device"]))
            res = _train_rank(cfg, lines.append)
        if ours:
            res["params"] = [{k: v.cpu() for k, v in lp.items()}
                             for lp in res["params"]]
            res["log"] = lines
            torch.save(res, result_path)
    finally:
        dist.destroy_process_group()


def train_distributed(arch: str = "gcn-cora", steps: int = 20,
                      parts: Optional[int] = None, lr: float = 1e-2,
                      hidden: int = 64, aggregator: str = "halo",
                      ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                      log=print, device="cuda",
                      metrics_out: Optional[str] = None,
                      trace: Optional[str] = None) -> Dict:
    """End-to-end sharded GNN training over ``parts`` ranks.

    Builds the LSH-reordered halo plan over ``parts`` contiguous windows,
    then trains with every aggregation running through the mesh exchange;
    the weights are ``dist_gnn_init`` from a generator seeded 0.  Returns
    rank 0's ``{"losses", "collective_estimate", "params", "metrics"}``
    (``metrics``: its registry snapshot when telemetry is on, else None),
    and prints through ``log`` the reference's ``dist[...]`` lines plus the
    backend's.

    With a process group initialised, it trains as this rank (``parts``
    must be the world size).  Otherwise it starts ``parts`` ranks (default:
    every card on ``cuda``, one on the CPU) and waits at most
    ``RANK_TIMEOUT_S`` for them; on ``cuda`` more parts than cards raise before any rank
    starts.  The caller's armed ``FaultPlan`` is armed in every rank, and
    its telemetry switch carried over; rank 0 writes the buddy-mirrored
    checkpoints (``ckpt_dir`` every ``ckpt_every`` steps) and
    ``metrics_out`` / ``trace``.  A rank's failure fails the call.

    Only the GCN/SAGE-style archs map onto the dist layer (the layer is
    ``h W_self + AGG(h) W_neigh``), as in the reference.
    """
    if arch not in DIST_ARCHS:
        raise ValueError(
            f"--dist currently trains the sharded GCN/SAGE layer only; "
            f"'{arch}' has no distributed message function yet")
    inj = chaos.active()
    cfg = {"arch": arch, "steps": steps, "lr": lr, "hidden": hidden,
           "aggregator": aggregator, "ckpt_dir": ckpt_dir,
           "ckpt_every": ckpt_every, "device": str(device),
           "metrics_out": metrics_out, "trace": trace, "obs": obs.enabled(),
           "fault_plan": inj.plan if inj is not None else None}
    if dist.is_initialized():
        if parts not in (None, dist.get_world_size()):
            raise ValueError(f"parts={parts} but the process group has "
                             f"{dist.get_world_size()} ranks")
        ours = dist.get_rank() == 0
        with obs.observed_run(metrics_out if ours else None,
                              trace if ours else None, device=device):
            return _train_rank(cfg, log if ours else (lambda _: None))
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..launch.mesh import require_devices
        parts = parts or torch.cuda.device_count()
        require_devices(parts, "cuda")
    parts = parts or 1
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_dist-")
    result_path = os.path.join(tmp, "rank0.pt")
    try:
        ctx = mp.start_processes(
            _spawned_rank, nprocs=parts, join=False, start_method="spawn",
            args=(parts, os.path.join(tmp, "store"), result_path, cfg))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                    p.join(10)
                raise TimeoutError(f"train_distributed: {parts} ranks did "
                                   f"not finish in {RANK_TIMEOUT_S:.0f}s")
        res = torch.load(result_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for line in res.pop("log"):
        log(line)
    res["params"] = [{k: v.to(dev) for k, v in lp.items()}
                     for lp in res["params"]]
    return res
