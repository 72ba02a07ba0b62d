"""Full-graph GAT training on ``repro_torch``: one step is one epoch over
every node of the graph, through the port's fused attention path.

Set-up, in the steps and readings of :mod:`h100bench.drivers.gnn_full`:
the graph (the benchmark's generator, one graph for every seed, features
drawn on the device from the seed), ``minhash_reorder`` and
``Graph.permute``, the attention plan (``exec.gat.build_attention_plan``:
each node's in-neighbours and itself as per-row lists, both directions),
the weights drawn on the device from the seed, and
``make_train_step(loss_fn, adam(...), clip_norm)``, donated, whose loss is
``gat_loss(..., executor="fused", plan=...)``.  That one step object takes
the checked steps, the warm-up steps and every step of the window.

A program without the fused GAT path (``repro_torch.exec.gat``) cannot
run the cell: set-up stops at once, before the graph is drawn.

The comparison is :mod:`h100bench.drivers.gnn_full`'s: the checked
steps' losses, the first gradient as Adam got it and the parameters'
change, against :mod:`h100bench.reference.gat_full` from the same weights
and inputs.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import minhash_reorder
from repro_torch.graph.structure import Graph
from repro_torch.train import adam, make_train_step
from repro_torch.train.optimizer import tree_leaves

from ..harness import graphgen
from ..harness.check import training_readings
from ..metrics import _gat_work
from ..reference import gat_full as reference
from .gnn_full import WEIGHT_STREAM, _allocated, _sync

MISSING = ("the gat_full driver needs the program's fused GAT path "
           "(repro_torch.exec.gat.build_attention_plan and gat_loss's "
           "executor='fused'), which this program does not have")


def make_params(cfg: dict, seed: int, device: torch.device) -> Dict:
    """The weights on the device from the seed, in ``models.gat.gat_init``'s
    tree: each layer's W standard normal over the square root of its
    fan-in (no bias), then ``a_src`` and ``a_dst`` N(0, 0.1²)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(graphgen.stream_seed(seed, WEIGHT_STREAM))
    layers = []
    for d_in, h, f in _gat_work.layers(cfg):
        w = torch.randn((d_in, h * f), generator=gen, device=device)
        w.mul_(1.0 / math.sqrt(d_in))
        a_src = torch.randn((h, f), generator=gen, device=device).mul_(0.1)
        a_dst = torch.randn((h, f), generator=gen, device=device).mul_(0.1)
        layers.append({"w": {"w": w}, "a_src": a_src, "a_dst": a_dst})
    return {"layers": layers}


def _fused_path():
    """The program's fused GAT path, or a clear stop where it has none."""
    try:
        from repro_torch.exec.gat import build_attention_plan
        from repro_torch.models.gat import gat_loss
    except ImportError as exc:
        raise SystemExit(f"{MISSING}: {exc}") from exc
    return build_attention_plan, gat_loss


class Session:
    """One run of a full-graph GAT training cell."""

    def __init__(self, spec: dict, seed: int, device: torch.device,
                 log: Callable[[str], None] = print):
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        if self.traffic["kind"] != "full_graph":
            raise ValueError(f"gat_full runs full_graph traffic, not "
                             f"{self.traffic['kind']!r}")
        self.seed, self.device, self.log = seed, device, log
        self.readings: Dict[str, float] = {}
        self.prog: Optional[Dict] = None
        self.steps_taken = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        build_attention_plan, gat_loss = _fused_path()
        cfg, dev = self.cfg, self.device
        gspec = cfg["graph"]
        t0 = time.perf_counter()
        self.topo = graphgen.synthesize(gspec)
        labels = torch.as_tensor(self.topo["labels"], device=dev)
        x = graphgen.make_features(gspec, labels, self.seed, dev)
        _sync(dev)
        self.readings["graph_s"] = time.perf_counter() - t0
        g = Graph(src=self.topo["src"], dst=self.topo["dst"],
                  num_nodes=self.topo["num_nodes"],
                  labels=self.topo["labels"],
                  train_mask=self.topo["train_mask"])

        t0 = time.perf_counter()
        perm = minhash_reorder(g)
        g = g.permute(perm)
        self.readings["reorder_s"] = time.perf_counter() - t0
        x = x[torch.as_tensor(perm, device=dev)]
        self.batch = {"x": x,
                      "labels": torch.as_tensor(g.labels, device=dev).long(),
                      "mask": torch.as_tensor(g.train_mask, device=dev)}
        del labels

        _sync(dev)
        m0, t0 = _allocated(dev), time.perf_counter()
        self.plan = build_attention_plan(g, self_loops=cfg["self_loops"],
                                         device=dev)
        _sync(dev)
        self.readings["plan_build_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            self.readings["plan_mem_gb"] = (_allocated(dev) - m0) / 1e9
        self.log(f"graph {self.readings['graph_s']:.2f} s, reorder "
                 f"{self.readings['reorder_s']:.2f} s, plan "
                 f"{self.readings['plan_build_s']:.2f} s, "
                 f"{self.plan.describe()}, edges {g.num_edges}")

        self.params = make_params(cfg, self.seed, dev)
        self.start = [t.clone() for t in tree_leaves(self.params)]
        tr = cfg["train"]
        opt = adam(tr["lr"], tr["b1"], tr["b2"], tr["eps"])
        self.opt_state = opt.init(self.params)
        self.step_fn = make_train_step(self._loss_fn(gat_loss), opt,
                                       clip_norm=tr["clip_norm"])

        losses = [self.step() for _ in range(self.traffic["check_steps"])]
        self.prog = {"losses": losses, "grad": self._grad1,
                     "change": [p - s for p, s in
                                zip(tree_leaves(self.params), self.start)]}
        for _ in range(self.traffic["warmup_steps"]):
            self.step()

    def _loss_fn(self, gat_loss):
        plan, cfg = self.plan, self.cfg
        slope = cfg["negative_slope"]
        if slope != 0.2:
            raise ValueError(f"the program's GAT takes slope 0.2, the "
                             f"configuration {slope}")
        return lambda p, b: gat_loss(p, b["x"], None, b["labels"], b["mask"],
                                     executor="fused", plan=plan,
                                     skip=cfg["skip"],
                                     self_loops=cfg["self_loops"])

    # -------------------------------------------------------------- step
    def step(self) -> float:
        """One training step; returns its loss, read on the host."""
        self.params, self.opt_state, loss = self.step_fn(
            self.params, self.opt_state, self.batch)
        self.steps_taken += 1
        if self.steps_taken == 1:
            b1 = self.cfg["train"]["b1"]
            self._grad1 = [m / (1 - b1)
                           for m in tree_leaves(self.opt_state["m"])]
        return float(loss)

    def shape(self) -> dict:
        """What the work counts of the metrics need: the widths, the heads
        and the graph's size (edges as generated, before self loops)."""
        return {"family": "gat_full", "model": "gat",
                "dims": list(self.cfg["dims"]),
                "heads": list(self.cfg["heads"]),
                "self_loops": bool(self.cfg["self_loops"]),
                "num_nodes": int(self.topo["num_nodes"]),
                "num_edges": int(self.topo["src"].shape[0])}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("params", "opt_state", "batch", "plan", "step_fn",
                     "start"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- checks
    def reference(self, precision: str = "fp32",
                  mask_fn: Optional[Callable] = None) -> Dict:
        """The reference's checked steps from the same weights and inputs;
        ``mask_fn`` alters the training mask (to plant a fault)."""
        dev, gspec, cfg = self.device, self.cfg["graph"], self.cfg
        labels = torch.as_tensor(self.topo["labels"], device=dev)
        mask = torch.as_tensor(self.topo["train_mask"], device=dev)
        if mask_fn is not None:
            mask = mask_fn(mask)
        x = graphgen.make_features(gspec, labels, self.seed, dev)
        graph = reference.Graph(self.topo["src"], self.topo["dst"],
                                self.topo["num_nodes"], dev,
                                self_loops=cfg["self_loops"])
        params = [{"w": p["w"]["w"], "a_src": p["a_src"],
                   "a_dst": p["a_dst"]}
                  for p in make_params(cfg, self.seed, dev)["layers"]]
        try:
            return reference.train(params, graph, x, labels, mask,
                                   self.traffic["check_steps"], cfg["train"],
                                   precision, skip=cfg["skip"],
                                   slope=cfg["negative_slope"])
        finally:
            del x, graph
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        return training_readings(self.prog, self.reference())
