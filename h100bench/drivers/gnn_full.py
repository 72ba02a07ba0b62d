"""Full-graph GNN training on ``repro_torch``: one step is one epoch over
every node of the graph.

Set-up, as the port's launcher sets a run up: the graph (the benchmark's
generator: one graph for every seed, features drawn on the device from
the seed), ``minhash_reorder`` and
``Graph.permute``, ``plan_forward`` over the model's chain (its cold
schedule: the tuning cache is a fresh directory), the weights drawn on
the device from the seed, and ``make_train_step(loss_fn, adam(...),
clip_norm)``, donated, whose loss is ``gcn_loss`` or ``sage_loss`` on the
``"fused"`` executor.  That one step object then takes the checked steps,
the warm-up steps and every step of the window.

The comparison: the checked steps' losses, the first gradient as Adam got
it (its first moment after one step, over ``1 - b1``) and the parameters'
change over the checked steps, against :mod:`h100bench.reference.gnn_full`
from the same weights and inputs.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import minhash_reorder
from repro_torch.exec import gcn_chain, plan_forward, sage_chain
from repro_torch.graph.structure import Graph
from repro_torch.models import gcn_loss, sage_loss
from repro_torch.train import adam, make_train_step
from repro_torch.train.optimizer import tree_leaves

from ..harness import graphgen
from ..harness.check import training_readings
from ..reference import gnn_full as reference

WEIGHT_STREAM = 2


def make_params(cfg: dict, seed: int, device: torch.device) -> Dict:
    """The model's weights on the device from the seed: each layer's W
    standard normal over the square root of its fan-in, b zero (the
    port's ``linear_init``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(graphgen.stream_seed(seed, WEIGHT_STREAM))
    dims, layers = cfg["dims"], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        fan_in = 2 * d_in if cfg["model"] == "sage" else d_in
        w = torch.randn((fan_in, d_out), generator=gen, device=device)
        layers.append({"w": w.mul_(1.0 / math.sqrt(fan_in)),
                       "b": torch.zeros(d_out, device=device)})
    return {"layers": layers}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def half_batch(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` with every other selected row left out."""
    rows = torch.nonzero(mask).flatten()
    out = mask.clone()
    out[rows[1::2]] = False
    return out


class Session:
    """One run of a full-graph training cell."""

    def __init__(self, spec: dict, seed: int, device: torch.device,
                 log: Callable[[str], None] = print):
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        if self.traffic["kind"] != "full_graph":
            raise ValueError(f"gnn_full runs full_graph traffic, not "
                             f"{self.traffic['kind']!r}")
        self.seed, self.device, self.log = seed, device, log
        self.readings: Dict[str, float] = {}
        self.prog: Optional[Dict] = None
        self.steps_taken = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
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

        chain = {"gcn": gcn_chain, "sage": sage_chain}[cfg["model"]]
        _sync(dev)
        m0, t0 = _allocated(dev), time.perf_counter()
        self.plan = plan_forward(g, chain(cfg["dims"]), device=dev)
        _sync(dev)
        self.readings["plan_build_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            self.readings["plan_mem_gb"] = (_allocated(dev) - m0) / 1e9
        self.schedule = [list(c) for c in self.plan.configs]
        self.log(f"graph {self.readings['graph_s']:.2f} s, reorder "
                 f"{self.readings['reorder_s']:.2f} s, plan "
                 f"{self.readings['plan_build_s']:.2f} s, schedule "
                 f"{self.schedule}, active tiles "
                 f"{[lp.gplan.n_active for lp in self.plan]}, edges "
                 f"{g.num_edges}, largest out-degree "
                 f"{int(g.out_degrees().max())}")

        self.params = make_params(cfg, self.seed, dev)
        self.start = [t.clone() for t in tree_leaves(self.params)]
        tr = cfg["train"]
        opt = adam(tr["lr"], tr["b1"], tr["b2"], tr["eps"])
        self.opt_state = opt.init(self.params)
        self.step_fn = make_train_step(self._loss_fn(), opt,
                                       clip_norm=tr["clip_norm"])

        losses = [self.step() for _ in range(self.traffic["check_steps"])]
        # the checked steps: the first gradient from Adam's first moment
        # (kept after step 1), the change as the last checked step left it
        self.prog = {"losses": losses, "grad": self._grad1,
                     "change": [p - s for p, s in
                                zip(tree_leaves(self.params), self.start)]}
        for _ in range(self.traffic["warmup_steps"]):
            self.step()

    def _loss_fn(self):
        model, plan = self.cfg["model"], self.plan
        if model == "gcn":
            return lambda p, b: gcn_loss(p, b["x"], None, b["labels"],
                                         b["mask"], executor="fused",
                                         plans=plan)
        return lambda p, b: sage_loss(p, b["x"], None, b["labels"],
                                      b["mask"], executor="fused", plan=plan)

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
        """What the work counts of the metrics need: the model, its widths
        and the graph's size."""
        return {"family": "gnn_full", "model": self.cfg["model"],
                "dims": list(self.cfg["dims"]),
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
        dev, gspec = self.device, self.cfg["graph"]
        labels = torch.as_tensor(self.topo["labels"], device=dev)
        mask = torch.as_tensor(self.topo["train_mask"], device=dev)
        if mask_fn is not None:
            mask = mask_fn(mask)
        x = graphgen.make_features(gspec, labels, self.seed, dev)
        graph = reference.Graph(self.topo["src"], self.topo["dst"],
                                self.topo["num_nodes"], dev)
        params = make_params(self.cfg, self.seed, dev)["layers"]
        try:
            return reference.train(self.cfg["model"], params, graph, x,
                                   labels, mask,
                                   self.traffic["check_steps"],
                                   self.cfg["train"], precision)
        finally:
            del x, graph
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        return training_readings(self.prog, self.reference())
