"""Family bundles — port of ``GNNBundle`` (GCN only; GAT, PNA and NequIP
are not ported yet) and ``RecsysBundle`` from
``repro/configs/families.py``.  The LM bundle is not ported yet, nor are
the bundles' ``abstract_state`` and ``shardings`` (mesh work, ROADMAP §1
item 9)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from ..models.gcn import gcn_init, gcn_loss
from ..models.recsys import (WideDeepConfig, retrieval_score, widedeep_init,
                             widedeep_logits, widedeep_loss)
from ..train.loop import make_train_step
from ..train.optimizer import Optimizer, adam
from .base import RECSYS_SHAPES


@dataclasses.dataclass
class GNNBundle:
    arch: str
    model_kw: Dict[str, Any]
    n_classes: int = 16

    def _require_ported(self) -> None:
        if self.arch != "gcn":
            raise NotImplementedError(f"GNN arch {self.arch!r} is not "
                                      "ported yet (ROADMAP §1 item 8)")

    def init_params(self, generator: torch.Generator, d_feat: int,
                    device="cuda"):
        self._require_ported()
        return gcn_init(generator, [d_feat, *self.model_kw["hidden"],
                                    self.n_classes], device=device)

    def loss_fn(self, shape: str, executor: str = "segment",
                exec_plan=None):
        """``executor="blockell"`` + a ``GraphExecutionPlan`` routes the
        aggregation through the block-ELL plan; ``executor="fused"`` + one
        ``LayerExecutionPlan`` per layer folds the update in too.  The plans
        are closed over; their hand-written backwards keep the loss
        differentiable.  Returns ``loss(params, batch)``."""
        self._require_ported()
        if executor == "blockell" and exec_plan is None:
            raise ValueError("executor='blockell' needs an exec_plan "
                             "(repro_torch.exec.build_plan)")
        if executor == "fused" and not exec_plan:
            raise ValueError("executor='fused' needs per-layer plans "
                             "(repro_torch.exec.build_layer_plan)")

        def loss(params, batch):
            graph = {"src": batch["src"], "dst": batch["dst"],
                     "edge_mask": batch["edge_mask"], "deg": batch["deg"]}
            return gcn_loss(params, batch["x"], graph, batch["labels"],
                            batch["train_mask"], executor=executor,
                            plans=exec_plan)
        return loss


@dataclasses.dataclass
class RecsysBundle:
    """Wide & deep at one config over the four ``RECSYS_SHAPES``."""
    cfg: WideDeepConfig
    shapes = tuple(RECSYS_SHAPES)

    def init_params(self, generator: torch.Generator, device="cuda"):
        return widedeep_init(generator, self.cfg, device=device)

    def optimizer(self) -> Optimizer:
        """The train step's optimizer; ``optimizer().init(params)`` is the
        state the step takes."""
        return adam(1e-3)

    def input_specs(self, shape: str
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """name -> (shape, dtype) of each step input."""
        info = RECSYS_SHAPES[shape]
        B = info["batch"]
        specs = {"sparse": ((B, self.cfg.n_sparse), torch.int32),
                 "dense": ((B, self.cfg.n_dense), torch.float32)}
        if info["kind"] == "train":
            specs["labels"] = ((B,), torch.float32)
        if shape == "retrieval_cand":
            specs["candidates"] = ((info["n_candidates"],
                                    self.cfg.mlp_dims[-1]), torch.float32)
        return specs

    def make_batch(self, shape: str, generator: torch.Generator,
                   device="cuda") -> Dict[str, torch.Tensor]:
        """A concrete batch of :meth:`input_specs`, drawn where
        ``generator`` lives: ids uniform over each field's rows, labels 0/1,
        dense features and candidates N(0, 1)."""
        dev = resolve_device(device)
        kw = dict(generator=generator, device=generator.device)
        out = {}
        for name, (shp, dtype) in self.input_specs(shape).items():
            if name == "sparse":
                t = torch.randint(0, self.cfg.rows_per_field, shp,
                                  dtype=dtype, **kw)
            elif name == "labels":
                t = torch.randint(0, 2, shp, **kw).to(dtype)
            else:
                t = torch.randn(shp, dtype=dtype, **kw)
            out[name] = t.to(dev)
        return out

    def step_fn(self, shape: str, lookup: str = "bag"):
        """``train_batch``: ``(params, opt_state, batch) -> (params,
        opt_state, loss)``, one Adam(1e-3) step with no clipping, as the
        reference's; ``retrieval_cand``: ``(params, batch) -> (N,)`` scores;
        the serve shapes: ``(params, batch) -> (B,)`` logits."""
        cfg = self.cfg
        if RECSYS_SHAPES[shape]["kind"] == "train":
            return make_train_step(
                lambda p, b: widedeep_loss(p, b["sparse"], b["dense"],
                                           b["labels"], cfg, lookup),
                self.optimizer(), clip_norm=None)
        if shape == "retrieval_cand":
            @torch.no_grad()
            def retrieve(params, batch):
                return retrieval_score(params, batch["sparse"],
                                       batch["dense"], batch["candidates"],
                                       cfg, lookup)
            return retrieve

        @torch.no_grad()
        def serve(params, batch):
            return widedeep_logits(params, batch["sparse"], batch["dense"],
                                   cfg, lookup)
        return serve
