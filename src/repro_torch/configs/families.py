"""Family bundles — port of ``GNNBundle`` from
``repro/configs/families.py`` (GCN only; GAT, PNA and NequIP, and the LM
and recsys bundles, are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.gcn import gcn_init, gcn_loss


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
