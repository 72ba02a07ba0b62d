"""Family bundles — port of ``LMBundle`` (serving; its train step waits
for LM training), ``GNNBundle`` (GCN only; GAT, PNA and NequIP are not
ported yet) and ``RecsysBundle`` from ``repro/configs/families.py``.  The
bundles' ``abstract_state`` and ``shardings`` are not ported (mesh work,
ROADMAP §1 item 9)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.gcn import gcn_init, gcn_loss
from ..models.recsys import (WideDeepConfig, retrieval_score, widedeep_init,
                             widedeep_logits, widedeep_loss)
from ..models.transformer import (LMConfig, lm_decode_step, lm_init,
                                  lm_prefill, make_kv_caches)
from ..train.loop import make_train_step
from ..train.optimizer import Optimizer, adam
from .base import LM_SHAPES, RECSYS_SHAPES


@dataclasses.dataclass
class LMBundle:
    """A dense LM at one config over the four ``LM_SHAPES``: ``prefill``
    and ``decode`` steps (``train`` raises until LM training is ported,
    ROADMAP §1 item 8)."""
    cfg: LMConfig
    shapes = tuple(LM_SHAPES)

    def init_params(self, generator: torch.Generator, device="cuda",
                    dtype=None):
        """``lm_init``'s stacked tree in ``dtype`` (``cfg.param_dtype`` by
        default; bf16 for serving at full width)."""
        return lm_init(generator, self.cfg, device=device, dtype=dtype)

    def _info(self, shape: str, batch: Optional[int]):
        info = LM_SHAPES[shape]
        if info["kind"] == "train":
            raise NotImplementedError("LM training is not ported yet "
                                      "(ROADMAP §1 item 8)")
        return info, batch or info["batch"]

    def input_specs(self, shape: str, batch: Optional[int] = None
                    ) -> Dict[str, Any]:
        """name -> (shape, dtype) of each step input; the decode caches as
        their ``{"dense": (k, v)}`` tree.  ``batch`` overrides the cell's
        batch (``decode_32k``'s 128 x 32,768 cache is 618 GB at
        granite-8b)."""
        info, B = self._info(shape, batch)
        S = info["seq"]
        if info["kind"] == "prefill":
            return {"tokens": ((B, S), torch.int32)}
        c = self.cfg
        kv = ((c.n_layers, B, S, c.n_kv, c.hd), c.dtype)
        return {"token": ((B, 1), torch.int32),
                "caches": {"dense": (kv, kv)},
                "cache_len": ((), torch.int32)}

    def make_batch(self, shape: str, generator: torch.Generator,
                   device="cuda", batch: Optional[int] = None
                   ) -> Dict[str, Any]:
        """A concrete batch of :meth:`input_specs`: tokens uniform over the
        vocabulary, drawn where ``generator`` lives; for ``decode``, zero
        caches (``make_kv_caches``) and ``cache_len`` S - 1, the last
        position a step may write."""
        info, B = self._info(shape, batch)
        dev = resolve_device(device)
        S = info["seq"]
        draw = lambda shp: torch.randint(
            0, self.cfg.vocab, shp, generator=generator,
            device=generator.device, dtype=torch.int32).to(dev)
        if info["kind"] == "prefill":
            return {"tokens": draw((B, S))}
        return {"token": draw((B, 1)),
                "caches": make_kv_caches(self.cfg, B, S, device=dev),
                "cache_len": S - 1}

    def step_fn(self, shape: str, attn: str = "kernel"):
        """``prefill``: ``(params, batch) -> (logits, caches)``; ``decode``:
        one ``lm_decode_step`` at the cell's sequence length, writing the
        batch's caches in place."""
        info, _ = self._info(shape, None)
        cfg = self.cfg
        if info["kind"] == "prefill":
            @torch.inference_mode()
            def prefill_step(params, batch):
                return lm_prefill(params, batch["tokens"], cfg)
            return prefill_step

        @torch.inference_mode()
        def decode_step(params, batch):
            return lm_decode_step(params, batch["token"], batch["caches"],
                                  batch["cache_len"], cfg, info["seq"],
                                  attn=attn)
        return decode_step


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
