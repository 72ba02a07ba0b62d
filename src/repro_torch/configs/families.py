"""Family bundles — port of ``LMBundle`` (training, prefill and decode),
``GNNBundle`` (gcn | gat | pna | nequip over the four graph cells) and
``RecsysBundle`` from ``repro/configs/families.py``.  The bundles'
``abstract_state`` and ``shardings`` are mesh work (ROADMAP §1 item 9)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.gat import gat_init, gat_loss
from ..models.gcn import gcn_init, gcn_loss
from ..models.nequip import nequip_energy, nequip_init
from ..models.pna import pna_init, pna_loss
from ..models.recsys import (WideDeepConfig, retrieval_score, widedeep_init,
                             widedeep_logits, widedeep_loss)
from ..models.transformer import (LMConfig, kv_cache_shapes, lm_decode_step,
                                  lm_init, lm_loss, lm_prefill,
                                  make_kv_caches)
from ..train.loop import make_train_step
from ..train.optimizer import Optimizer, adam
from .base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, pad_to


@dataclasses.dataclass
class LMBundle:
    """An LM (dense or MoE) at one config over the four ``LM_SHAPES``: the
    ``train`` step, ``prefill`` and ``decode``."""
    cfg: LMConfig
    moments_dtype: Any = torch.float32
    shapes = tuple(LM_SHAPES)

    def init_params(self, generator: torch.Generator, device="cuda",
                    dtype=None):
        """``lm_init``'s stacked tree in ``dtype`` (``cfg.param_dtype`` by
        default, the fp32 master weights training takes; bf16 for serving
        at full width)."""
        return lm_init(generator, self.cfg, device=device, dtype=dtype)

    def opt(self) -> Optimizer:
        """The train step's optimizer: Adam(3e-4), moments in
        ``moments_dtype``; ``opt().init(params)`` is the state it takes."""
        return adam(3e-4, moments_dtype=self.moments_dtype)

    def input_specs(self, shape: str, batch: Optional[int] = None
                    ) -> Dict[str, Any]:
        """name -> (shape, dtype) of each step input; the decode caches as
        their tree (``kv_cache_shapes``: ``{"dense": (k, v)}``, or a MoE
        config's ``{"moe": ..., "dense": ...}``).  ``batch`` overrides the
        cell's batch (``decode_32k``'s 128 x 32,768 cache is 618 GB at
        granite-8b)."""
        info = LM_SHAPES[shape]
        B, S = batch or info["batch"], info["seq"]
        if info["kind"] == "train":
            return {"tokens": ((B, S), torch.int32),
                    "targets": ((B, S), torch.int32)}
        if info["kind"] == "prefill":
            return {"tokens": ((B, S), torch.int32)}
        caches = {name: ((shape, self.cfg.dtype),) * 2 for name, shape
                  in kv_cache_shapes(self.cfg, B, S).items()}
        return {"token": ((B, 1), torch.int32), "caches": caches,
                "cache_len": ((), torch.int32)}

    def make_batch(self, shape: str, generator: torch.Generator,
                   device="cuda", batch: Optional[int] = None
                   ) -> Dict[str, Any]:
        """A concrete batch of :meth:`input_specs`: tokens (and targets)
        uniform over the vocabulary, drawn where ``generator`` lives; for
        ``decode``, zero caches (``make_kv_caches``) and ``cache_len`` S -
        1, the last position a step may write."""
        info = LM_SHAPES[shape]
        B, S = batch or info["batch"], info["seq"]
        dev = resolve_device(device)
        draw = lambda shp: torch.randint(
            0, self.cfg.vocab, shp, generator=generator,
            device=generator.device, dtype=torch.int32).to(dev)
        if info["kind"] == "train":
            return {"tokens": draw((B, S)), "targets": draw((B, S))}
        if info["kind"] == "prefill":
            return {"tokens": draw((B, S))}
        return {"token": draw((B, 1)),
                "caches": make_kv_caches(self.cfg, B, S, device=dev),
                "cache_len": S - 1}

    def loss_fn(self, params, batch):
        """``lm_loss`` of a ``train`` batch; its tokens and targets may be
        numpy, and are moved to the params' device."""
        dev = params["embed"].device
        return lm_loss(params, torch.as_tensor(batch["tokens"], device=dev),
                       torch.as_tensor(batch["targets"], device=dev),
                       self.cfg)

    def step_fn(self, shape: str, attn: str = "kernel"):
        """``train``: ``(params, opt_state, batch) -> (params, opt_state,
        loss)``, :meth:`loss_fn` then the clip at 1.0 and one step of
        :meth:`opt`, as the reference's train step, donated as the
        reference's is: the params and state are updated in place
        (``make_train_step``).  ``prefill``: ``(params, batch) -> (logits,
        caches)``; ``decode``: one ``lm_decode_step`` at the cell's sequence
        length, writing the batch's caches in place."""
        info = LM_SHAPES[shape]
        cfg = self.cfg
        if info["kind"] == "train":
            return make_train_step(self.loss_fn, self.opt(), clip_norm=1.0)
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
    """gcn | gat | pna | nequip over the four ``GNN_SHAPES``."""
    arch: str
    model_kw: Dict[str, Any]
    n_classes: int = 16
    shapes = tuple(GNN_SHAPES)

    def geometry(self, shape: str) -> Dict[str, int]:
        """The cell's node and edge counts padded to multiples of 512, and
        its feature width (16 for ``molecule``: the species embedding's
        cell has no features), as the reference sizes them."""
        info = GNN_SHAPES[shape]
        if shape == "minibatch_lg":
            b, (f1, f2) = info["batch_nodes"], info["fanout"]
            n = b + b * f1 + b * f1 * f2
            e = b * f1 + b * f1 * f2
            d = info["d_feat"]
        elif shape == "molecule":
            n = info["batch"] * info["n_nodes"]
            e = info["batch"] * info["n_edges"]
            d = 16
        else:
            n, e, d = info["n_nodes"], info["n_edges"], info["d_feat"]
        return {"n": pad_to(n, 512), "e": pad_to(e, 512), "d": d}

    def init_params(self, generator: torch.Generator, d_feat: int,
                    device="cuda"):
        kw = self.model_kw
        if self.arch == "gcn":
            return gcn_init(generator, [d_feat, *kw["hidden"],
                                        self.n_classes], device=device)
        if self.arch == "gat":
            return gat_init(generator, d_feat, kw["d_hidden"], kw["n_heads"],
                            self.n_classes, kw["n_layers"], device=device)
        if self.arch == "pna":
            return pna_init(generator, d_feat, kw["d_hidden"],
                            kw["n_layers"], self.n_classes, device=device)
        if self.arch == "nequip":
            return nequip_init(generator, channels=kw["d_hidden"],
                               n_layers=kw["n_layers"],
                               n_rbf=kw.get("n_rbf", 8),
                               cutoff=kw.get("cutoff", 5.0), device=device)
        raise ValueError(f"unknown GNN arch {self.arch!r}")

    def loss_fn(self, shape: str, executor: str = "segment",
                exec_plan=None, remat: bool = False):
        """``loss(params, batch)``.  GCN: ``executor="blockell"`` + a
        ``GraphExecutionPlan`` routes the aggregation through the block-ELL
        plan; ``executor="fused"`` + one ``LayerExecutionPlan`` per layer
        folds the update in too (the plans are closed over; their
        hand-written backwards keep the loss differentiable).  GAT and PNA
        run the reference's segment ops, with its ``mean_log_deg = 2.0``;
        NequIP's loss is the squared error of the summed energy (over the
        ``train_mask`` nodes) against ``energy_target``.  Those three have
        no kernel executor: another ``executor`` than ``"segment"`` raises
        (the reference ignores it).  ``remat`` runs PNA's layers under
        ``torch.utils.checkpoint`` (other archs raise)."""
        if self.arch not in ("gcn", "gat", "pna", "nequip"):
            raise ValueError(f"unknown GNN arch {self.arch!r}")
        if self.arch != "gcn" and executor != "segment":
            raise ValueError(f"arch {self.arch!r} has no kernel executor "
                             f"(got executor={executor!r}); its "
                             "aggregations are segment ops")
        if remat and self.arch != "pna":
            raise ValueError(f"remat is PNA's only (arch {self.arch!r})")
        if executor == "blockell" and exec_plan is None:
            raise ValueError("executor='blockell' needs an exec_plan "
                             "(repro_torch.exec.build_plan)")
        if executor == "fused" and not exec_plan:
            raise ValueError("executor='fused' needs per-layer plans "
                             "(repro_torch.exec.build_layer_plan)")

        def loss(params, batch):
            if self.arch == "nequip":
                e = nequip_energy(params, batch["species"], batch["pos"],
                                  batch["src"], batch["dst"],
                                  edge_mask=batch["edge_mask"],
                                  node_mask=batch["train_mask"].to(
                                      batch["pos"].dtype))
                return torch.mean((torch.sum(e) - batch["energy_target"])
                                  ** 2)
            graph = {"src": batch["src"], "dst": batch["dst"],
                     "edge_mask": batch["edge_mask"], "deg": batch["deg"],
                     "mean_log_deg": 2.0}
            args = (params, batch["x"], graph, batch["labels"],
                    batch["train_mask"])
            if self.arch == "gat":
                return gat_loss(*args)
            if self.arch == "pna":
                return pna_loss(*args, remat=remat)
            return gcn_loss(*args, executor=executor, plans=exec_plan)
        return loss

    def opt(self) -> Optimizer:
        """The train step's optimizer, Adam(1e-3)."""
        return adam(1e-3)

    def step_fn(self, shape: str):
        """``(params, opt_state, batch) -> (params, opt_state, loss)``:
        :meth:`loss_fn` on the segment path, the clip at 1.0 and one step
        of :meth:`opt`, as the reference's train step; donated (the params
        and state are updated in place, ``make_train_step``)."""
        return make_train_step(self.loss_fn(shape), self.opt(),
                               clip_norm=1.0)


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
