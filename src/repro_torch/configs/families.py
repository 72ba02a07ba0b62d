"""Family bundles — port of ``LMBundle`` (training, prefill and decode),
``GNNBundle`` (gcn | gat | pna | nequip over the four graph cells) and
``RecsysBundle`` from ``repro/configs/families.py``.

Each bundle also has the reference's dry-run surface:
  input_specs(shape)     -> name -> (shape, dtype) of each step input;
  abstract_state(shape)  -> (params, opt_state) on the ``meta`` device
                            (the shapes and dtypes of ``jax.eval_shape``;
                            nothing is allocated);
  shardings(mesh, shape) -> (arg_shardings, out_shardings), trees of
                            ``dist.sharding.NamedSharding``.
Under ``dist.sharding.use_mesh`` every bundle's steps run a manual mesh
path on the rank's blocks of these layouts: the LMs' in
``models.transformer`` (``convert.shard_params`` cuts the blocks), the
GNNs' and wide & deep's through the models' ``mesh`` argument."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..dist import spmd
from ..dist.sharding import (P, NamedSharding, ambient_mesh, as_mesh,
                             batch_axes, broadcast_specs, lm_param_specs,
                             map_specs)
from ..models.gat import gat_init, gat_loss
from ..models.gcn import gcn_init, gcn_loss
from ..models.nequip import nequip_energy, nequip_init
from ..models.pna import pna_init, pna_loss
from ..models.recsys import (WideDeepConfig, retrieval_score, widedeep_init,
                             widedeep_logits, widedeep_loss)
from ..models.transformer import (LMConfig, _layer_shapes, kv_cache_shapes,
                                  lm_abstract_params, lm_decode_step,
                                  lm_init, lm_loss, lm_prefill,
                                  make_kv_caches)
from ..train.loop import make_train_step
from ..train.optimizer import (Optimizer, adam, tree_leaves, tree_map,
                               tree_unflatten)
from .base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, pad_to


def _spec_tree_for_opt(param_specs):
    return {"m": param_specs, "v": param_specs, "step": P()}


def _named(mesh, tree):
    """P tree -> NamedSharding tree on ``mesh``."""
    mesh = as_mesh(mesh)
    return map_specs(lambda s: NamedSharding(mesh, s), tree)


def _meta(tree):
    """The tree's tensors as ``meta`` tensors of the same shapes and
    dtypes."""
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), tree)


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

    # ------------------------------------------------------------- state
    def abstract_params(self):
        """``lm_init``'s tree on the ``meta`` device (``cfg.param_dtype``):
        shapes and dtypes only."""
        return lm_abstract_params(self.cfg)

    def abstract_state(self, shape: str):
        """(params, opt_state) on ``meta``; opt_state None for the serving
        cells, Adam's ``m`` / ``v`` / ``step`` for ``train``."""
        params = self.abstract_params()
        if LM_SHAPES[shape]["kind"] != "train":
            return params, None
        return params, self.opt().init(params)

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
                       self.cfg, constrain=self.make_constrain())

    def make_constrain(self):
        """The per-layer hook of the steps (the reference's re-assertion of
        each layer's weight sharding inside its scans).  The port's ZeRO
        gather is explicit (``dist.spmd.layer_of``: one layer at a time,
        from its owner), so under the ambient mesh the hook holds each
        gathered layer to its per-layer layout (``lm_param_specs`` with the
        stack entry dropped; it raises on any other shape) and returns it;
        with no mesh it returns the layer."""
        cfg = self.cfg

        def constrain(kind, lp):
            mesh = ambient_mesh()
            if mesh is None:
                return lp
            specs = lm_param_specs(cfg, mesh)
            key = "moe_layers" if kind == "moe" else "dense_layers"
            if key not in specs:
                return lp
            sub = _drop_lead(specs[key], 1)
            shapes = _layer_shapes(cfg, moe=kind == "moe")

            def walk(spec, shape, leaf):
                if isinstance(leaf, dict):
                    for k in leaf:
                        walk(spec if isinstance(spec, P) else spec[k],
                             shape[k], leaf[k])
                    return
                want = NamedSharding(mesh, spec).shard_shape(shape[0])
                if tuple(leaf.shape) != want:
                    raise ValueError(f"a {kind} layer leaf of shape "
                                     f"{tuple(leaf.shape)} is not the "
                                     f"{want} block of {spec!r} on {mesh!r}")
            walk(sub, shapes, lp)
            return lp
        return constrain

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
        cn = self.make_constrain()
        if info["kind"] == "train":
            mesh = ambient_mesh()
            norm = None if mesh is None else self._mesh_norm(mesh)
            return make_train_step(self.loss_fn, self.opt(), clip_norm=1.0,
                                   norm_fn=norm)
        if info["kind"] == "prefill":
            @torch.inference_mode()
            def prefill_step(params, batch):
                return lm_prefill(params, batch["tokens"], cfg,
                                  constrain=cn)
            return prefill_step

        @torch.inference_mode()
        def decode_step(params, batch):
            return lm_decode_step(params, batch["token"], batch["caches"],
                                  batch["cache_len"], cfg, info["seq"],
                                  attn=attn, constrain=cn)
        return decode_step

    def _mesh_norm(self, mesh):
        """The global gradient norm of rank-local gradients (in
        ``tree_leaves(params)`` order) on ``mesh``: each leaf's squares over
        the number of ranks holding each of its entries, summed over every
        rank."""
        whole = self.abstract_params()

        def norm(grads, params):
            parts = []
            tree_map(lambda g, a: parts.append(
                torch.sum(torch.square(g.to(torch.float32)))
                * (a.numel() / (mesh.size * g.numel()))),
                tree_unflatten(params, grads), whole)
            return torch.sqrt(spmd.all_reduce(sum(parts), mesh,
                                              mesh.axis_names))
        return norm

    # ---------------------------------------------------------- shardings
    def _cache_spec(self, mesh, batch: int):
        """KV cache PartitionSpec factory for the stacked cache trees."""
        mesh = as_mesh(mesh)
        ba = batch_axes(mesh)
        n_batch_shards = (mesh.shape["data"] *
                          (mesh.shape.get("pod", 1)))
        if batch >= n_batch_shards and batch % n_batch_shards == 0:
            bspec, sspec = ba, "model"
        else:
            bspec = None
            sspec = tuple(a for a in mesh.axis_names)  # shard seq everywhere

        def spec(ndim):
            lead = (None,) * (ndim - 4)
            return P(*lead, bspec, sspec, None, None)
        return spec

    def shardings(self, mesh, shape: str):
        """(arg shardings, out shardings) of the cell's step, trees of
        ``NamedSharding`` as the reference's."""
        mesh = as_mesh(mesh)
        info = LM_SHAPES[shape]
        pspecs = lm_param_specs(self.cfg, mesh)
        params_sh = _tree_specs_to_shardings(pspecs, self.abstract_params(),
                                             mesh)
        ba = batch_axes(mesh)
        if info["kind"] == "train":
            opt_sh = _tree_specs_to_shardings(
                _spec_tree_for_opt(pspecs), self.abstract_state(shape)[1],
                mesh)
            batch_sh = {"tokens": NamedSharding(mesh, P(ba, None)),
                        "targets": NamedSharding(mesh, P(ba, None))}
            out_sh = (params_sh, opt_sh, NamedSharding(mesh, P()))
            return (params_sh, opt_sh, batch_sh), out_sh
        if info["kind"] == "prefill":
            batch_sh = {"tokens": NamedSharding(mesh, P(ba, None))}
            return (params_sh, batch_sh), None
        # decode
        spec = self._cache_spec(mesh, info["batch"])
        caches = self.input_specs(shape)["caches"]
        cache_sh = {name: tuple(NamedSharding(mesh, spec(len(shp)))
                                for shp, _ in pair)
                    for name, pair in caches.items()}
        tok_spec = (P(ba, None) if info["batch"] >= mesh.shape["data"]
                    else P(None, None))
        batch_sh = {"token": NamedSharding(mesh, tok_spec),
                    "caches": cache_sh,
                    "cache_len": NamedSharding(mesh, P())}
        out_sh = (NamedSharding(mesh, tok_spec), cache_sh)
        return (params_sh, batch_sh), out_sh


def _drop_lead(spec_tree, n):
    """Each P leaf without its first ``n`` entries."""
    if isinstance(spec_tree, P):
        return P(*spec_tree[n:])
    return {k: _drop_lead(v, n) for k, v in spec_tree.items()}


def _tree_specs_to_shardings(spec_tree, params_tree, mesh):
    """Broadcast a structural spec tree over the params tree (specs may be
    single P leaves standing for whole sub-pytrees of identical layout)."""
    mesh = as_mesh(mesh)
    return _named(mesh, broadcast_specs(spec_tree, params_tree))


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
        ``torch.utils.checkpoint`` (other archs raise).

        Under ``dist.sharding.use_mesh`` (read when the loss runs) it is
        the mesh path of :meth:`shardings`' layout: the batch's nodes and
        edges are the rank's blocks over every axis, the edge ids index the
        whole node set, and the parameters, held whole on every rank, enter
        through ``spmd.copy`` over every axis, so each rank's gradients are
        the whole step's; the loss is the whole graph's on every rank.  The
        segment path only."""
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
            mesh = ambient_mesh()
            if mesh is not None:
                params = tree_map(lambda a: spmd.copy(a, mesh,
                                                      mesh.axis_names),
                                  params)
            if self.arch == "nequip":
                e = nequip_energy(params, batch["species"], batch["pos"],
                                  batch["src"], batch["dst"],
                                  edge_mask=batch["edge_mask"],
                                  node_mask=batch["train_mask"].to(
                                      batch["pos"].dtype), mesh=mesh)
                return torch.mean((torch.sum(e) - batch["energy_target"])
                                  ** 2)
            graph = {"src": batch["src"], "dst": batch["dst"],
                     "edge_mask": batch["edge_mask"], "deg": batch["deg"],
                     "mean_log_deg": 2.0}
            args = (params, batch["x"], graph, batch["labels"],
                    batch["train_mask"])
            if self.arch == "gat":
                return gat_loss(*args, mesh=mesh)
            if self.arch == "pna":
                return pna_loss(*args, remat=remat, mesh=mesh)
            return gcn_loss(*args, executor=executor, plans=exec_plan,
                            mesh=mesh)
        return loss

    def opt(self) -> Optimizer:
        """The train step's optimizer, Adam(1e-3)."""
        return adam(1e-3)

    def abstract_state(self, shape: str):
        """(params, Adam state) on ``meta`` at the cell's feature width
        (the parameters are small: drawn on the CPU, then described)."""
        g = self.geometry(shape)
        params = _meta(self.init_params(torch.Generator().manual_seed(0),
                                        g["d"], device="cpu"))
        return params, self.opt().init(params)

    def input_specs(self, shape: str
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """name -> (shape, dtype) of each step input at the cell's padded
        geometry: int32 edge ids and labels, bool masks, float32 features
        (NequIP: int32 species, (n, 3) positions and a 0-d energy
        target)."""
        g = self.geometry(shape)
        n, e, d = g["n"], g["e"], g["d"]
        specs = {"src": ((e,), torch.int32), "dst": ((e,), torch.int32),
                 "edge_mask": ((e,), torch.bool),
                 "labels": ((n,), torch.int32),
                 "train_mask": ((n,), torch.bool)}
        if self.arch == "nequip":
            specs.update({"species": ((n,), torch.int32),
                          "pos": ((n, 3), torch.float32),
                          "energy_target": ((), torch.float32)})
        else:
            specs.update({"x": ((n, d), torch.float32),
                          "deg": ((n,), torch.float32)})
        return specs

    def shardings(self, mesh, shape: str):
        """Parameters and state replicated; nodes and edges over every
        mesh axis, as the reference's."""
        mesh = as_mesh(mesh)
        axes = tuple(mesh.axis_names)
        params, opt_state = self.abstract_state(shape)
        rep = tree_map(lambda _: NamedSharding(mesh, P()), params)
        opt_sh = tree_map(lambda _: NamedSharding(mesh, P()), opt_state)
        node = NamedSharding(mesh, P(axes))
        node2 = NamedSharding(mesh, P(axes, None))
        edge = NamedSharding(mesh, P(axes))
        batch_sh = {"src": edge, "dst": edge, "edge_mask": edge,
                    "labels": node, "train_mask": node}
        if self.arch == "nequip":
            batch_sh.update({"species": node, "pos": node2,
                             "energy_target": NamedSharding(mesh, P())})
        else:
            batch_sh.update({"x": node2, "deg": node})
        out_sh = (rep, opt_sh, NamedSharding(mesh, P()))
        return (rep, opt_sh, batch_sh), out_sh

    def step_fn(self, shape: str):
        """``(params, opt_state, batch) -> (params, opt_state, loss)``:
        :meth:`loss_fn` on the segment path, the clip at 1.0 and one step
        of :meth:`opt`, as the reference's train step; donated (the params
        and state are updated in place, ``make_train_step``).  Under a mesh
        every rank holds the summed gradients whole (the loss's
        ``spmd.copy``), so the clip's norm is the rank's own and Adam runs
        alike on every rank."""
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

    def abstract_params(self):
        """``widedeep_init``'s tree on ``meta`` (the published tables are
        GBs: described, never drawn)."""
        cfg = self.cfg
        m = lambda *shape, dtype=torch.float32: torch.empty(
            shape, dtype=dtype, device="meta")
        dims = [cfg.n_sparse * cfg.embed_dim + cfg.n_dense, *cfg.mlp_dims, 1]
        return {"table": m(cfg.total_rows, cfg.embed_dim,
                           dtype=cfg.param_dtype),
                "wide": m(cfg.total_rows, dtype=cfg.param_dtype),
                "wide_dense": {"w": m(cfg.n_dense, 1), "b": m(1)},
                "deep": [{"w": m(dims[i], dims[i + 1]), "b": m(dims[i + 1])}
                         for i in range(len(dims) - 1)]}

    def abstract_state(self, shape: str):
        """(params, opt_state) on ``meta``; opt_state None for the serving
        cells."""
        params = self.abstract_params()
        if RECSYS_SHAPES[shape]["kind"] != "train":
            return params, None
        return params, self.optimizer().init(params)

    def shardings(self, mesh, shape: str):
        """The tables over ``model``, the MLP replicated, the batch over
        the batch axes when it reaches them (``mesh.size`` here is the
        reference's ``mesh.devices.size``)."""
        mesh = as_mesh(mesh)
        info = RECSYS_SHAPES[shape]
        ba = batch_axes(mesh)
        axes = tuple(mesh.axis_names)
        params, opt_state = self.abstract_state(shape)
        pspec = {"table": P("model", None), "wide": P("model"),
                 "wide_dense": {"w": P(None, None), "b": P(None)},
                 "deep": [{"w": P(None, None), "b": P(None)}
                          for _ in range(len(self.cfg.mlp_dims) + 1)]}
        params_sh = _tree_specs_to_shardings(pspec, params, mesh)
        bspec = ba if self.batch_axes(mesh, shape) else None
        batch_sh = {"sparse": NamedSharding(mesh, P(bspec, None)),
                    "dense": NamedSharding(mesh, P(bspec, None))}
        if info["kind"] == "train":
            opt_sh = {"m": params_sh, "v": params_sh,
                      "step": NamedSharding(mesh, P())}
            batch_sh["labels"] = NamedSharding(mesh, P(bspec))
            out_sh = (params_sh, opt_sh, NamedSharding(mesh, P()))
            return (params_sh, opt_sh, batch_sh), out_sh
        if shape == "retrieval_cand":
            batch_sh["sparse"] = NamedSharding(mesh, P(None, None))
            batch_sh["dense"] = NamedSharding(mesh, P(None, None))
            batch_sh["candidates"] = NamedSharding(mesh, P(axes, None))
            return (params_sh, batch_sh), NamedSharding(mesh, P(axes))
        return (params_sh, batch_sh), None

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

    def batch_axes(self, mesh, shape: str) -> tuple:
        """The mesh axes :meth:`shardings` cuts the cell's batch over: the
        batch axes when the batch reaches them, else none (the batch whole
        on every rank)."""
        mesh = as_mesh(mesh)
        if RECSYS_SHAPES[shape]["batch"] < mesh.size // mesh.shape["model"]:
            return ()
        ba = batch_axes(mesh)
        return (ba,) if isinstance(ba, str) else tuple(ba)

    def step_fn(self, shape: str, lookup: str = "bag"):
        """``train_batch``: ``(params, opt_state, batch) -> (params,
        opt_state, loss)``, one Adam(1e-3) step with no clipping, as the
        reference's; ``retrieval_cand``: ``(params, batch) -> (N,)`` scores;
        the serve shapes: ``(params, batch) -> (B,)`` logits.

        Under ``dist.sharding.use_mesh`` (read when the step runs) it is
        the mesh path of :meth:`shardings`' layout on the rank's blocks:
        the lookups masked to the rank's rows of ``table`` and ``wide`` and
        summed over ``model``; where the batch is cut (:meth:`batch_axes`)
        every parameter enters through ``spmd.copy`` over the batch axes,
        so its gradient (the table's dense) is summed over them, and the
        loss is the mean over them; Adam runs on the rank's blocks.  The
        outputs are the rank's: its rows' logits, its block of the
        candidates' scores."""
        cfg = self.cfg
        if RECSYS_SHAPES[shape]["kind"] == "train":
            def loss(p, b):
                mesh = ambient_mesh()
                if mesh is None:
                    return widedeep_loss(p, b["sparse"], b["dense"],
                                         b["labels"], cfg, lookup)
                axes = self.batch_axes(mesh, shape)
                p = tree_map(lambda a: spmd.copy(a, mesh, axes), p)
                return spmd.mean(widedeep_loss(p, b["sparse"], b["dense"],
                                               b["labels"], cfg, lookup,
                                               mesh), mesh, axes)
            return make_train_step(loss, self.optimizer(), clip_norm=None)
        if shape == "retrieval_cand":
            @torch.no_grad()
            def retrieve(params, batch):
                return retrieval_score(params, batch["sparse"],
                                       batch["dense"], batch["candidates"],
                                       cfg, lookup, ambient_mesh())
            return retrieve

        @torch.no_grad()
        def serve(params, batch):
            return widedeep_logits(params, batch["sparse"], batch["dense"],
                                   cfg, lookup, ambient_mesh())
        return serve
