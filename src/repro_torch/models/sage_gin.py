"""GraphSAGE (arXiv:1706.02216) and GIN (arXiv:1810.00826) — port of
``repro/models/sage_gin.py``, the paper's two evaluation models in their
documented configurations (§V-A, PyG defaults: SAGE 2 sageConv layers,
h = 256; GIN 5 GINConv layers, each a 2-layer MLP, plus 2 linear layers,
h = 128).

``executor`` is ``"segment"`` (``core.segment_aggregate`` over the edge
list), ``"shared"`` (``core.shared_aggregate`` over a ``SharedSetPlan``:
the paper's LR&CR schedule), ``"blockell"`` (one
``repro_torch.exec.GraphExecutionPlan`` in the model's mode: "mean" for
SAGE, "sum" for GIN) or ``"fused"`` (one ``LayerExecutionPlan`` per
layer).  Fused, each SAGE layer
``concat(h, mean_N(h)) @ W + b`` is the two-W plan call
``h @ W_self + mean_N(h) @ W_nbr + b`` with ReLU folded in, and each GIN
conv's first MLP layer ``((1+ε) h + sum_N(h)) @ W1 + b1`` is one
self-coefficient plan call: one ``spmm_blockell_update_compact`` launch per
layer when the plan aggregates first on the ``cuda`` backend, one
``spmm_blockell_compact`` launch when it updates first.  SAGE L2-normalizes
every layer's output, as the paper does.  ``sage_block_apply`` runs SAGE
over a sampled ``MiniBatch``'s blocks with ``index_add_`` (no block-ELL
kernel, as in the reference).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..core.aggregate import segment_aggregate, shared_aggregate
from ..core.shared_set import SharedSetPlan
from ..device import resolve_device
from ..exec.plan import GraphExecutionPlan
from ..nn.layers import (cross_entropy, linear_apply, linear_init, mlp_apply,
                         mlp_init)


def _agg(h: torch.Tensor, graph: Optional[Dict[str, torch.Tensor]], op: str,
         executor: str = "segment", plan=None) -> torch.Tensor:
    if executor == "blockell":
        if not isinstance(plan, GraphExecutionPlan):
            raise ValueError("executor='blockell' needs one "
                             "GraphExecutionPlan")
        if plan.mode != op:
            raise ValueError(f"plan mode {plan.mode!r} != aggregation {op!r}")
        if plan.num_nodes != h.shape[0]:
            raise ValueError(f"plan compiled for {plan.num_nodes} nodes but "
                             f"h has {h.shape[0]} rows (wrong graph?)")
        return plan.apply(h)
    if executor == "shared":
        # the reference quietly runs the segment path when no plan is given
        if not isinstance(plan, SharedSetPlan):
            raise ValueError("executor='shared' needs a SharedSetPlan "
                             "(build_shared_plan(g))")
        if plan.num_nodes != h.shape[0]:
            raise ValueError(f"plan built for {plan.num_nodes} nodes but "
                             f"h has {h.shape[0]} rows (wrong graph?)")
        return shared_aggregate(h, plan, op)
    if executor != "segment":
        raise ValueError(f"unknown executor {executor!r} "
                         "(segment | shared | blockell | fused)")
    return segment_aggregate(h, graph["src"], graph["dst"], h.shape[0], op,
                             edge_mask=graph.get("edge_mask"))


def l2_normalize(h: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm; a norm below 1e-6 counts as 1e-6."""
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                           min=1e-6)


# ----------------------------------------------------------------- SAGE
def sage_init(generator: torch.Generator, dims: Sequence[int],
              device="cuda") -> Dict:
    """dims = [d_in, hidden..., out]; each layer ``concat(h, mean_N(h)) @ W
    + b`` with W of (2 d_l, d_{l+1}): one generator, drawn layer by
    layer."""
    dev = resolve_device(device)
    return {"layers": [linear_init(generator, 2 * dims[i], dims[i + 1],
                                   device=dev)
                       for i in range(len(dims) - 1)]}


def sage_layer(p: Dict, h: torch.Tensor,
               graph: Optional[Dict[str, torch.Tensor]] = None,
               executor: str = "segment", plan=None, *, last: bool,
               act: Callable = torch.relu) -> torch.Tensor:
    """One SAGE layer ``concat(h, mean_N(h)) @ W + b``, ``act`` unless
    ``last``, then the L2 normalize.  ``plan`` is the layer's mode-"mean"
    LayerExecutionPlan for ``"fused"``, the GraphExecutionPlan for
    ``"blockell"`` and the graph's SharedSetPlan for ``"shared"``."""
    if executor == "fused":
        # W splits into its self and neighbor halves:
        #   concat(h, mean_N(h)) @ W + b == h @ W_self + F(h) @ W_nbr + b
        if plan.mode != "mean":
            raise ValueError(f"layer plan mode {plan.mode!r} != 'mean'")
        d_self = p["w"].shape[0] // 2
        fuse_act = act is torch.relu and not last
        h = plan.apply(h, p["w"][d_self:], p.get("b"),
                       w_self=p["w"][:d_self], relu=fuse_act)
        if not fuse_act and not last:
            h = act(h)
    else:
        nbr = _agg(h, graph, "mean", executor, plan)
        h = linear_apply(p, torch.cat([h, nbr], dim=-1))
        if not last:
            h = act(h)
    return l2_normalize(h)


def sage_apply(params: Dict, x: torch.Tensor,
               graph: Optional[Dict[str, torch.Tensor]] = None,
               executor: str = "segment", plan=None,
               act: Callable = torch.relu) -> torch.Tensor:
    """Full-graph forward; ``plan`` is one mode-"mean" LayerExecutionPlan
    per layer (a list or a ForwardExecutionPlan) for ``"fused"``, one
    GraphExecutionPlan for ``"blockell"`` and a SharedSetPlan for
    ``"shared"``."""
    h = x
    L = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        h = sage_layer(p, h, graph, executor,
                       plan[i] if executor == "fused" else plan,
                       last=i + 1 == L, act=act)
    return h


def sage_loss(params: Dict, x: torch.Tensor,
              graph: Optional[Dict[str, torch.Tensor]], labels: torch.Tensor,
              mask: torch.Tensor, head: Optional[Dict] = None,
              executor: str = "segment", plan=None) -> torch.Tensor:
    """Masked cross-entropy of the embeddings, or of ``head``'s logits over
    them when a linear head is given."""
    h = sage_apply(params, x, graph, executor, plan)
    logits = linear_apply(head, h) if head is not None else h
    return cross_entropy(logits, labels, mask)


def sage_block_apply(params: Dict, x: torch.Tensor, blocks,
                     act: Callable = torch.relu) -> torch.Tensor:
    """Minibatch forward over sampled blocks (static-shape edge lists).

    blocks: dicts ``{"src", "dst"}`` of int64 tensors in input -> output
    order, endpoints numbered into the input frontier that ``x`` covers;
    every layer computes every frontier row (mean over its sampled in-edges,
    0 where it has none), and the caller reads the seeds' rows.
    """
    h = x
    L = len(params["layers"])
    for i, (p, blk) in enumerate(zip(params["layers"], blocks)):
        h = sage_layer(p, h, blk, last=i + 1 == L, act=act)
    return h


# ------------------------------------------------------------------ GIN
def gin_init(generator: torch.Generator, d_in: int, d_hidden: int,
             n_conv: int, n_classes: int, device="cuda") -> Dict:
    """n_conv GINConv (2-layer MLPs, ε = 0) + 2 linear head layers; one
    generator, drawn conv by conv, then the head."""
    dev = resolve_device(device)
    convs = []
    d_prev = d_in
    for _ in range(n_conv):
        convs.append({"mlp": mlp_init(generator, [d_prev, d_hidden, d_hidden],
                                      device=dev),
                      "eps": torch.zeros((), device=dev)})
        d_prev = d_hidden
    return {"convs": convs,
            "lin1": linear_init(generator, d_hidden, d_hidden, device=dev),
            "lin2": linear_init(generator, d_hidden, n_classes, device=dev)}


def gin_apply(params: Dict, x: torch.Tensor,
              graph: Optional[Dict[str, torch.Tensor]] = None,
              executor: str = "segment", plan=None,
              act: Callable = torch.relu,
              graph_ids: Optional[torch.Tensor] = None,
              num_graphs: Optional[int] = None,
              node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Node-classification forward, or graph classification with
    ``graph_ids`` (each node's graph, e.g. a ``graph.pack`` batch's): the
    conv outputs of the nodes ``node_mask`` keeps are summed per graph
    before the head.  ``plan`` is one LayerExecutionPlan per conv for
    ``"fused"``, one GraphExecutionPlan for ``"blockell"`` and a
    SharedSetPlan for ``"shared"``."""
    h = x
    for ci, c in enumerate(params["convs"]):
        if executor == "fused":
            lp = plan[ci]
            if lp.mode != "sum":
                raise ValueError(f"layer plan mode {lp.mode!r} != 'sum'")
            m0 = c["mlp"][0]
            fuse_act = act is torch.relu
            h = lp.apply(h, m0["w"], m0.get("b"), w_self=m0["w"],
                         self_coeff=1.0 + c["eps"], relu=fuse_act)
            if not fuse_act:
                h = act(h)
            h = mlp_apply(c["mlp"][1:], h, act=act, final_act=act)
        else:
            nbr = _agg(h, graph, "sum", executor, plan)
            h = mlp_apply(c["mlp"], (1.0 + c["eps"]) * h + nbr, act=act,
                          final_act=act)
    if graph_ids is not None:
        if node_mask is not None:
            h = h * node_mask[:, None].to(h.dtype)
        h = h.new_zeros((num_graphs, h.shape[1])).index_add_(
            0, graph_ids.long(), h)
    h = act(linear_apply(params["lin1"], h))
    return linear_apply(params["lin2"], h)


def gin_loss(params: Dict, x: torch.Tensor,
             graph: Optional[Dict[str, torch.Tensor]], labels: torch.Tensor,
             mask: torch.Tensor, executor: str = "segment",
             plan=None) -> torch.Tensor:
    logits = gin_apply(params, x, graph, executor, plan)
    return cross_entropy(logits, labels, mask)
