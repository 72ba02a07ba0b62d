"""GIN (arXiv:1810.00826) — port of the GIN half of
``repro/models/sage_gin.py``, the paper's second evaluation model in its
documented configuration (§V-A, PyG defaults: 5 GINConv layers, each a
2-layer MLP, plus 2 linear layers, h = 128).

``executor`` is ``"segment"`` (``index_add_`` over the edge list),
``"blockell"`` (one ``repro_torch.exec.GraphExecutionPlan`` in mode "sum")
or ``"fused"`` (one mode-"sum" ``LayerExecutionPlan`` per conv: the trained
``1 + ε`` self coefficient and the conv's first MLP layer fold into the
aggregation, ``((1+ε) h + sum_N(h)) @ W1 + b1``, as ONE self-coefficient
plan call — one ``spmm_blockell_update_compact`` launch per conv when the
plan aggregates first on the ``cuda`` backend).

GraphSAGE and the graph-classification readout (``graph_ids``) are not
ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from ..exec.plan import GraphExecutionPlan
from ..nn.layers import (cross_entropy, linear_apply, linear_init, mlp_apply,
                         mlp_init)


def _segment_aggregate(x: torch.Tensor, graph: Dict[str, torch.Tensor],
                       op: str) -> torch.Tensor:
    """``a[v] = op_{(u->v)} x[u]`` for op in {sum, mean}; masked edges
    count for nothing."""
    msgs = x[graph["src"]]
    mask = graph.get("edge_mask")
    if mask is not None:
        msgs = torch.where(mask[:, None], msgs, torch.zeros_like(msgs))
    out = torch.zeros_like(x).index_add_(0, graph["dst"], msgs)
    if op == "mean":
        ones = (mask.to(x.dtype) if mask is not None
                else x.new_ones(graph["src"].shape[0]))
        deg = x.new_zeros(x.shape[0]).index_add_(0, graph["dst"], ones)
        return out / torch.clamp(deg, min=1.0)[:, None]
    if op != "sum":
        raise ValueError(f"unknown aggregation {op!r} (sum | mean)")
    return out


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
    if executor != "segment":
        raise ValueError(f"unknown executor {executor!r} "
                         "(segment | blockell | fused)")
    return _segment_aggregate(h, graph, op)


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
              act: Callable = torch.relu) -> torch.Tensor:
    """Node-classification forward; ``plan`` is one LayerExecutionPlan per
    conv for ``"fused"`` and one GraphExecutionPlan for ``"blockell"``."""
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
    h = act(linear_apply(params["lin1"], h))
    return linear_apply(params["lin2"], h)


def gin_loss(params: Dict, x: torch.Tensor,
             graph: Optional[Dict[str, torch.Tensor]], labels: torch.Tensor,
             mask: torch.Tensor, executor: str = "segment",
             plan=None) -> torch.Tensor:
    logits = gin_apply(params, x, graph, executor, plan)
    return cross_entropy(logits, labels, mask)
