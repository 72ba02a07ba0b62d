"""GCN (Kipf & Welling, arXiv:1609.02907) — port of ``repro/models/gcn.py``.

h^{l+1} = act( A_hat h^l W^l ),  A_hat = D^-1/2 (A+I) D^-1/2.

The symmetric normalization factorizes into a source and a destination
scale, so the aggregation runs unweighted on pre-scaled features.
``executor`` is ``"segment"`` (an ``index_add_`` over the edge list),
``"blockell"`` (one ``repro_torch.exec.GraphExecutionPlan`` in mode "gcn":
the whole A_hat chain as one differentiable launch, the update matmul
apart) or ``"fused"`` (one ``repro_torch.exec.LayerExecutionPlan`` call per
layer: aggregation and update as one scheduled op, on the block-ELL kernels
when the plans' backend is ``cuda``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..exec.plan import GraphExecutionPlan
from ..nn.layers import cross_entropy, linear_apply, linear_init


def gcn_init(generator: torch.Generator, dims: Sequence[int],
             device="cuda") -> Dict:
    """dims = [d_in, hidden..., num_classes]; one generator, drawn layer by
    layer."""
    dev = resolve_device(device)
    return {"layers": [linear_init(generator, dims[i], dims[i + 1],
                                   device=dev)
                       for i in range(len(dims) - 1)]}


def make_graph_inputs(g, device="cuda") -> Dict[str, torch.Tensor]:
    """Device-ready graph dict from a numpy Graph (adds self-loop degrees)."""
    dev = resolve_device(device)
    deg = g.in_degrees().astype(np.float32) + 1.0
    t = lambda a: torch.as_tensor(a).to(dev)
    out = {"src": t(g.src.astype(np.int64)), "dst": t(g.dst.astype(np.int64)),
           "deg": t(deg)}
    if g.edge_mask is not None:
        out["edge_mask"] = t(g.edge_mask)
    return out


def _aggregate_segment(x: torch.Tensor, graph: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
    """A_hat @ x over the edge list; self-loop added analytically."""
    inv_sqrt = torch.rsqrt(torch.clamp(graph["deg"], min=1.0))
    xs = x * inv_sqrt[:, None]                       # source scaling
    msgs = xs[graph["src"]]
    if "edge_mask" in graph:
        msgs = msgs * graph["edge_mask"][:, None].to(msgs.dtype)
    agg = torch.zeros_like(xs).index_add_(0, graph["dst"], msgs)
    return (agg + xs) * inv_sqrt[:, None]            # self loop, dst scaling


def gcn_apply(params: Dict, x: torch.Tensor,
              graph: Optional[Dict[str, torch.Tensor]] = None,
              executor: str = "segment", plans=None) -> torch.Tensor:
    """Forward pass; ReLU between layers, none after the last.  ``plans`` is
    one LayerExecutionPlan per layer for ``"fused"`` and one
    GraphExecutionPlan for ``"blockell"``."""
    layers = params["layers"]
    n_layers = len(layers)
    if executor == "fused":
        if plans is None or len(plans) != n_layers:
            raise ValueError("executor='fused' needs one LayerExecutionPlan "
                             f"per layer ({n_layers} layers)")
        for lp in plans:
            if lp.mode != "gcn":
                raise ValueError(f"layer plan mode {lp.mode!r} != 'gcn'")
        h = x
        for i, (p, lp) in enumerate(zip(layers, plans)):
            h = lp.apply(h, p["w"], p.get("b"), relu=i + 1 < n_layers)
        return h
    if executor == "blockell":
        if not isinstance(plans, GraphExecutionPlan):
            raise ValueError("executor='blockell' needs one "
                             "GraphExecutionPlan (build_plan(g, 'gcn'))")
        if plans.mode != "gcn":
            raise ValueError(f"plan mode {plans.mode!r} != 'gcn'")
        aggregate = plans.apply
    elif executor == "segment":
        aggregate = lambda h: _aggregate_segment(h, graph)
    else:
        raise ValueError(f"unknown executor {executor!r} "
                         "(segment | blockell | fused)")
    h = x
    for i, p in enumerate(layers):
        h = linear_apply(p, aggregate(h))
        if i + 1 < n_layers:
            h = torch.relu(h)
    return h


def gcn_loss(params: Dict, x: torch.Tensor,
             graph: Optional[Dict[str, torch.Tensor]], labels: torch.Tensor,
             mask: torch.Tensor, executor: str = "segment",
             plans=None) -> torch.Tensor:
    logits = gcn_apply(params, x, graph, executor, plans)
    return cross_entropy(logits, labels, mask)
