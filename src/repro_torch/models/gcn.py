"""GCN (Kipf & Welling, arXiv:1609.02907) — port of ``repro/models/gcn.py``.

h^{l+1} = act( A_hat h^l W^l ),  A_hat = D^-1/2 (A+I) D^-1/2.

The symmetric normalization factorizes into a source and a destination
scale, so the aggregation runs unweighted on pre-scaled features, which is
what the shared-set (G-C) reuse plan needs.  ``executor`` is
``"segment"`` (``core.segment_aggregate`` over the edge list),
``"shared"`` (``core.shared_aggregate`` over a ``SharedSetPlan``, the
paper's computation reuse), ``"blockell"`` (with a
``repro_torch.exec.GraphExecutionPlan`` in mode "gcn": the whole A_hat
chain as one differentiable launch, the update matmul apart; with a bare
adjacency ``BlockEll``: ``core.blockell_aggregate`` inside the scaling
chain, one ``spmm_blockell`` launch on the card) or ``"fused"`` (one
``repro_torch.exec.LayerExecutionPlan`` call per layer: aggregation and
update as one scheduled op, on the block-ELL kernels when the plans'
backend is ``cuda``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.aggregate import (blockell_aggregate, segment_aggregate,
                              shared_aggregate)
from ..core.blocksparse import BlockEll
from ..core.shared_set import SharedSetPlan
from ..device import resolve_device
from ..dist import spmd
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


def _aggregate(x: torch.Tensor, graph: Dict[str, torch.Tensor],
               aggregate: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """A_hat @ x: ``aggregate`` sums over the edges of the source-scaled
    features; the self loop is added analytically."""
    inv_sqrt = torch.rsqrt(torch.clamp(graph["deg"], min=1.0))
    xs = x * inv_sqrt[:, None]                       # source scaling
    return (aggregate(xs) + xs) * inv_sqrt[:, None]  # self loop, dst scaling


def _edge_sum(executor: str, plans, graph: Dict[str, torch.Tensor],
              mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The unweighted sum over the edges that ``executor`` runs.  Under
    ``mesh`` (segment only): the whole node set's features gathered, the
    rank's edges summed into a buffer of every node, that summed over the
    ranks and cut to the rank's rows."""
    if mesh is not None and executor != "segment":
        raise ValueError(f"the mesh path runs executor='segment' only "
                         f"(got {executor!r})")
    if executor == "segment":
        return lambda xs: spmd.node_scatter(segment_aggregate(
            spmd.node_gather(xs, mesh), graph["src"], graph["dst"],
            spmd.node_count(xs.shape[0], mesh), "sum",
            edge_mask=graph.get("edge_mask")), mesh)
    if executor == "shared":
        if not isinstance(plans, SharedSetPlan):
            raise ValueError("executor='shared' needs a SharedSetPlan "
                             "(build_shared_plan(g))")
        return lambda xs: shared_aggregate(xs, plans, "sum")
    if executor == "blockell":
        if not isinstance(plans, BlockEll):
            raise ValueError("executor='blockell' needs one "
                             "GraphExecutionPlan (build_plan(g, 'gcn')) or "
                             "the adjacency's BlockEll (build_blockell(g))")
        return lambda xs: blockell_aggregate(plans, xs)
    raise ValueError(f"unknown executor {executor!r} "
                     "(segment | shared | blockell | fused)")


def gcn_apply(params: Dict, x: torch.Tensor,
              graph: Optional[Dict[str, torch.Tensor]] = None,
              executor: str = "segment", plans=None,
              mesh=None) -> torch.Tensor:
    """Forward pass; ReLU between layers, none after the last.  ``plans`` is
    one LayerExecutionPlan per layer for ``"fused"``, one GraphExecutionPlan
    or the adjacency's BlockEll for ``"blockell"`` and a SharedSetPlan for
    ``"shared"``.  With ``mesh`` (``"segment"`` only), ``x`` and
    ``graph["deg"]`` are the rank's rows of nodes cut over every axis and
    the graph's edges the rank's, indexing the whole node set: the result
    is the rank's rows."""
    layers = params["layers"]
    n_layers = len(layers)
    if mesh is not None and executor != "segment":
        raise ValueError(f"the mesh path runs executor='segment' only "
                         f"(got {executor!r})")
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
    if executor == "blockell" and isinstance(plans, GraphExecutionPlan):
        if plans.mode != "gcn":
            raise ValueError(f"plan mode {plans.mode!r} != 'gcn'")
        aggregate = plans.apply
    else:
        edge_sum = _edge_sum(executor, plans, graph, mesh)
        aggregate = lambda h: _aggregate(h, graph, edge_sum)
    h = x
    for i, p in enumerate(layers):
        h = linear_apply(p, aggregate(h))
        if i + 1 < n_layers:
            h = torch.relu(h)
    return h


def gcn_loss(params: Dict, x: torch.Tensor,
             graph: Optional[Dict[str, torch.Tensor]], labels: torch.Tensor,
             mask: torch.Tensor, executor: str = "segment",
             plans=None, mesh=None) -> torch.Tensor:
    logits = gcn_apply(params, x, graph, executor, plans, mesh)
    return cross_entropy(logits, labels, mask, mesh)
