"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718); port of
``repro/models/pna.py``.

Four aggregators (mean, max, min, std) x three degree scalers (identity,
amplification, attenuation) -> a 12-way concatenated tower -> linear.  Plain
PyTorch, as the reference runs ``jax.ops.segment_*``: no kernel of the port.
Ties at max / min (ReLU outputs tie on zeros all the time) split their
gradient evenly, and so does the ``max(var, 0)`` of a one-edge destination,
as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.aggregate import segment_max, segment_sum
from ..device import resolve_device
from ..dist import spmd
from ..nn.layers import cross_entropy, linear_apply, linear_init

AGGREGATORS = ("mean", "max", "min", "std")
SCALERS = ("identity", "amplification", "attenuation")


def pna_init(generator: torch.Generator, d_in: int, d_hidden: int,
             n_layers: int, n_classes: int, device="cuda") -> Dict:
    """Per layer ``pre`` (d_prev -> d_hidden) and ``post`` (12 d_hidden +
    d_hidden -> d_hidden), then the ``head``; drawn in that order."""
    dev = resolve_device(device)
    mult = len(AGGREGATORS) * len(SCALERS)
    layers = []
    d_prev = d_in
    for _ in range(n_layers):
        layers.append({
            "pre": linear_init(generator, d_prev, d_hidden, device=dev),
            "post": linear_init(generator, d_hidden * mult + d_hidden,
                                d_hidden, device=dev),
        })
        d_prev = d_hidden
    return {"layers": layers,
            "head": linear_init(generator, d_prev, n_classes, device=dev)}


def pna_aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  num_nodes: int, mean_log_deg: float,
                  edge_mask=None, mesh=None) -> torch.Tensor:
    """(N, d) -> (N, 12 d) PNA aggregation, single-gather fused.

    The messages ``h[src]`` are gathered ONCE and every statistic rides one
    of two segment reductions: a sum over the ``[msgs, msgs², 1]`` lanes
    (sum, sum of squares and degree share one ``index_add_``) and a max over
    ``[msgs, -msgs]`` (max and min share one ``scatter_reduce``).  Under
    ``mesh`` ``h`` and the result are the rank's rows of nodes, the edges
    the rank's, indexing the whole node set (``num_nodes`` is ignored):
    the sums are summed over the ranks and the maxes taken over them
    (``spmd.segment_max``), each cut to the rank's rows."""
    d = h.shape[1]
    h = spmd.node_gather(h, mesh)
    num_nodes = h.shape[0] if mesh is not None else num_nodes
    msgs = h[src]                                          # the ONE gather
    ones = (edge_mask.to(h.dtype) if edge_mask is not None
            else h.new_ones(src.shape[0]))
    sum_lanes = torch.cat([msgs, msgs * msgs, ones[:, None]], dim=-1)
    if edge_mask is not None:
        sum_lanes = torch.where(edge_mask[:, None], sum_lanes,
                                torch.zeros_like(sum_lanes))
    sums = spmd.node_scatter(segment_sum(sum_lanes, dst, num_nodes), mesh)
    deg = sums[:, 2 * d]
    denom = torch.clamp(deg, min=1.0)[:, None]
    mean = sums[:, :d] / denom
    sq = sums[:, d:2 * d] / denom
    # torch.maximum, not clamp: at var == 0 it splits the gradient as JAX
    std = torch.sqrt(torch.maximum(sq - mean * mean, sq.new_tensor(0.0))
                     + 1e-5)

    max_lanes = torch.cat([msgs, -msgs], dim=-1)
    if edge_mask is not None:
        max_lanes = torch.where(edge_mask[:, None], max_lanes,
                                torch.full_like(max_lanes, float("-inf")))
    maxes = (segment_max(max_lanes, dst, num_nodes) if mesh is None else
             spmd.segment_max(max_lanes, dst, num_nodes, mesh,
                              mesh.axis_names))
    maxes = torch.where(torch.isfinite(maxes), maxes,
                        torch.zeros_like(maxes))           # empty rows -> 0
    mx, mn = maxes[:, :d], -maxes[:, d:]
    aggs = [mean, mx, mn, std]

    logd = torch.log(deg + 1.0)
    s_amp = (logd / mean_log_deg)[:, None]
    s_att = (mean_log_deg / torch.clamp(logd, min=1e-5))[:, None]
    out = []
    for a in aggs:
        out.extend([a, a * s_amp, a * s_att])
    return torch.cat(out, dim=-1)


def pna_layer(p: Dict, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              mean_log_deg: float, edge_mask=None,
              act: Callable = torch.relu, mesh=None) -> torch.Tensor:
    """One PNA layer: ``pre``, the 12-way aggregation, ``post`` over
    ``[z, agg]``.  The mesh is an argument, never the ambient one: a
    checkpoint's recompute on CUDA runs in autograd's device thread."""
    z = act(linear_apply(p["pre"], h))
    agg = pna_aggregate(z, src, dst, h.shape[0], mean_log_deg, edge_mask,
                        mesh)
    return act(linear_apply(p["post"], torch.cat([z, agg], dim=-1)))


def pna_apply(params: Dict, x: torch.Tensor, graph: Dict[str, Any],
              act: Callable = torch.relu, remat: bool = False,
              mesh=None) -> torch.Tensor:
    """Logits of the layers then the head.  With ``remat`` (and autograd
    on), each layer keeps only its input for the backward and recomputes
    the rest, as ``lm_backbone`` does.  Under ``mesh``, the graph layout of
    ``gcn_apply``: ``x`` and the logits the rank's rows."""
    src, dst = graph["src"].long(), graph["dst"].long()
    args = (src, dst, graph["mean_log_deg"], graph.get("edge_mask"), act,
            mesh)
    remat = remat and torch.is_grad_enabled()
    h = x
    for p in params["layers"]:
        h = (checkpoint(pna_layer, p, h, *args, use_reentrant=False)
             if remat else pna_layer(p, h, *args))
    return linear_apply(params["head"], h)


def pna_loss(params: Dict, x: torch.Tensor, graph: Dict[str, Any],
             labels: torch.Tensor, mask: torch.Tensor,
             remat: bool = False, mesh=None) -> torch.Tensor:
    """Masked cross-entropy of :func:`pna_apply`; under ``mesh`` the mean
    over every rank's nodes."""
    logits = pna_apply(params, x, graph, remat=remat, mesh=mesh)
    return cross_entropy(logits, labels, mask.to(torch.float32), mesh)


def mean_log_degree(g) -> float:
    """Mean of log(in-degree + 1) over the nodes (1.0 if that is 0): the
    scalers' normaliser."""
    deg = g.in_degrees()
    return float(np.log(deg + 1.0).mean()) or 1.0
