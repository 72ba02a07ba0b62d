"""GAT (Velickovic et al., arXiv:1710.10903) — port of ``repro/models/gat.py``.

Multi-head edge-softmax attention: per-node scores ``s_src = z a_src`` and
``s_dst = z a_dst`` gathered per edge (``s_src[src] + s_dst[dst]``, the
reference's SDDMM-shaped step; neither side calls the ``sddmm`` kernel),
a segment softmax over each destination's incoming edges, then the
attention-weighted sum of the source features.  Plain PyTorch gathers,
``index_add_`` and ``scatter_reduce``, as the reference runs
``jax.ops.segment_*``: no kernel of the port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.aggregate import segment_max, segment_sum
from ..device import resolve_device
from ..dist import spmd
from ..nn.layers import cross_entropy, linear_apply, linear_init


def gat_dims(d_in: int, d_hidden: int, n_heads: int, n_classes: int,
             n_layers: int = 2):
    """Static layer geometry: ``(dims_in, dims_out, heads)``; hidden layers
    concatenate their heads, the last averages one."""
    dims_in = [d_in] + [d_hidden * n_heads] * (n_layers - 1)
    dims_out = [d_hidden] * (n_layers - 1) + [n_classes]
    heads = [n_heads] * (n_layers - 1) + [1]
    return dims_in, dims_out, heads


def gat_init(generator: torch.Generator, d_in: int, d_hidden: int,
             n_heads: int, n_classes: int, n_layers: int = 2,
             device="cuda") -> Dict:
    """Layer 0: d_in -> heads*hidden (concat); final: -> n_classes (mean).
    Each layer draws ``w`` (no bias), then ``a_src`` and ``a_dst``
    (N(0, 0.1²)) from ``generator``, where it lives."""
    dev = resolve_device(device)
    dims_in, dims_out, heads = gat_dims(d_in, d_hidden, n_heads, n_classes,
                                        n_layers)

    def attn(h, d):
        return (torch.randn((h, d), generator=generator,
                            device=generator.device) * 0.1).to(dev)

    layers = []
    for i in range(n_layers):
        h = heads[i]
        w = linear_init(generator, dims_in[i], h * dims_out[i], bias=False,
                        device=dev)
        layers.append({"w": w, "a_src": attn(h, dims_out[i]),
                       "a_dst": attn(h, dims_out[i])})
    return {"layers": layers}


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 edge_mask: Optional[torch.Tensor] = None,
                 mesh=None) -> torch.Tensor:
    """Numerically stable softmax over each destination's incoming edges.

    ``scores``: (E, H).  The per-destination max is not detached, as in the
    reference (its gradient cancels in exact arithmetic).  Under ``mesh``
    the edges are the rank's, ``dst`` indexing all ``num_nodes``: the shift
    is the max over the ranks, outside autograd (``spmd.max_``), and the
    denominators are summed over the ranks onto every rank."""
    if edge_mask is not None:
        scores = torch.where(edge_mask[:, None], scores,
                             torch.full_like(scores, float("-inf")))
    mx = segment_max(scores, dst, num_nodes)
    if mesh is not None and mesh.size > 1:
        mx = spmd.max_(mx, mesh, mesh.axis_names)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.exp(scores - mx[dst])
    if edge_mask is not None:
        ex = torch.where(edge_mask[:, None], ex, torch.zeros_like(ex))
    den = spmd.node_sum(segment_sum(ex, dst, num_nodes), mesh)
    return ex / torch.maximum(den[dst], den.new_tensor(1e-9))


def gat_layer(p: Dict, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              n_heads: int, d_out: int, edge_mask=None,
              negative_slope: float = 0.2, mesh=None) -> torch.Tensor:
    """One attention layer; returns (N, heads, d_out).  Under ``mesh``,
    ``h`` and the result are the rank's rows, the edges the rank's."""
    N = h.shape[0]
    z = spmd.node_gather(linear_apply(p["w"], h).reshape(N, n_heads, d_out),
                         mesh)
    n = z.shape[0]
    s_src = torch.einsum("nhd,hd->nh", z, p["a_src"].to(z.dtype))
    s_dst = torch.einsum("nhd,hd->nh", z, p["a_dst"].to(z.dtype))
    e = F.leaky_relu(s_src[src] + s_dst[dst], negative_slope)
    alpha = edge_softmax(e, dst, n, edge_mask, mesh)            # (E, H)
    msgs = z[src] * alpha[:, :, None]
    return spmd.node_scatter(segment_sum(msgs, dst, n), mesh)   # (N, H, d)


def gat_apply(params: Dict, x: torch.Tensor, graph: Dict[str, Any],
              act: Callable = F.elu, mesh=None) -> torch.Tensor:
    h = x
    src, dst = graph["src"].long(), graph["dst"].long()
    mask = graph.get("edge_mask")
    n_layers = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        # geometry recovered from parameter shapes (heads, d_out)
        n_heads, d_out = p["a_src"].shape
        out = gat_layer(p, h, src, dst, n_heads, d_out, mask, mesh=mesh)
        if i + 1 < n_layers:
            h = act(out.reshape(out.shape[0], -1))  # concat heads
        else:
            h = out.mean(dim=1)                     # average final head
    return h


def gat_loss(params: Dict, x: torch.Tensor, graph: Dict[str, Any],
             labels: torch.Tensor, mask: torch.Tensor,
             mesh=None) -> torch.Tensor:
    """Masked cross-entropy of :func:`gat_apply`; under ``mesh`` (the graph
    layout of ``gcn_apply``) the mean over every rank's nodes."""
    logits = gat_apply(params, x, graph, mesh=mesh)
    return cross_entropy(logits, labels, mask.to(torch.float32), mesh)
