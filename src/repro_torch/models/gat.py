"""GAT (Velickovic et al., arXiv:1710.10903) — port of ``repro/models/gat.py``.

Multi-head edge-softmax attention: per-node scores ``s_src = z a_src`` and
``s_dst = z a_dst`` gathered per edge (``s_src[src] + s_dst[dst]``, the
reference's SDDMM-shaped step; neither side calls the ``sddmm`` kernel),
a segment softmax over each destination's incoming edges, then the
attention-weighted sum of the source features.  Plain PyTorch gathers,
``index_add_`` and ``scatter_reduce``, as the reference runs
``jax.ops.segment_*``: no kernel of the port.

Beyond the reference, for the paper's inductive model (§3.3: 4 x 256, 4 x
256 with a skip, 6 heads averaged), each off by default so that gat-cora
runs as the reference does: ``out_heads``, the last layer's head count
(averaged); ``skip``, ``h = act(layer(h)) + h`` on every hidden layer
after the first; ``self_loops``, each node attending over itself besides
its in-neighbours; and ``executor="fused"`` with an
``exec.gat.AttentionPlan``, whose lists hold the graph (and the self
loops), run through the ``gat::`` kernels (their plain versions on the
CPU) in place of the segment ops.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.aggregate import segment_max, segment_sum
from ..device import resolve_device
from ..dist import spmd
from ..nn.layers import cross_entropy, linear_apply, linear_init

EXECUTORS = ("segment", "fused")


def gat_dims(d_in: int, d_hidden: int, n_heads: int, n_classes: int,
             n_layers: int = 2, out_heads: int = 1):
    """Static layer geometry: ``(dims_in, dims_out, heads)``; hidden layers
    concatenate their heads, the last averages ``out_heads``."""
    dims_in = [d_in] + [d_hidden * n_heads] * (n_layers - 1)
    dims_out = [d_hidden] * (n_layers - 1) + [n_classes]
    heads = [n_heads] * (n_layers - 1) + [out_heads]
    return dims_in, dims_out, heads


def gat_init(generator: torch.Generator, d_in: int, d_hidden: int,
             n_heads: int, n_classes: int, n_layers: int = 2,
             device="cuda", out_heads: int = 1) -> Dict:
    """Layer 0: d_in -> heads*hidden (concat); final: -> n_classes (the
    mean of ``out_heads``).  Each layer draws ``w`` (no bias), then
    ``a_src`` and ``a_dst`` (N(0, 0.1²)) from ``generator``, where it
    lives."""
    dev = resolve_device(device)
    dims_in, dims_out, heads = gat_dims(d_in, d_hidden, n_heads, n_classes,
                                        n_layers, out_heads)

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


def _with_self_loops(src, dst, mask, n: int):
    loops = torch.arange(n, device=src.device, dtype=src.dtype)
    src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    if mask is not None:
        mask = torch.cat([mask, torch.ones(n, dtype=mask.dtype,
                                           device=mask.device)])
    return src, dst, mask


def gat_apply(params: Dict, x: torch.Tensor, graph: Optional[Dict[str, Any]],
              act: Callable = F.elu, mesh=None, *, skip: bool = False,
              self_loops: bool = False, executor: str = "segment",
              plan=None) -> torch.Tensor:
    """The logits (N, classes).  ``executor="fused"`` takes ``plan`` (an
    ``exec.gat.AttentionPlan`` of the graph, built with the same
    ``self_loops``) in place of ``graph``'s edges, on one device."""
    if executor not in EXECUTORS:
        raise ValueError(f"unknown GAT executor {executor!r}; expected one "
                         f"of {EXECUTORS}")
    fused = executor == "fused"
    if fused:
        if plan is None:
            raise ValueError("executor='fused' needs an attention plan "
                             "(repro_torch.exec.gat.build_attention_plan)")
        if plan.self_loops != self_loops:
            raise ValueError(f"the attention plan was built with "
                             f"self_loops={plan.self_loops}, the model asks "
                             f"for {self_loops}")
        if mesh is not None:
            raise ValueError("the fused GAT executor runs on one device")
    else:
        src, dst = graph["src"].long(), graph["dst"].long()
        mask = graph.get("edge_mask")
        if self_loops:
            if mesh is not None:
                raise ValueError("self_loops runs without a mesh")
            src, dst, mask = _with_self_loops(src, dst, mask, x.shape[0])
    h = x
    n_layers = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        # geometry recovered from parameter shapes (heads, d_out)
        n_heads, d_out = p["a_src"].shape
        if fused:
            out = plan.layer(p, h, layer=i)
        else:
            out = gat_layer(p, h, src, dst, n_heads, d_out, mask, mesh=mesh)
        if i + 1 < n_layers:
            y = act(out.reshape(out.shape[0], -1))  # concat heads
            if skip and i > 0:
                if y.shape != h.shape:
                    raise ValueError(f"a skip needs equal widths: layer {i} "
                                     f"maps {h.shape[1]} to {y.shape[1]}")
                y = y + h
            h = y
        else:
            h = out.mean(dim=1)                     # average final heads
    return h


def gat_loss(params: Dict, x: torch.Tensor, graph: Optional[Dict[str, Any]],
             labels: torch.Tensor, mask: torch.Tensor,
             mesh=None, **kw) -> torch.Tensor:
    """Masked cross-entropy of :func:`gat_apply` (``kw``: its ``skip``,
    ``self_loops``, ``executor`` and ``plan``); under ``mesh`` (the graph
    layout of ``gcn_apply``) the mean over every rank's nodes."""
    logits = gat_apply(params, x, graph, mesh=mesh, **kw)
    return cross_entropy(logits, labels, mask.to(torch.float32), mesh)
