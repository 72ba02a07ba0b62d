"""Plain PyTorch reference of full-graph GAT training (arXiv:1710.10903):
multi-head edge-softmax attention, hidden layers concatenating their heads
through ELU, an identity skip on every hidden layer after the first, the
last layer's heads averaged into the logits, trained by masked
cross-entropy, a global-norm clip and Adam.

Per layer, with ``z = h W`` as (N, H, F) and per node and head
``s_src = Σ_F z ⊙ a_src`` and ``s_dst = Σ_F z ⊙ a_dst``, destination i
attends over its in-neighbours j (and itself, one self loop a node):
``e_ij = LeakyReLU(s_dst[i] + s_src[j])``, ``α = softmax_j(e)`` with its own
max shift, ``out_i = Σ_j α_ij z_j``.

It works on the edge list as generated (edges flow src -> dst), sorted
by destination here, and computes the attention in blocks of destination
rows whose gathered rows stay under :data:`EDGE_BLOCK_BYTES`; each block
runs under ``torch.utils.checkpoint``, so its backward recomputes the
block and no (edges, H, F) tensor exists at any time.  It imports nothing
of the program under test.  ``precision="tf32"`` runs the dense products
in TF32, as :mod:`h100bench.reference.gnn_full` does.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gnn_full import _Products

EDGE_BLOCK_BYTES = 1 << 30          # gathered rows held at once


class Graph:
    """The edges, with a self loop a node where asked, sorted by
    destination, cut into blocks of destination rows."""

    def __init__(self, src, dst, num_nodes: int, device: torch.device,
                 self_loops: bool = True):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if self_loops:
            loops = np.arange(num_nodes, dtype=np.int64)
            src, dst = np.concatenate([src, loops]), np.concatenate([dst,
                                                                     loops])
        order = np.argsort(dst, kind="stable")
        self.src = torch.as_tensor(src[order], device=device)
        self.dst = torch.as_tensor(dst[order], device=device)
        self.n = num_nodes
        self.ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=num_nodes), out=self.ptr[1:])

    def blocks(self, width: int):
        """``(lo, hi)`` row ranges whose edges times ``width`` floats stay
        under the budget (a row alone may exceed it)."""
        cap = max(1, EDGE_BLOCK_BYTES // (4 * width))
        out, lo = [], 0
        while lo < self.n:
            hi = int(np.searchsorted(self.ptr, self.ptr[lo] + cap,
                                     side="right")) - 1
            hi = min(max(hi, lo + 1), self.n)
            out.append((lo, hi))
            lo = hi
        return out


def _attend_rows(z, s_src, s_dst, src, dst_local, n_rows: int,
                 slope: float):
    """One block's attention: ``dst_local`` numbers its rows from 0."""
    e = F.leaky_relu(s_src[src] + s_dst[dst_local], slope)        # (E, H)
    idx = dst_local[:, None].expand_as(e)
    m = e.new_full((n_rows, e.shape[1]), float("-inf")).scatter_reduce(
        0, idx, e, "amax", include_self=True).detach()
    p = torch.exp(e - m[dst_local])
    den = e.new_zeros((n_rows, e.shape[1])).index_add(0, dst_local, p)
    alpha = p / den[dst_local]
    return z.new_zeros((n_rows, z.shape[1], z.shape[2])).index_add(
        0, dst_local, z[src] * alpha[:, :, None])


def attention(graph: Graph, z: torch.Tensor, s_src: torch.Tensor,
              s_dst: torch.Tensor, slope: float) -> torch.Tensor:
    """``out`` (N, H, F) of one layer, block by block."""
    outs = []
    for lo, hi in graph.blocks(z.shape[1] * z.shape[2]):
        a, b = int(graph.ptr[lo]), int(graph.ptr[hi])
        src = graph.src[a:b]
        dst_local = graph.dst[a:b] - lo
        outs.append(checkpoint(_attend_rows, z, s_src, s_dst[lo:hi], src,
                               dst_local, hi - lo, slope,
                               use_reentrant=False))
    return torch.cat(outs, dim=0)


def forward_loss(layers: List[Dict[str, torch.Tensor]], graph: Graph,
                 x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 prod: _Products, skip: bool, slope: float) -> torch.Tensor:
    h = x
    last = len(layers) - 1
    for i, p in enumerate(layers):
        H, Fw = p["a_src"].shape
        z = prod.mm(h, p["w"]).reshape(h.shape[0], H, Fw)
        s_src = torch.sum(z * p["a_src"], dim=-1)
        s_dst = torch.sum(z * p["a_dst"], dim=-1)
        out = attention(graph, z, s_src, s_dst, slope)
        if i < last:
            y = F.elu(out.reshape(out.shape[0], H * Fw))
            h = y + h if (skip and i > 0) else y
        else:
            h = out.mean(dim=1)
    nll = F.cross_entropy(h.float(), labels, reduction="none")
    return nll[mask].mean()


def train(params: List[Dict[str, torch.Tensor]], graph: Graph,
          x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
          steps: int, opt: dict, precision: str = "fp32", *,
          skip: bool = True, slope: float = 0.2) -> Dict:
    """``steps`` steps from ``params`` (a list of ``{"w", "a_src",
    "a_dst"}`` layers, left as they are).  Returns each step's loss, the
    first step's clipped gradient and the parameters' change, per leaf in
    the order ``layers[0].w, layers[0].a_src, layers[0].a_dst, ...``."""
    prod = _Products(precision, x.device)
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    clip = opt["clip_norm"]
    keys = ("w", "a_src", "a_dst")
    start = [p[k].detach().clone() for p in params for k in keys]
    leaves = [t.clone() for t in start]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, first = [], None
    with prod.mode():
        for t in range(1, steps + 1):
            live = [p.requires_grad_(True) for p in leaves]
            layers = [dict(zip(keys, live[i:i + 3]))
                      for i in range(0, len(live), 3)]
            loss = forward_loss(layers, graph, x, labels, mask, prod, skip,
                                slope)
            grads = torch.autograd.grad(loss, live)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = min(1.0, clip / max(float(norm), 1e-9))
                grads = [g * scale for g in grads]
                if first is None:
                    first = [g.clone() for g in grads]
                leaves = [p.detach() for p in live]
                for i, g in enumerate(grads):
                    m[i] = b1 * m[i] + (1 - b1) * g
                    v[i] = b2 * v[i] + (1 - b2) * g * g
                    m_hat = m[i] / (1 - b1 ** t)
                    v_hat = v[i] / (1 - b2 ** t)
                    leaves[i] = leaves[i] - lr * m_hat / (torch.sqrt(v_hat)
                                                          + eps)
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"the reference's losses are {losses}")
    return {"losses": losses, "grad": first,
            "change": [p - s for p, s in zip(leaves, start)]}
