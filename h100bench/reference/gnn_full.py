"""Plain PyTorch reference of full-graph GNN training: GCN
(arXiv:1609.02907) and GraphSAGE with the mean aggregator
(arXiv:1706.02216), trained by masked cross-entropy, a global-norm clip
and Adam.

It works on the edge list as generated (index order, edges flowing src ->
dst), recomputes degrees and norms itself, and sums over edges with
``index_add_`` in blocks of edges so that a wide aggregation fits.  It
imports nothing of the program under test.

The models, as the configurations state them:

* GCN: ``h' = act(Â (h W) + b)``, ``Â = D^-1/2 (A + I) D^-1/2`` with
  ``D`` the in-degree plus the self loop; ReLU between layers, none after
  the last; the logits are the last layer's output.  The product comes
  first, as GCN's common implementations order it: the first layer's
  pre-activations then carry the product's rounding alone, not that of a
  3,703-wide aggregation as well, so fewer of them cross the ReLU's kink
  under fp32 rounding.
* GraphSAGE: ``h' = normalize(act(concat(h, mean_N(h)) W + b))``, the mean
  over in-neighbours (0 for a node with none), ReLU between layers, none
  after the last, every layer's rows scaled to unit L2 norm (a norm under
  1e-6 counts as 1e-6); the logits are the last layer's normalized output.

SAGE's first-layer aggregation of the features is the same every step
(the features are no parameter), so it is computed once.  ``precision="tf32"``
runs every dense product in TF32: on the card with cuBLAS's TF32 switch,
on the CPU by rounding both operands to TF32's 10-bit mantissa first.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

EDGE_BLOCK_BYTES = 1 << 30          # gathered rows held at once


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest TF32 value (ties to even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Products:
    def __init__(self, precision: str, device: torch.device):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = precision == "tf32" and device.type == "cpu"
        self.cuda_tf32 = precision == "tf32" and device.type == "cuda"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.round:
            return _TF32Matmul.apply(a, b)
        return a @ b

    @contextlib.contextmanager
    def mode(self):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.cuda_tf32
        torch.backends.cudnn.allow_tf32 = self.cuda_tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


class _TF32Matmul(torch.autograd.Function):
    """A product whose operands are rounded to TF32, forward and backward,
    as the tensor cores round them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32_round(a) @ _tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32_round(g)
        return g @ _tf32_round(b).T, _tf32_round(a).T @ g


def edge_sum(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             weight: torch.Tensor = None) -> torch.Tensor:
    """``out[v] = Σ_{(u, v)} w_uv h[u]``, in blocks of edges."""
    step = max(1, EDGE_BLOCK_BYTES // max(1, h.shape[1] * h.element_size()))
    out = h.new_zeros(h.shape)
    for lo in range(0, src.shape[0], step):
        rows = h[src[lo:lo + step]]
        if weight is not None:
            rows = rows * weight[lo:lo + step, None]
        out.index_add_(0, dst[lo:lo + step], rows)
    return out


class Graph:
    """The edge list on the device, with the degrees and norms the models
    need."""

    def __init__(self, src, dst, num_nodes: int, device: torch.device):
        self.src = torch.as_tensor(src, device=device).long()
        self.dst = torch.as_tensor(dst, device=device).long()
        self.n = num_nodes
        deg = torch.bincount(self.dst, minlength=num_nodes).to(torch.float32)
        self.inv_deg = 1.0 / torch.clamp(deg, min=1.0)
        d_hat = deg + 1.0                           # the self loop
        self.gcn_w = torch.rsqrt(d_hat[self.src] * d_hat[self.dst])
        self.gcn_self = 1.0 / d_hat

    def mean(self, h):
        return edge_sum(h, self.src, self.dst) * self.inv_deg[:, None]

    def gcn(self, h):
        return edge_sum(h, self.src, self.dst, self.gcn_w) \
            + h * self.gcn_self[:, None]


def _normalize(h):
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                           min=1e-6)


def forward_loss(model: str, layers: List[Dict[str, torch.Tensor]],
                 graph: Graph, x_agg: torch.Tensor, x: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor,
                 prod: _Products) -> torch.Tensor:
    h = x
    last = len(layers) - 1
    for i, p in enumerate(layers):
        if model == "gcn":
            h = graph.gcn(prod.mm(h, p["w"])) + p["b"]
        elif model == "sage":
            agg = x_agg if i == 0 else graph.mean(h)
            h = prod.mm(torch.cat([h, agg], dim=1), p["w"]) + p["b"]
        else:
            raise ValueError(f"unknown model {model!r}")
        if i < last:
            h = torch.relu(h)
        if model == "sage":
            h = _normalize(h)
    nll = torch.nn.functional.cross_entropy(h.float(), labels,
                                            reduction="none")
    return nll[mask].mean()


def train(model: str, params: List[Dict[str, torch.Tensor]], graph: Graph,
          x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
          steps: int, opt: dict, precision: str = "fp32") -> Dict:
    """``steps`` steps from ``params`` (a list of ``{"w", "b"}`` layers,
    left as they are).  Returns each step's loss, the first step's clipped
    gradient and the parameters' change, per leaf in the order
    ``layers[0].w, layers[0].b, layers[1].w, ...``."""
    prod = _Products(precision, x.device)
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    clip = opt["clip_norm"]
    start = [t.detach().clone() for p in params for t in (p["w"], p["b"])]
    leaves = [t.clone() for t in start]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, first = [], None
    with prod.mode():
        with torch.no_grad():
            x_agg = graph.mean(x) if model == "sage" else None
        for t in range(1, steps + 1):
            live = [p.requires_grad_(True) for p in leaves]
            layers = [{"w": live[i], "b": live[i + 1]}
                      for i in range(0, len(live), 2)]
            loss = forward_loss(model, layers, graph, x_agg, x, labels,
                                mask, prod)
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
        del x_agg
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"the reference's losses are {losses}")
    return {"losses": losses, "grad": first,
            "change": [p - s for p, s in zip(leaves, start)]}
