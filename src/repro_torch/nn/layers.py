"""Linear layers, MLPs, LayerNorm, RMSNorm, embeddings, SwiGLU and the
masked cross-entropy as plain functions on dicts of tensors (the port of
``repro/nn/layers.py``).

``linear_init`` draws from an explicit ``torch.Generator`` where the
generator lives (the CPU for the GNNs, so a seed gives the same weights on
every device) and then moves the parameters to ``device``.  (JAX's keys
give other numbers: parity tests carry the reference's parameters over
with ``repro_torch.convert.params_from_jax``.)
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..device import resolve_device


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = True, scale: Optional[float] = None,
                device="cuda") -> dict:
    dev = resolve_device(device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device) * scale
    p = {"w": w.to(dev)}
    if bias:
        p["b"] = torch.zeros(d_out, device=dev)
    return p


def linear_apply(p: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w (+ b)`` with the parameters cast to ``dtype`` (x's dtype by
    default), as the reference casts them, and the product in the type
    JAX promotes the two to (fp32 x with bf16 weights: fp32)."""
    dtype = dtype or x.dtype
    ct = torch.promote_types(x.dtype, dtype)
    y = x.to(ct) @ p["w"].to(dtype).to(ct)
    if "b" in p:
        y = y + p["b"].to(dtype).to(ct)
    return y


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             bias: bool = True, device="cuda") -> list:
    """``dims = [d_in, hidden..., d_out]``: one linear layer per step."""
    return [linear_init(generator, dims[i], dims[i + 1], bias, device=device)
            for i in range(len(dims) - 1)]


def mlp_apply(params: Sequence[dict], x: torch.Tensor,
              act: Callable = torch.relu,
              final_act: Optional[Callable] = None) -> torch.Tensor:
    for i, p in enumerate(params):
        x = linear_apply(p, x)
        if i + 1 < len(params):
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def layernorm_init(d: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"scale": torch.ones(d, device=dev),
            "bias": torch.zeros(d, device=dev)}


def layernorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last axis,
    in x's dtype."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def rmsnorm_init(d: int, device="cuda") -> dict:
    return {"scale": torch.ones(d, device=resolve_device(device))}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale``: the sum of squares in fp32,
    its inverse root cast to x's dtype before the products, as the
    reference computes it."""
    xf = x.to(torch.float32)
    sq = torch.einsum("...d,...d->...", xf, xf)
    inv = torch.rsqrt(sq[..., None] / x.shape[-1] + eps)
    return (x * inv.to(x.dtype)) * p["scale"].to(x.dtype)


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   scale: float = 0.02, device="cuda") -> dict:
    """``{"table": (vocab, d)}`` of N(0, scale²), drawn where ``generator``
    lives."""
    t = torch.randn((vocab, d), generator=generator,
                    device=generator.device) * scale
    return {"table": t.to(resolve_device(device))}


def embedding_apply(p: dict, ids: torch.Tensor, dtype=torch.float32
                    ) -> torch.Tensor:
    """The rows ``ids`` of the table, in ``dtype``."""
    return p["table"].to(dtype)[ids.long()]


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * up


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy with an fp32 log-sum-exp; with ``mask``, the mean
    over the rows it selects (``sum(nll * mask) / max(sum(mask), 1)``)."""
    lg = logits.to(torch.float32)
    m = torch.amax(lg, dim=-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
