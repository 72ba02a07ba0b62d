"""Linear layers as plain functions on dicts of tensors (the port of the
``linear_*`` half of ``repro/nn/layers.py``).

``linear_init`` draws from an explicit ``torch.Generator`` on the CPU and
then moves the parameters to ``device``, so a seed gives the same weights
on every device.  (JAX's keys give other numbers: parity tests carry the
reference's parameters over with ``repro_torch.convert.params_from_jax``.)
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = True, scale: Optional[float] = None,
                device="cuda") -> dict:
    dev = resolve_device(device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator) * scale
    p = {"w": w.to(dev)}
    if bias:
        p["b"] = torch.zeros(d_out, device=dev)
    return p


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
