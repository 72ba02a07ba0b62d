"""Carry parameters over from the JAX reference, so both sides compute with
the same weights.

The reference and the port draw their random numbers from different
generators; a parity test (or a user moving a trained model over) converts
the reference's parameter tree to numpy and hands it here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree: Mapping, device="cuda") -> dict:
    """``{"layers": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}`` of numpy
    (or array-like) leaves -> the same tree of float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    layers = []
    for i, layer in enumerate(tree["layers"]):
        if "w" not in layer:
            raise KeyError(f"layer {i} has no 'w' (keys: {sorted(layer)})")
        layers.append({k: torch.tensor(np.asarray(v, np.float32), device=dev)
                       for k, v in layer.items()})
    return {"layers": layers}
