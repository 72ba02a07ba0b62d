"""Carry parameters over from the JAX reference, so both sides compute with
the same weights.

The reference and the port draw their random numbers from different
generators; a parity test (or a user moving a trained model over) converts
the reference's parameter tree to numpy and hands it here.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree, device="cuda"):
    """Any nested dict / list / tuple tree of numpy (or array-like) leaves
    -> the same tree (tuples stay tuples) of float32 tensors on ``device``,
    bfloat16 leaves as bfloat16: GCN's and GraphSAGE's ``{"layers":
    [{"w", "b"}, ...]}`` (a SAGE layer's ``w`` is the concat form's (2 d_in,
    d_out): self half on top, neighbor half below), GIN's
    ``convs[i].mlp[j].{w, b}`` with its 0-d ``eps``, ``lin1`` and ``lin2``,
    GAT's ``layers[i].{w: {w}, a_src, a_dst}``, PNA's ``layers[i].{pre,
    post}`` and ``head``, NequIP's ``embed``, ``layers[i].{radial: [mlp],
    self0, self1, self2, gate}`` and ``readout``, an LM's stacked
    ``dense_layers`` and its KV caches ``{"dense": (k, v)}``."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        a = np.asarray(t)
        out = torch.tensor(a.astype(np.float32), device=dev)
        return out.to(torch.bfloat16) if a.dtype.name == "bfloat16" else out
    return walk(tree)
