"""Carry parameters over from the JAX reference, so both sides compute with
the same weights.

The reference and the port draw their random numbers from different
generators; a parity test (or a user moving a trained model over) converts
the reference's parameter tree to numpy and hands it here.  For the mesh
path (``dist.sharding.use_mesh``) :func:`shard_params` / :func:`shard_opt_state`
cut the full trees to the rank's blocks of ``lm_param_specs``, as the
reference's ``jax.device_put`` with ``LMBundle.shardings`` places them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .dist.sharding import (P, NamedSharding, as_mesh, broadcast_specs,
                            lm_param_specs)


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
    ``dense_layers`` (and a MoE config's ``moe_layers``, each with
    ``moe.{router, wg, wu, wd}`` and llama4's ``moe.shared``; llama4's
    bf16 parameters stay bf16) and its KV caches ``{"dense": (k, v)}`` or
    ``{"moe": (k, v), "dense": (k, v)}``."""
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


def _to_tensor(a, dev):
    a = np.asarray(a)
    out = torch.tensor(a.astype(np.float32), device=dev)
    return out.to(torch.bfloat16) if a.dtype.name == "bfloat16" else out


def local_block(a, spec: P, mesh, coords: Optional[Dict[str, int]] = None):
    """The block of the global array ``a`` that the rank at ``coords``
    (axis -> coordinate; this rank's, by default) holds under ``spec``.
    Raises where ``NamedSharding.shard_shape`` raises (a dimension its axes
    do not divide)."""
    sh = NamedSharding(as_mesh(mesh), spec)
    return np.asarray(a)[sh.local_slices(np.shape(a), coords)]


def shard_tree(tree, spec_tree, mesh, device="cuda",
               coords: Optional[Dict[str, int]] = None):
    """A tree of numpy arrays -> the rank's blocks under ``spec_tree`` (a
    single P standing for a whole sub-tree, as ``lm_param_specs`` writes
    them), as tensors on ``device`` (bf16 leaves stay bf16)."""
    dev = resolve_device(device)
    specs = broadcast_specs(spec_tree, tree)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, x) for v, x in zip(t, s))
        return _to_tensor(local_block(t, s, mesh, coords), dev)
    return walk(tree, specs)


def _whole_stacks(specs):
    """``lm_param_specs`` with each layer stack held whole (its ZeRO entry
    replaced by None)."""
    out = dict(specs)
    for key in ("dense_layers", "moe_layers"):
        if key in out:
            out[key] = _map_p(lambda s: P(None, *s[1:]), out[key])
    return out


def _map_p(fn, t):
    if isinstance(t, P):
        return fn(t)
    return {k: _map_p(fn, v) for k, v in t.items()}


def param_specs(cfg, mesh, zero: bool = True):
    """``lm_param_specs``, or with ``zero=False`` the same layout with every
    layer stack held whole on the batch axes (the one the mesh path takes
    where a stack's depth does not divide them: the reference's ZeRO entry
    would raise there)."""
    specs = lm_param_specs(cfg, mesh)
    return specs if zero else _whole_stacks(specs)


def shard_params(params, cfg, mesh, device="cuda", zero: bool = True,
                 coords: Optional[Dict[str, int]] = None):
    """The reference's full LM parameter tree (numpy) -> the rank's blocks
    of ``lm_param_specs(cfg, mesh)``: the layer stacks' ZeRO shard over the
    batch axes (``zero=False``: held whole), the model-axis cuts."""
    return shard_tree(params, param_specs(cfg, mesh, zero), mesh, device,
                      coords)


def shard_opt_state(state, cfg, mesh, device="cuda", zero: bool = True,
                    coords: Optional[Dict[str, int]] = None):
    """Adam's state ``{"m", "v", "step"}`` (numpy) -> the rank's blocks:
    ``m`` and ``v`` as the parameters, ``step`` whole (int32)."""
    specs = param_specs(cfg, mesh, zero)
    dev = resolve_device(device)
    return {"m": shard_tree(state["m"], specs, mesh, device, coords),
            "v": shard_tree(state["v"], specs, mesh, device, coords),
            "step": torch.tensor(np.asarray(state["step"]),
                                 dtype=torch.int32, device=dev)}
