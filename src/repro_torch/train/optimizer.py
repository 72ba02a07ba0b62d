"""Optimizers on trees of tensors — port of the ``apply_updates`` /
``global_norm`` / ``clip_by_global_norm`` / ``adam`` part of
``repro/train/optimizer.py``, written as the reference writes them.

A tree is a tensor or a dict, list or tuple of trees (the parameter trees
of ``repro_torch.models``).  Functional API, as in the reference:
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; apply with ``apply_updates``.  Every state lives on the
parameters' device, the step count included, so an update never waits for
the host.  SGD, LAMB and the schedules are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with fp32 moments (the reference's weight decay, learning-rate
    schedule and low-precision moments are not ported yet)."""
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=tree_leaves(params)[0].device)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)
        m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.to(torch.float32),
                     grads, state["m"])
        v = tree_map(lambda g, v: (b2 * v + (1 - b2) * g.to(torch.float32)
                                   * g.to(torch.float32)), grads, state["v"])
        upd = tree_map(lambda m, v: (-lr * (m / bc1)
                                     / (torch.sqrt(v / bc2) + eps)), m, v)
        return upd, {"m": m, "v": v, "step": step}
    return Optimizer(init, update)
