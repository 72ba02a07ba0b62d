"""Optimizers on trees of tensors — port of ``repro/train/optimizer.py``
(SGD, Adam/AdamW, LAMB, the cosine warm-up schedule), written as the
reference writes them.

A tree is a tensor or a dict, list or tuple of trees (the parameter trees
of ``repro_torch.models``).  Functional API, as in the reference:
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; apply with ``apply_updates``.  Every state lives on the
parameters' device, the step count included, so an update never waits for
the host.

Each optimizer also has an **in-place** form, ``opt.update_(grads, state,
params)``: the counterpart of the reference's donated step.  It updates
the state's tensors and the parameters in place, one leaf at a time, and
drops each gradient from the ``grads`` list once its leaf is done, so no
transient is larger than one leaf (and a copy of it in fp32).  Both forms
run the same arithmetic per leaf (the functional one on copies of the
state), so on the same gradients they give the same numbers.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    update_: Optional[Callable] = None


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


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled so their global norm (``norm``, or the tree's own)
    is at most ``max_norm``; returns (grads, norm)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def clip_by_global_norm_(grads: list, max_norm: float, norm=None
                         ) -> torch.Tensor:
    """:func:`clip_by_global_norm` scaling the list's gradients in place;
    returns the norm."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (an iterator or a
    sequence, in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def _zeros(params, dtype=None):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                                          device=p.device), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _aligned(tree, *rest) -> list:
    """(leaf, matching leaves of ``rest``) per leaf of ``tree``, in
    ``tree_leaves(tree)`` order; ``rest`` is matched by key, not order."""
    out = []
    tree_map(lambda *leaves: out.append(leaves), tree, *rest)
    return out


def _leaves_(grads: list, params, *trees):
    """(gradient, parameter, leaves of ``trees``) per leaf; ``grads`` is in
    ``tree_leaves(params)`` order, and the list's reference to each
    gradient is dropped as it is handed out."""
    for i, leaves in enumerate(_aligned(params, *trees)):
        g, grads[i] = grads[i], None
        yield (g, *leaves)


def sgd(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params), "step": _step0(params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        upd = tree_map(lambda m: m * -lr, mu)
        return upd, {"mu": mu, "step": state["step"] + 1}

    def update_(grads: list, state, params):
        """``grads`` in ``tree_leaves(params)`` order."""
        for g, p, mu in _leaves_(grads, params, state["mu"]):
            p.add_(mu.mul_(momentum).add_(g) * -lr)
        state["step"].add_(1)
        return state
    return Optimizer(init, update, update_)


def _bias_corrections(step: torch.Tensor, b1: float, b2: float):
    return (1.0 - b1 ** step.to(torch.float32),
            1.0 - b2 ** step.to(torch.float32))


def _moment_(buf: torch.Tensor, beta: float, g32: torch.Tensor,
             square: bool) -> torch.Tensor:
    """buf = beta * buf + (1 - beta) * (g32² if square else g32), in fp32,
    stored in place in buf's dtype; returns the stored moment in fp32
    (buf itself when it is fp32)."""
    b32 = (buf if buf.dtype == torch.float32
           else buf.to(torch.float32)).mul_(beta)
    if square:
        b32.addcmul_(g32, g32, value=1 - beta)
    else:
        b32.add_(g32, alpha=1 - beta)
    if b32 is not buf:
        buf.copy_(b32)
        b32.copy_(buf)
    return b32


def _adam_leaf_(g, m, v, b1, b2, eps, bc1, bc2, lr) -> torch.Tensor:
    """One leaf's moments m and v updated in place; returns a new fp32
    tensor, the leaf's update -lr (m / bc1) / (sqrt(v / bc2) + eps).  Both
    forms of :func:`adam` and :func:`lamb` run it (the functional form on
    copies of the moments), so the two give the same numbers."""
    g32 = g.to(torch.float32)
    m32 = _moment_(m, b1, g32, square=False)
    v32 = _moment_(v, b2, g32, square=True)
    del g32
    u = v32.div(bc2).sqrt_().add_(eps)
    return torch.div(m32, u, out=u).div_(bc1).mul_(-lr)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, lr_schedule: Optional[Callable] = None,
         moments_dtype=torch.float32) -> Optimizer:
    """Adam/AdamW: the moments are computed in fp32 and stored in
    ``moments_dtype`` (bf16 halves their memory); weight decay is applied
    as ``u -= lr * wd * p``; ``lr_schedule(step)`` scales ``lr``."""
    def init(params):
        return {"m": _zeros(params, moments_dtype),
                "v": _zeros(params, moments_dtype), "step": _step0(params)}

    def scalars(step):
        cur_lr = lr_schedule(step) * lr if lr_schedule else lr
        return (cur_lr, *_bias_corrections(step, b1, b2))

    def leaf_(g, m, v, p, cur_lr, bc1, bc2):
        u = _adam_leaf_(g, m, v, b1, b2, eps, bc1, bc2, cur_lr)
        if weight_decay:
            u.sub_(p.to(torch.float32).mul(cur_lr * weight_decay))
        return u

    def update(grads, state, params=None):
        step = state["step"] + 1
        cur_lr, bc1, bc2 = scalars(step)
        us, ms, vs = [], [], []
        for g, m, v, p in _aligned(grads, state["m"], state["v"],
                                   params if params is not None else grads):
            m, v = m.clone(), v.clone()
            us.append(leaf_(g, m, v, p, cur_lr, bc1, bc2))
            ms.append(m)
            vs.append(v)
        return tree_unflatten(grads, us), {
            "m": tree_unflatten(grads, ms), "v": tree_unflatten(grads, vs),
            "step": step}

    def update_(grads: list, state, params):
        """``grads`` in ``tree_leaves(params)`` order."""
        state["step"].add_(1)
        cur_lr, bc1, bc2 = scalars(state["step"])
        for g, p, m, v in _leaves_(grads, params, state["m"], state["v"]):
            p.add_(leaf_(g, m, v, p, cur_lr, bc1, bc2))
            del g
        return state
    return Optimizer(init, update, update_)


def lamb(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """LAMB: layerwise-adaptive Adam for very large batches."""
    base = adam(1.0, b1, b2, eps, 0.0)

    def leaf_(g, m, v, p, bc1, bc2):
        adj = _adam_leaf_(g, m, v, b1, b2, eps, bc1, bc2, 1.0)
        p32 = p.to(torch.float32)
        adj.sub_(p32 * weight_decay)
        pn = torch.linalg.vector_norm(p32)
        un = torch.linalg.vector_norm(adj)
        ratio = torch.where((pn > 0) & (un > 0), pn / un,
                            torch.ones((), device=pn.device))
        return adj.mul_(lr * ratio)

    def update(grads, state, params):
        step = state["step"] + 1
        bc1, bc2 = _bias_corrections(step, b1, b2)
        us, ms, vs = [], [], []
        for g, m, v, p in _aligned(grads, state["m"], state["v"], params):
            m, v = m.clone(), v.clone()
            us.append(leaf_(g, m, v, p, bc1, bc2))
            ms.append(m)
            vs.append(v)
        return tree_unflatten(grads, us), {
            "m": tree_unflatten(grads, ms), "v": tree_unflatten(grads, vs),
            "step": step}

    def update_(grads: list, state, params):
        """``grads`` in ``tree_leaves(params)`` order."""
        state["step"].add_(1)
        bc1, bc2 = _bias_corrections(state["step"], b1, b2)
        for g, p, m, v in _leaves_(grads, params, state["m"], state["v"]):
            p.add_(leaf_(g, m, v, p, bc1, bc2))
            del g
        return state
    return Optimizer(base.init, update, update_)


def cosine_warmup_schedule(warmup: int, total: int, floor: float = 0.1):
    """A linear warm-up to 1 over ``warmup`` steps, then a cosine decay to
    ``floor`` at ``total``; ``step`` is a tensor, the result fp32."""
    def sched(step):
        s = step.to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return sched


OPTIMIZERS = {"sgd": sgd, "adam": adam, "adamw": adam, "lamb": lamb}
