"""Generic training loop — port of ``repro/train/loop.py``.

The loop is model-agnostic: the caller supplies ``loss_fn(params, batch)``
and the optimizer.  A step runs eagerly: the loss, its gradients (through
the plans' hand-written backwards where a model has them), the global-norm
clip and the optimizer update, all on the parameters' device.  ``fit``
resumes from the latest checkpoint in ``ckpt_dir``, writes checkpoints
through an :class:`AsyncCheckpointer`, and passes the ``train.step`` chaos
fail point before every step.  The same obs spans, histogram, counters and
gauges as the reference are kept.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import torch

from .. import obs
from ..chaos import inject as chaos
from .checkpoint import AsyncCheckpointer
from .fault import StepWatchdog, resume
from .optimizer import (Optimizer, apply_updates, clip_by_global_norm,
                        clip_by_global_norm_, tree_leaves, tree_unflatten)


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    losses: list
    steps: int
    straggler_flags: int
    wall_time: float


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    clip_norm: Optional[float] = 1.0, donate: bool = True):
    """Returns ``(params, opt_state, batch) -> (params, opt_state, loss)``,
    the loss a detached 0-d tensor on the device.

    ``donate=True`` (the reference's default, where jit donates params and
    optimizer state): the caller's parameter and state tensors are consumed
    and updated **in place** — the clip scales the gradients in place, then
    the optimizer's ``update_`` runs one leaf at a time — and the same trees
    are returned.  The peak is then the parameters, their gradients, the
    state and one leaf of transients; a caller that still needs the old
    values passes ``donate=False``, which returns new trees (the functional
    form) and leaves its arguments as they were."""
    if donate and opt.update_ is None:
        raise ValueError("this optimizer has no in-place form; pass "
                         "donate=False")

    def grads_of(params, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(live, grads)]

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            if donate:
                if clip_norm:
                    clip_by_global_norm_(grads, clip_norm)
                opt.update_(grads, opt_state, params)
                return params, opt_state, loss
            grads = tree_unflatten(params, grads)
            if clip_norm:
                grads, _ = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, loss

    return step


def _batch_rows(batch) -> int:
    """Leading-dim row count of a batch (dict of tensors or one tensor) —
    the numerator of the rows/sec gauge; 0 when undeterminable."""
    if isinstance(batch, dict):
        for v in batch.values():
            if hasattr(v, "shape") and len(v.shape) >= 1:
                return int(v.shape[0])
    elif hasattr(batch, "shape") and len(batch.shape) >= 1:
        return int(batch.shape[0])
    return 0


def fit(loss_fn: Callable, opt: Optimizer, params, batches: Iterator,
        steps: int, ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
        log_every: int = 10, clip_norm: Optional[float] = 1.0,
        log: Callable = print) -> TrainResult:
    """Train ``params`` (updated in place: the step is donated) over
    ``batches`` up to step ``steps``.  With ``ckpt_dir``: resume from its
    latest checkpoint (the loop then starts at the step after it, drawing
    from ``batches`` as given), save every ``ckpt_every`` steps and at the
    last step, as the reference does; a failed write raises."""
    opt_state = opt.init(params)
    start = 0
    if ckpt_dir:
        params, opt_state, start = resume(ckpt_dir, params, opt_state)
    step_fn = make_train_step(loss_fn, opt, clip_norm)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    watchdog = StepWatchdog()
    losses = []
    # metric handles held outside the loop: the disabled path per step is
    # one attribute load + branch per call
    step_hist = obs.histogram("train.step_seconds")
    steps_ctr = obs.counter("train.steps")
    loss_gauge = obs.gauge("train.loss")
    rows_gauge = obs.gauge("train.rows_per_s")
    t0 = time.time()
    i = start
    for i, batch in zip(range(start, steps), batches):
        chaos.fail_point("train.step")  # crash-drill injection (no-op unarmed)
        with obs.span("train.step", cat="train", step=i) as sp:
            ts = time.time()
            params, opt_state, loss = step_fn(params, opt_state, batch)
            loss = float(loss)          # waits for the step to finish
            losses.append(loss)
            dt = time.time() - ts
            sp.set(loss=loss)
        step_hist.observe(dt)
        steps_ctr.inc()
        loss_gauge.set(loss)
        if obs.enabled():
            rows = _batch_rows(batch)
            if rows:
                rows_gauge.set(rows / max(dt, 1e-9))
        if watchdog.observe(dt):
            log(f"[straggler] step {i} took {dt:.3f}s (flagged)")
        if log_every and i % log_every == 0:
            log(f"step {i:6d}  loss {loss:.4f}")
        if ckpt and i and i % ckpt_every == 0:
            ckpt.save(i, params, opt_state)
    if ckpt:
        try:
            ckpt.save(i, params, opt_state)
            ckpt.wait()                 # a failed write raises here
        finally:
            ckpt.close()
    return TrainResult(params=params, opt_state=opt_state, losses=losses,
                       steps=i + 1 - start, straggler_flags=watchdog.flagged,
                       wall_time=time.time() - t0)
