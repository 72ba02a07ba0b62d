"""Generic training loop — port of ``repro/train/loop.py``.

The loop is model-agnostic: the caller supplies ``loss_fn(params, batch)``
and the optimizer.  A step runs eagerly: the loss, ``loss.backward()``
through the plans' hand-written backwards, the global-norm clip and the
optimizer update, all on the parameters' device.  The same obs spans,
histogram, counters and gauges as the reference are kept.  Checkpoints
(``ckpt_dir``) and the chaos fail point are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import torch

from .. import obs
from .fault import StepWatchdog
from .optimizer import Optimizer, apply_updates, clip_by_global_norm, tree_map


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    losses: list
    steps: int
    straggler_flags: int
    wall_time: float


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    clip_norm: Optional[float] = 1.0):
    """Returns ``(params, opt_state, batch) -> (params, opt_state, loss)``;
    the returned params are new leaf tensors, the loss a detached 0-d
    tensor on the device."""

    def step(params, opt_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(params, batch)
        loss.backward()
        with torch.no_grad():
            grads = tree_map(lambda p: (p.grad if p.grad is not None
                                        else torch.zeros_like(p)), params)
            if clip_norm:
                grads, _ = clip_by_global_norm(grads, clip_norm)
            params = tree_map(lambda p: p.detach(), params)
            updates, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, loss.detach()

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
    if ckpt_dir:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP "
                                  "§1 item 6, resilience)")
    opt_state = opt.init(params)
    step_fn = make_train_step(loss_fn, opt, clip_norm)
    watchdog = StepWatchdog()
    losses = []
    # metric handles held outside the loop: the disabled path per step is
    # one attribute load + branch per call
    step_hist = obs.histogram("train.step_seconds")
    steps_ctr = obs.counter("train.steps")
    loss_gauge = obs.gauge("train.loss")
    rows_gauge = obs.gauge("train.rows_per_s")
    t0 = time.time()
    i = -1
    for i, batch in zip(range(steps), batches):
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
    return TrainResult(params=params, opt_state=opt_state, losses=losses,
                       steps=i + 1, straggler_flags=watchdog.flagged,
                       wall_time=time.time() - t0)
