"""Fault tolerance for the training loop — the ``StepWatchdog``,
``resume``, ``elastic_mesh``, ``deterministic_batch_seed`` and
``RetryingStep`` of ``repro/train/fault.py``.

* checkpoint/restart: :func:`resume` restores the latest checkpoint
  (``checkpoint.py`` publishes by atomic rename, so a crash never leaves a
  torn file that shadows a good one, and a corrupt newest file falls back
  to the one before);
* straggler flags: a step-time watchdog, and batches keyed by (seed, step,
  shard) so any worker can regenerate any batch;
* elastic re-mesh: :func:`elastic_mesh` builds the largest mesh that the
  surviving ranks support, shrinking the data axis first;
* bounded retry of a step on a transient device error.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque

import numpy as np
import torch

from .. import obs
from .checkpoint import latest_step, restore_checkpoint


@dataclasses.dataclass
class StepWatchdog:
    """Flags straggling steps: > ``threshold`` x rolling-median step time.

    Every flag counts ``train.straggler_flagged`` in :mod:`repro_torch.obs`.
    """

    threshold: float = 3.0
    window: int = 32
    history: Deque[float] = dataclasses.field(default_factory=deque)
    flagged: int = 0

    def __post_init__(self):
        self.history = deque(self.history, maxlen=self.window)

    def observe(self, seconds: float) -> bool:
        self.history.append(seconds)
        med = float(np.median(self.history))
        slow = len(self.history) >= 8 and seconds > self.threshold * med
        if slow:
            self.flagged += 1
            obs.counter("train.straggler_flagged").inc()
        return slow


def resume(ckpt_dir: str, params_template, opt_template):
    """Restore the latest readable checkpoint if one exists, else return
    the templates: (params, opt_state, the step to start from)."""
    if latest_step(ckpt_dir) is None:
        return params_template, opt_template, 0
    p, o, step = restore_checkpoint(ckpt_dir, params_template, opt_template)
    return p, o, step + 1


def elastic_mesh(preferred_shape, axis_names, min_data: int = 1,
                 device="cuda"):
    """Build the largest mesh <= ``preferred_shape`` that the ranks of the
    initialised process group support, halving the data axis first (model
    sharding is topology-bound, data sharding is elastic).  Returns a
    ``DeviceMesh`` over the first ``prod(shape)`` ranks; raises when even
    ``min_data`` does not fit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("elastic_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    shape = list(preferred_shape)
    data_idx = list(axis_names).index("data")
    while int(np.prod(shape)) > n and shape[data_idx] > min_data:
        shape[data_idx] //= 2
    if int(np.prod(shape)) > n:
        raise RuntimeError(f"not enough devices: need {np.prod(shape)}, "
                           f"have {n}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def deterministic_batch_seed(base_seed: int, step: int, shard: int) -> int:
    """Any worker can regenerate any shard's batch for any step."""
    return (base_seed * 1_000_003 + step) * 65_537 + shard


def _transient(err: RuntimeError) -> bool:
    """A device error worth retrying: ``torch.AcceleratorError`` where torch
    has it (2.8 and later), else a ``RuntimeError`` that names CUDA."""
    kind = getattr(torch, "AcceleratorError", None)
    if kind is not None:
        return isinstance(err, kind)
    return "CUDA" in str(err)


class RetryingStep:
    """Wrap a step with bounded retry on transient device errors.

    Only a transient device error (:func:`_transient`) is retried, after a
    back-off of 0.1 s x 2^attempt; after ``max_retries`` retries it is
    raised, and every other exception propagates at once.  A step that
    updates its parameters in place (``make_train_step(donate=True)``) may
    have applied part of an update before the error: retry the functional
    form (``donate=False``) where a retried step must see the old
    parameters."""

    def __init__(self, fn: Callable, max_retries: int = 2):
        self.fn = fn
        self.max_retries = max_retries
        self.retries = 0

    def __call__(self, *args, **kw):
        for attempt in range(self.max_retries + 1):
            try:
                return self.fn(*args, **kw)
            except RuntimeError as e:
                if not _transient(e) or attempt == self.max_retries:
                    raise
                self.retries += 1
                time.sleep(0.1 * 2 ** attempt)
