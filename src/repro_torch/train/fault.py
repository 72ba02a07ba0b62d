"""The training loop's straggler flag and the batch seed — the
``StepWatchdog`` and ``deterministic_batch_seed`` of
``repro/train/fault.py``.  Checkpoint resume and the elastic mesh are not
ported yet."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque

import numpy as np

from .. import obs


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


def deterministic_batch_seed(base_seed: int, step: int, shard: int) -> int:
    """Any worker can regenerate any shard's batch for any step."""
    return (base_seed * 1_000_003 + step) * 65_537 + shard
