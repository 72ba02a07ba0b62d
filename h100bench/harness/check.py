"""The numbers that decide ``correct`` for a training cell.

Both sides start from the same parameters and the same inputs and take
the same first steps.  Each side hands over, per step, its loss; per leaf
(in one fixed order), the first step's gradient as the optimizer got it
(after the clip); and per leaf the parameters' change over the steps.
Three numbers compare them:

``loss_gap``
    the largest relative gap between the two sides' loss at any step;
``grad_gap``
    by the worst leaf, the gap between the two sides' norms of the first
    gradient, over the reference's norm of that leaf or of the median
    leaf, whichever is larger;
``change_gap``
    the same of the parameters' change, leaving out every leaf whose
    reference gradient is under a thousandth of the median leaf's (such
    a leaf moves under Adam by round-off alone);
``grad_entry_gap``
    by the worst leaf, the median over the leaf's entries of the two
    sides' gap in the first gradient, over the median of the reference's
    entries' magnitudes.  A pre-activation that rounding puts on the
    other side of a ReLU's kink changes a few rows of a gradient by far
    more than rounding, and Adam's first step, the gradient's sign times
    the rate, carries that into every later step and every number above;
    the median entry sees only its shift of the clip's scale, while a
    lower precision moves every entry.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's has a gradient of nought to rounding: its change is not compared
QUIET_LEAF = 1e-3


def _norms(leaves: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def _worst_gap(prog: List[float], ref: List[float], keep: List[bool]
               ) -> float:
    floor = statistics.median(ref)
    worst = 0.0
    for p, r, k in zip(prog, ref, keep):
        if not k:
            continue
        den = max(r, floor)
        gap = abs(p - r) / den if den > 0 else (0.0 if p == r else math.inf)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def _entry_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    diff = float((p.double() - r.double()).abs().median())
    scale = float(r.double().abs().median())
    gap = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
    return gap if math.isfinite(gap) else math.inf


def _worst_entry_gap(prog: Sequence[torch.Tensor],
                     ref: Sequence[torch.Tensor]) -> float:
    return max((_entry_gap(p, r) for p, r in zip(prog, ref)), default=0.0)


def training_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"losses": [float], "grad": [leaf],
    "change": [leaf]}`` with the leaves in one order."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides took different numbers of steps")
    loss_gap = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        gap = abs(p - r) / abs(r) if r else abs(p)
        loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
    g_p, g_r = _norms(prog["grad"]), _norms(ref["grad"])
    c_p, c_r = _norms(prog["change"]), _norms(ref["change"])
    floor = statistics.median(g_r)
    moving = [g >= QUIET_LEAF * floor for g in g_r]
    out = {"loss_gap": loss_gap,
           "grad_gap": _worst_gap(g_p, g_r, [True] * len(g_r)),
           "change_gap": _worst_gap(c_p, c_r, moving),
           "grad_entry_gap": _worst_entry_gap(prog["grad"], ref["grad"])}
    return out
