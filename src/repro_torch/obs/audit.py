"""The part of the cost-model audit the whole-forward DP reads (a copy of
``repro/obs/audit.py``'s class keys and calibration loading).

A calibration table holds, per candidate class ``(backend, bm, compact,
order[, buckets])``, the median ratio of measured microseconds to the cold
model's byte-equivalents; ``exec.forward.build_cost_oracle`` rescales cold
candidates with it.  Tables live in ``calibration.json`` next to the
autotune cache (``$REPRO_TORCH_EXEC_CACHE`` or
``~/.cache/repro_torch/exec``), keyed by device signature.  Writing a table
(the audit CLI, ``compute_calibration``) is not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

SCHEMA_CALIBRATION = "repro.obs/calibration@1"


def class_key(backend: str, bm: int, compact: bool, order: str = "-",
              buckets: str = "") -> str:
    """Calibration-class key ``(backend, bm, compact, order[, buckets])``;
    graph-level trials carry no order (``"-"``), ``fuse`` is folded out and
    the empty bucket signature adds nothing."""
    base = f"{backend}|bm{int(bm)}|c{int(bool(compact))}|{order}"
    return f"{base}|{buckets}" if buckets else base


def cand_class(cand: Sequence) -> str:
    """Class key of a layer candidate ``(order, fuse, backend, bm,
    compact[, buckets])`` or a graph candidate ``(backend, bm,
    compact[, buckets])``."""
    if len(cand) in (5, 6):
        order, _fuse, backend, bm, compact = cand[:5]
        buckets = str(cand[5]) if len(cand) == 6 else ""
        return class_key(backend, bm, compact, str(order), buckets)
    backend, bm, compact = cand[:3]
    buckets = str(cand[3]) if len(cand) == 4 else ""
    return class_key(backend, bm, compact, buckets=buckets)


def calibration_path(cache_dir: Optional[str] = None) -> str:
    """Same root-resolution rule as the autotune cache itself."""
    root = cache_dir or os.environ.get(
        "REPRO_TORCH_EXEC_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "exec"))
    return os.path.join(root, "calibration.json")


def load_calibration(sig: str,
                     cache_dir: Optional[str] = None) -> Optional[dict]:
    """This device's calibration table, or None when never audited."""
    try:
        with open(calibration_path(cache_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    t = doc.get(sig) if isinstance(doc, dict) else None
    return t if isinstance(t, dict) else None


def class_ratios(table: Optional[dict]) -> Dict[str, float]:
    """``class_key -> measured/model ratio`` map from a calibration table
    (also accepts a bare ratio map, for tests and explicit overrides)."""
    if not table:
        return {}
    classes = table.get("classes", table)
    if not isinstance(classes, dict):
        return {}
    out = {}
    for ckey, v in classes.items():
        try:
            if isinstance(v, dict):
                if "ratio" in v:
                    out[str(ckey)] = float(v["ratio"])
            elif isinstance(v, (int, float)):
                out[str(ckey)] = float(v)
        except (TypeError, ValueError):
            continue    # one garbled row must not poison the whole table
    return out
