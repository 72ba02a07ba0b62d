"""Noise-aware performance-regression sentinel over BENCH documents (the
port of ``repro/obs/regress.py``, numpy only).

Benchmark timings on shared CI hosts are noisy; a naive ``current/baseline >
1.1 -> fail`` gate either cries wolf on every jittery run or gets its
threshold cranked until it misses real regressions.  This module handles
timer noise honestly:

* benchmark rows carry raw per-rep **samples** (``benchmarks/common.py``
  attaches them; the median alone throws the noise information away);
* the comparator bootstraps a **confidence interval on the ratio of
  medians** (resample both sides, take ``median(cur)/median(base)``);
* a row only FAILS when the *entire* interval sits above the threshold —
  a confident regression.  A point-ratio above threshold whose interval
  still straddles it is a WARN: plausibly noise, never a gate failure.
  Rows without samples (or with too few) can also only WARN.

A trajectory row (``append``) is one summary line of a BENCH document in
``BENCH_trajectory.jsonl`` — the long-term perf trajectory.  The port's
rows carry the provenance's ``backend`` (``cuda`` or ``cpu``) where the
reference's carry ``jax_backend``; ``show`` reads either.

CLI::

    python -m repro_torch.obs.regress compare BASELINE.json CURRENT.json
    python -m repro_torch.obs.regress compare BASE.json CUR.json --warn-only
    python -m repro_torch.obs.regress append BENCH.json [--trajectory PATH]
    python -m repro_torch.obs.regress show BENCH_trajectory.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCHEMA_TRAJECTORY = "repro.obs/trajectory@1"

DEFAULT_THRESHOLD = 1.25      # confident-regression gate on the us ratio
DEFAULT_BOOT = 1000
MIN_SAMPLES = 3               # fewer raw samples than this -> WARN at most

# keys that identify a row rather than measure it
_ID_KEYS = ("name", "dataset", "graph", "backend", "mode", "order",
            "schedule", "kind", "variant")
# the timing field the gate watches, in preference order ("us_per_call" is
# what the reference's benchmarks/common.py stamps on every row)
_TIME_KEYS = ("us_per_call", "us", "ms", "mean_ms", "median_ms", "time_ms",
              "time_us", "seconds", "s")


def row_id(rec: dict) -> str:
    """Stable identity of a benchmark row across runs."""
    parts = [f"{k}={rec[k]}" for k in _ID_KEYS if k in rec]
    return "|".join(parts) if parts else json.dumps(rec, sort_keys=True)[:80]


def row_time(rec: dict) -> Tuple[Optional[float], Optional[str]]:
    """The row's primary timing value + which field supplied it."""
    for k in _TIME_KEYS:
        v = rec.get(k)
        if isinstance(v, (int, float)) and v > 0:
            return float(v), k
    return None, None


def row_samples(rec: dict) -> Optional[np.ndarray]:
    s = rec.get("samples")
    if isinstance(s, (list, tuple)) and len(s) >= 2:
        a = np.asarray(s, float)
        if np.all(a > 0):
            return a
    return None


# ---------------------------------------------------------------------------
# the statistics
# ---------------------------------------------------------------------------
def bootstrap_ratio(base: Sequence[float], cur: Sequence[float], *,
                    n_boot: int = DEFAULT_BOOT, seed: int = 0,
                    conf: float = 0.95) -> Tuple[float, float, float]:
    """``(ratio, ci_lo, ci_hi)`` for ``median(cur) / median(base)``,
    bootstrap-resampling both sides.  Deterministic under ``seed`` so the
    gate's verdict is reproducible from the same two documents."""
    base = np.asarray(base, float)
    cur = np.asarray(cur, float)
    ratio = float(np.median(cur) / np.median(base))
    rng = np.random.default_rng(seed)
    rb = np.median(rng.choice(base, (n_boot, base.size)), axis=1)
    rc = np.median(rng.choice(cur, (n_boot, cur.size)), axis=1)
    r = rc / np.maximum(rb, 1e-30)
    alpha = (1.0 - conf) / 2.0
    return (ratio, float(np.quantile(r, alpha)),
            float(np.quantile(r, 1.0 - alpha)))


@dataclasses.dataclass
class Comparison:
    """One row's verdict.  ``ci_lo``/``ci_hi`` are None when either side
    lacks raw samples (point-ratio comparison only — never gate-failing)."""
    id: str
    verdict: str                    # REGRESSION WARN OK IMPROVED NEW REMOVED
    ratio: Optional[float] = None
    ci_lo: Optional[float] = None
    ci_hi: Optional[float] = None
    base_us: Optional[float] = None
    cur_us: Optional[float] = None
    detail: str = ""


def compare_rows(base: dict, cur: dict, *,
                 threshold: float = DEFAULT_THRESHOLD,
                 n_boot: int = DEFAULT_BOOT, seed: int = 0,
                 min_samples: int = MIN_SAMPLES) -> Comparison:
    rid = row_id(cur)
    b_t, b_k = row_time(base)
    c_t, c_k = row_time(cur)
    if b_t is None or c_t is None or b_k != c_k:
        return Comparison(id=rid, verdict="OK",
                          detail="no comparable timing field")
    bs, cs = row_samples(base), row_samples(cur)
    if bs is not None and cs is not None and min(bs.size, cs.size) \
            >= min_samples:
        ratio, lo, hi = bootstrap_ratio(bs, cs, n_boot=n_boot, seed=seed)
        if lo > threshold:
            v = "REGRESSION"
            d = (f"confident: CI [{lo:.2f}, {hi:.2f}] entirely above "
                 f"{threshold:.2f}")
        elif hi < 1.0:
            v = "IMPROVED"
            d = f"CI [{lo:.2f}, {hi:.2f}] entirely below 1.0"
        elif ratio > threshold:
            v = "WARN"
            d = (f"point ratio {ratio:.2f} above {threshold:.2f} but CI "
                 f"[{lo:.2f}, {hi:.2f}] straddles it — plausibly noise")
        else:
            v, d = "OK", ""
        return Comparison(id=rid, verdict=v, ratio=ratio, ci_lo=lo,
                          ci_hi=hi, base_us=float(np.median(bs)),
                          cur_us=float(np.median(cs)), detail=d)
    # medians only: noise is unquantifiable, so never a confident failure
    ratio = c_t / b_t
    if ratio > threshold:
        v = "WARN"
        d = (f"point ratio {ratio:.2f} above {threshold:.2f} but no raw "
             "samples to bound noise")
    elif ratio < 1.0 / threshold:
        v, d = "IMPROVED", ""
    else:
        v, d = "OK", ""
    return Comparison(id=rid, verdict=v, ratio=ratio, base_us=b_t,
                      cur_us=c_t, detail=d)


def compare_docs(base_doc: dict, cur_doc: dict, *,
                 threshold: float = DEFAULT_THRESHOLD,
                 n_boot: int = DEFAULT_BOOT,
                 seed: int = 0,
                 min_samples: int = MIN_SAMPLES) -> List[Comparison]:
    """Join two BENCH documents by row identity and compare every pair."""
    base_rows = {row_id(r): r for r in base_doc.get("results", [])
                 if isinstance(r, dict)}
    cur_rows = {row_id(r): r for r in cur_doc.get("results", [])
                if isinstance(r, dict)}
    out: List[Comparison] = []
    for rid, cur in cur_rows.items():
        b = base_rows.get(rid)
        if b is None:
            out.append(Comparison(id=rid, verdict="NEW"))
        else:
            out.append(compare_rows(b, cur, threshold=threshold,
                                    n_boot=n_boot, seed=seed,
                                    min_samples=min_samples))
    for rid in base_rows:
        if rid not in cur_rows:
            out.append(Comparison(id=rid, verdict="REMOVED"))
    order = {"REGRESSION": 0, "WARN": 1, "REMOVED": 2, "NEW": 3,
             "IMPROVED": 4, "OK": 5}
    out.sort(key=lambda c: (order.get(c.verdict, 9), c.id))
    return out


# ---------------------------------------------------------------------------
# the trajectory
# ---------------------------------------------------------------------------
def trajectory_row(doc: dict, path: str = "") -> dict:
    """One JSONL summary row for a BENCH document: provenance + per-row
    medians, small enough to append forever."""
    prov = doc.get("provenance", {}) if isinstance(doc, dict) else {}
    rows = {}
    for rec in doc.get("results", []):
        if not isinstance(rec, dict):
            continue
        t, k = row_time(rec)
        if t is not None:
            entry = {"us" if k in ("us", "time_us") else k: t}
            s = row_samples(rec)
            if s is not None:
                entry["n_samples"] = int(s.size)
            rows[row_id(rec)] = entry
    return {
        "schema": SCHEMA_TRAJECTORY,
        "_ts": time.time(),
        "bench": doc.get("bench", os.path.basename(path) or "unknown"),
        "git_sha": prov.get("git_sha"),
        "backend": prov.get("backend"),
        "device_kind": prov.get("device_kind"),
        "n_rows": len(rows),
        "rows": rows,
    }


def append_trajectory(doc: dict, path: str, src_path: str = "") -> dict:
    row = trajectory_row(doc, src_path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row, sort_keys=True) + "\n")
    return row


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def render_comparisons(comps: Sequence[Comparison],
                       threshold: float) -> str:
    lines = []
    counts: Dict[str, int] = {}
    for c in comps:
        counts[c.verdict] = counts.get(c.verdict, 0) + 1
    for c in comps:
        if c.ratio is None:
            lines.append(f"  {c.verdict:<10} {c.id}")
            continue
        ci = (f"  CI[{c.ci_lo:.2f},{c.ci_hi:.2f}]"
              if c.ci_lo is not None else "  (no samples)")
        lines.append(f"  {c.verdict:<10} {c.id}  "
                     f"{c.base_us:.1f} -> {c.cur_us:.1f}  "
                     f"x{c.ratio:.2f}{ci}"
                     + (f"  {c.detail}" if c.detail else ""))
    lines.append("")
    lines.append("verdicts: " + "  ".join(f"{v}={n}" for v, n in
                                          sorted(counts.items())))
    lines.append(f"gate: fail only when the bootstrap CI sits entirely "
                 f"above {threshold:.2f}x")
    return "\n".join(lines)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Noise-aware benchmark comparator + trajectory store.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    cmp_p = sub.add_parser("compare",
                           help="gate CURRENT against BASELINE")
    cmp_p.add_argument("baseline")
    cmp_p.add_argument("current")
    cmp_p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    cmp_p.add_argument("--boot", type=int, default=DEFAULT_BOOT)
    cmp_p.add_argument("--seed", type=int, default=0)
    cmp_p.add_argument("--min-samples", type=int, default=MIN_SAMPLES)
    cmp_p.add_argument("--warn-only", action="store_true",
                       help="report but never exit non-zero (CPU CI hosts)")

    app_p = sub.add_parser("append",
                           help="append a BENCH document to the trajectory")
    app_p.add_argument("bench")
    app_p.add_argument("--trajectory", default="BENCH_trajectory.jsonl")

    show_p = sub.add_parser("show", help="render a trajectory JSONL")
    show_p.add_argument("trajectory")
    show_p.add_argument("--last", type=int, default=10)

    args = ap.parse_args(argv)

    if args.cmd == "compare":
        try:
            base, cur = _load(args.baseline), _load(args.current)
        except (OSError, ValueError) as e:
            print(f"unreadable input: {e}", file=sys.stderr)
            return 2
        comps = compare_docs(base, cur, threshold=args.threshold,
                             n_boot=args.boot, seed=args.seed,
                             min_samples=args.min_samples)
        print(f"regression gate — {args.current} vs {args.baseline} "
              f"(threshold {args.threshold:.2f}x)")
        print(render_comparisons(comps, args.threshold))
        n_reg = sum(c.verdict == "REGRESSION" for c in comps)
        if n_reg and not args.warn_only:
            print(f"\nFAIL: {n_reg} confident regression(s)")
            return 1
        if n_reg:
            print(f"\nWARN-ONLY: {n_reg} confident regression(s) reported, "
                  "exit suppressed")
        return 0

    if args.cmd == "append":
        try:
            doc = _load(args.bench)
        except (OSError, ValueError) as e:
            print(f"unreadable input: {e}", file=sys.stderr)
            return 2
        row = append_trajectory(doc, args.trajectory, args.bench)
        print(f"appended {row['bench']} ({row['n_rows']} rows, "
              f"sha={row.get('git_sha')}) to {args.trajectory}")
        return 0

    if args.cmd == "show":
        try:
            with open(args.trajectory) as f:
                rows = [json.loads(ln) for ln in f if ln.strip()]
        except (OSError, ValueError) as e:
            print(f"unreadable trajectory: {e}", file=sys.stderr)
            return 2
        print(f"{args.trajectory}: {len(rows)} run(s)")
        for r in rows[-args.last:]:
            ts = time.strftime("%Y-%m-%d %H:%M",
                               time.localtime(r.get("_ts", 0)))
            print(f"  {ts}  {r.get('bench', '?'):<24} "
                  f"sha={str(r.get('git_sha'))[:10]:<12} "
                  f"backend={r.get('backend', r.get('jax_backend'))}  "
                  f"rows={r.get('n_rows')}")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
