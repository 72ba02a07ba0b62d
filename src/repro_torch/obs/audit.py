"""Cost-model audit: join measured autotune evidence against the cold model
(the port of ``repro/obs/audit.py``).

The exec autotuner *measures* ``(backend, bm, compact, order)`` candidates
on the device; the whole-forward DP *models* cold candidates with a
FLOP/byte cost rescaled into microseconds
(:func:`repro_torch.exec.forward.build_cost_oracle`).  This module turns
the measurements into a **calibration table**:

* per ``(backend, bm, compact, order[, buckets])`` class — the median
  measured/model ratio, sample count, and the relative-error distribution
  of the calibrated prediction (how well ``model * ratio`` explains each
  measurement);
* per trial *group* (one graph x shape x mode) — the Spearman rank
  correlation between modeled and measured candidate ordering.  The DP only
  needs the model to *rank* correctly, so rank quality IS fit quality;
* a **drift report** — candidate pairs the model misranks decisively,
  forward-race verdicts where the DP schedule lost to per-layer greedy, and
  BENCH-document rows whose structured fields already record a misrank.

Evidence sources (any mix): the autotune disk cache (every entry carries
its graph geometry and ``device_sig``, so each stored table row can be
re-modeled offline), a Perfetto trace (``exec.autotune.trial`` spans carry
``us`` + ``model_cost``; ``exec.forward.verdict`` instants feed the drift
report), a ``BENCH_*.json`` document.

Tables persist next to the autotune cache (``calibration.json`` under
``$REPRO_TORCH_EXEC_CACHE`` or ``~/.cache/repro_torch/exec``), keyed by
``device_sig`` — on the card ``cuda-<torch.cuda.get_device_name>``, e.g.
``cuda-NVIDIA-H100-80GB-HBM3`` — and the cold DP and the tuner's pruning
read the per-class ratios from there.

CLI (``--device`` picks whose cache entries are audited; the port's
``device_sig()`` answers ``"cuda"`` even without a card, so a CPU audit
must say ``--device cpu``)::

    python -m repro_torch.obs.audit                  # the card's cache rows
    python -m repro_torch.obs.audit --device cpu     # the CPU's
    python -m repro_torch.obs.audit TRACE.json BENCH.json [--cache-dir DIR]
    python -m repro_torch.obs.audit --no-write --tol 1.5
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCHEMA_CALIBRATION = "repro.obs/calibration@1"

# a measured/model pair must beat the model's pick by this factor before the
# drift report calls it a misrank (timer noise must not page an operator)
DEFAULT_TOL = 1.25

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (the report's roofline line)
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------------------
# candidate classes
# ---------------------------------------------------------------------------
def class_key(backend: str, bm: int, compact: bool, order: str = "-",
              buckets: str = "") -> str:
    """Calibration-class key: ``(backend, bm, compact, order[, buckets])``.
    Graph-level (aggregation-only) trials carry no order and use ``"-"``;
    ``fuse`` is folded out — the fusion credit already lives in the model
    itself.  Degree-bucketed candidates append their bucket signature, so
    bucketed and monolithic launches calibrate as distinct classes; the
    empty signature adds nothing and keeps pre-bucketing keys byte-stable."""
    base = f"{backend}|bm{int(bm)}|c{int(bool(compact))}|{order}"
    return f"{base}|{buckets}" if buckets else base


def cand_class(cand: Sequence) -> str:
    """Class key of a layer candidate ``(order, fuse, backend, bm, compact)``
    or a graph candidate ``(backend, bm, compact)``; bucketed variants of
    either append a bucket-signature string as the final element.  (The
    split is inlined: ``exec`` imports ``obs``.)"""
    if len(cand) in (5, 6):
        order, _fuse, backend, bm, compact = cand[:5]
        buckets = str(cand[5]) if len(cand) == 6 else ""
        return class_key(backend, bm, compact, str(order), buckets)
    backend, bm, compact = cand[:3]
    buckets = str(cand[3]) if len(cand) == 4 else ""
    return class_key(backend, bm, compact, buckets=buckets)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One joined (measured, modeled) pair for a candidate in a group."""
    group: str          # rank-correlation pool: one graph x shape x mode
    ckey: str           # calibration class (class_key)
    label: str          # human-readable candidate
    us: float           # measured fwd+bwd microseconds
    model: float        # cold-model cost, byte-equivalents
    source: str         # "cache" | "trace"


# ---------------------------------------------------------------------------
# evidence: the autotune disk cache
# ---------------------------------------------------------------------------
def observations_from_cache(cache_dir: Optional[str] = None,
                            sig: Optional[str] = None) -> List[Observation]:
    """Re-model every stored autotune table row whose entry carries graph
    geometry (entries written before the audit era are skipped — they can't
    be re-modeled).  Only entries measured under ``sig`` (default:
    ``device_sig("cuda")``, the card's) are joined."""
    import importlib      # lazy: exec imports obs
    # (attribute access would hit repro_torch.exec's autotune FUNCTION, not
    # the module, so resolve the submodule by name)
    _at = importlib.import_module("repro_torch.exec.autotune")
    if sig is None:
        sig = _at.device_sig()
    entries = _at._cache_load(_at._cache_path(cache_dir))
    out: List[Observation] = []
    for key, e in entries.items():
        if not isinstance(e, dict) or e.get("device_sig") != sig:
            continue
        n, ee = e.get("n"), e.get("e")
        if not n or ee is None:
            continue
        for row in e.get("table", ()):
            try:
                if len(row) in (6, 7):          # layer trial [+bucket sig]
                    order, fuse, backend, bm, compact = row[:5]
                    bsig = str(row[5]) if len(row) == 7 else ""
                    us = row[-1]
                    cand = ((str(order), bool(fuse), str(backend), int(bm),
                             bool(compact)) + ((bsig,) if bsig else ()))
                    model = _at.model_layer_cost_dims(
                        n, ee, e["d_in"], e["d_out"], cand)
                    ckey = cand_class(cand)
                    label = (f"{order}{'+fuse' if fuse else ''} {backend} "
                             f"bm={bm} compact={compact}"
                             + (f" buckets={bsig}" if bsig else ""))
                elif len(row) in (4, 5):        # graph trial [+bucket sig]
                    backend, bm, compact = row[:3]
                    bsig = str(row[3]) if len(row) == 5 else ""
                    us = row[-1]
                    model = _at.model_graph_cost(n, ee, e["d"])
                    ckey = class_key(backend, int(bm), bool(compact),
                                     buckets=bsig)
                    label = (f"{backend} bm={bm} compact={compact}"
                             + (f" buckets={bsig}" if bsig else ""))
                else:
                    continue
            except (KeyError, TypeError, ValueError):
                continue
            if us > 0 and model > 0:
                out.append(Observation(group=key.rsplit(":", 1)[0],
                                       ckey=ckey, label=label,
                                       us=float(us), model=float(model),
                                       source="cache"))
    return out


# ---------------------------------------------------------------------------
# evidence: a Perfetto trace
# ---------------------------------------------------------------------------
def _trace_events(doc) -> list:
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict):
        ev = doc.get("traceEvents")
        return ev if isinstance(ev, list) else []
    return []


def observations_from_trace(doc) -> List[Observation]:
    """Join ``exec.autotune.trial`` spans: each carries the measured ``us``
    and the ``model_cost`` the tuner computed at trial time."""
    out: List[Observation] = []
    for ev in _trace_events(doc):
        if not (isinstance(ev, dict) and ev.get("ph") == "X"
                and ev.get("name") == "exec.autotune.trial"):
            continue
        a = ev.get("args") or {}
        us, model = a.get("us"), a.get("model_cost")
        if a.get("failed") or us is None or model is None:
            continue
        if not (us > 0 and model > 0):
            continue
        order = str(a.get("order", "-"))
        shape = (f"{a['d_in']}x{a['d_out']}" if "d_in" in a
                 else f"d{a.get('d')}")
        group = (f"trace:{a.get('n')}n:{a.get('e')}e:{shape}"
                 f":{a.get('mode')}")
        fuse = bool(a.get("fuse", False))
        bsig = str(a.get("buckets", "") or "")
        out.append(Observation(
            group=group,
            ckey=class_key(a.get("backend", "?"), int(a.get("bm", 0)),
                           bool(a.get("compact", False)),
                           order if "order" in a else "-", bsig),
            label=(f"{order}{'+fuse' if fuse else ''} {a.get('backend')} "
                   f"bm={a.get('bm')} compact={a.get('compact')}"
                   + (f" buckets={bsig}" if bsig else "")),
            us=float(us), model=float(model), source="trace"))
    return out


def trace_device_sig(doc) -> Optional[str]:
    """Device signature from the trace's provenance header (the port's
    ``backend`` + ``device_kind``), using the same collapse rule as
    :func:`repro_torch.exec.autotune.device_sig`: a ``cuda`` run's trace
    gives exactly ``device_sig("cuda")`` on that card."""
    other = doc.get("otherData") if isinstance(doc, dict) else None
    if not isinstance(other, dict):
        return None
    backend, kind = other.get("backend"), other.get("device_kind")
    if not backend:
        return None
    kind = re.sub(r"[^A-Za-z0-9._-]+", "-", str(kind or "unknown").strip())
    if kind.lower() == backend.lower() or kind == "unknown":
        return backend
    return f"{backend}-{kind}"


# ---------------------------------------------------------------------------
# fit statistics
# ---------------------------------------------------------------------------
def _rankdata(a: np.ndarray) -> np.ndarray:
    """Ranks with ties averaged (what Spearman needs)."""
    a = np.asarray(a, float)
    order = np.argsort(a, kind="mergesort")
    ranks = np.empty(len(a))
    ranks[order] = np.arange(len(a), dtype=float)
    vals, inv, counts = np.unique(a, return_inverse=True,
                                  return_counts=True)
    sums = np.zeros(len(vals))
    np.add.at(sums, inv, ranks)
    return sums[inv] / counts[inv]


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    """Spearman rank correlation, -1..1 (0 when either side is constant)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    if x.size < 2:
        return 1.0
    rx, ry = _rankdata(x), _rankdata(y)
    if rx.std() == 0.0 or ry.std() == 0.0:
        return 0.0
    return float(np.corrcoef(rx, ry)[0, 1])


def find_misranks(observations: Sequence[Observation],
                  tol: float = DEFAULT_TOL) -> List[dict]:
    """Pairs the model orders one way and the hardware decisively the other:
    within each group, model prefers A over B but measured ``us_A > tol *
    us_B``.  Sorted worst-first by the measured slowdown of trusting the
    model."""
    out: List[dict] = []
    by_group: Dict[str, List[Observation]] = {}
    for o in observations:
        by_group.setdefault(o.group, []).append(o)
    for group, obs_list in by_group.items():
        for a, b in itertools.combinations(obs_list, 2):
            if a.model > b.model:
                a, b = b, a                      # model prefers a
            if a.model < b.model and a.us > tol * b.us:
                out.append({
                    "group": group,
                    "model_prefers": a.label,
                    "measured_prefers": b.label,
                    "model_advantage": b.model / max(a.model, 1e-12),
                    "measured_slowdown": a.us / max(b.us, 1e-12),
                })
    out.sort(key=lambda f: -f["measured_slowdown"])
    return out


def compute_calibration(observations: Sequence[Observation],
                        sig: str, tol: float = DEFAULT_TOL) -> dict:
    """The calibration table for one device: per-class measured/model ratios
    + fit-quality stats, per-group rank correlations, and the misrank list."""
    obs_list = [o for o in observations if o.us > 0 and o.model > 0]
    ratios_all = np.array([o.us / o.model for o in obs_list], float)
    by_class: Dict[str, List[Observation]] = {}
    by_group: Dict[str, List[Observation]] = {}
    for o in obs_list:
        by_class.setdefault(o.ckey, []).append(o)
        by_group.setdefault(o.group, []).append(o)
    classes = {}
    for ckey, rows in sorted(by_class.items()):
        ratios = np.array([o.us / o.model for o in rows], float)
        ratio = float(np.median(ratios))
        rel = np.abs(np.array([o.model for o in rows]) * ratio
                     - np.array([o.us for o in rows])) \
            / np.array([o.us for o in rows])
        classes[ckey] = {
            "ratio": ratio,
            "n": len(rows),
            "rel_err_p50": float(np.percentile(rel, 50)),
            "rel_err_p90": float(np.percentile(rel, 90)),
        }
    groups = {}
    for group, rows in sorted(by_group.items()):
        if len(rows) < 2:
            continue
        groups[group] = {
            "spearman": spearman([o.model for o in rows],
                                 [o.us for o in rows]),
            "n_cands": len(rows),
        }
    return {
        "schema": SCHEMA_CALIBRATION,
        "device_sig": sig,
        "_ts": time.time(),
        "n_obs": len(obs_list),
        "global_ratio": (float(np.median(ratios_all))
                         if ratios_all.size else 1.0),
        "classes": classes,
        "groups": groups,
        "misranks": find_misranks(obs_list, tol=tol),
    }


# ---------------------------------------------------------------------------
# persistence: calibration.json next to the autotune cache, keyed by device
# ---------------------------------------------------------------------------
def calibration_path(cache_dir: Optional[str] = None) -> str:
    """Same root-resolution rule as the autotune cache itself."""
    root = cache_dir or os.environ.get(
        "REPRO_TORCH_EXEC_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "exec"))
    return os.path.join(root, "calibration.json")


def save_calibration(table: dict, cache_dir: Optional[str] = None) -> str:
    """Insert/replace this device's table in the calibration document."""
    path = calibration_path(cache_dir)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {}
    if not isinstance(doc, dict):
        doc = {}
    doc[table["device_sig"]] = table
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


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


# ---------------------------------------------------------------------------
# drift findings beyond the trial tables
# ---------------------------------------------------------------------------
def forward_verdict_findings(doc, tol: float = DEFAULT_TOL) -> List[dict]:
    """``exec.forward.verdict`` instants where the warm DP schedule lost the
    race to per-layer greedy by more than ``tol`` — the schedule-level cost
    model (node + edge terms) misleading the scheduler."""
    out: List[dict] = []
    for ev in _trace_events(doc):
        if not (isinstance(ev, dict)
                and ev.get("name") == "exec.forward.verdict"):
            continue
        a = ev.get("args") or {}
        table = a.get("table")
        if not isinstance(table, dict):
            continue
        dp_us, greedy_us = table.get("dp"), table.get("greedy")
        if dp_us and greedy_us and dp_us > tol * greedy_us:
            out.append({"kind": "forward_dp_lost_race",
                        "dp_us": float(dp_us),
                        "greedy_us": float(greedy_us),
                        "slowdown": float(dp_us / greedy_us),
                        "winner": a.get("source")})
    return out


def bench_findings(doc, tol: float = DEFAULT_TOL) -> List[dict]:
    """Misranks a BENCH document already records in structured fields:
    compacted-vs-padded rows where the smaller grid measured decisively
    slower (the Cora 0.44x anomaly), order verdicts that disagree with the
    model, and autotuned plans slower than their baseline."""
    out: List[dict] = []
    results = doc.get("results", []) if isinstance(doc, dict) else []
    for rec in results:
        if not isinstance(rec, dict):
            continue
        name = rec.get("name", "?")
        sp = rec.get("speedup_vs_padded")
        if sp is not None and sp * tol < 1.0:
            out.append({"kind": "compacted_grid_slower", "name": name,
                        "speedup_vs_padded": float(sp),
                        "grid": rec.get("grid"),
                        "detail": "model prefers the smaller compacted grid"
                                  f" but it measured {sp:.2f}x of padded"})
        if rec.get("order_agrees_with_model") is False:
            out.append({"kind": "order_model_overruled", "name": name,
                        "order": rec.get("order"),
                        "model_order": rec.get("model_order")})
        for field in ("speedup_vs_segment", "speedup_vs_pr3",
                      "speedup_vs_pr4"):
            v = rec.get(field)
            if v is not None and v * tol < 1.0:
                out.append({"kind": "tuned_slower_than_baseline",
                            "name": name, "field": field,
                            "speedup": float(v)})
    return out


# ---------------------------------------------------------------------------
# report rendering + CLI
# ---------------------------------------------------------------------------
def _fmt_table(rows: List[Sequence], header: Sequence[str]) -> str:
    rows = [[str(c) for c in r] for r in ([header] + list(rows))]
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = []
    for j, r in enumerate(rows):
        lines.append("  " + "  ".join(c.ljust(w)
                                      for c, w in zip(r, widths)).rstrip())
        if j == 0:
            lines.append("  " + "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_report(table: dict, findings: List[dict],
                  tol: float = DEFAULT_TOL) -> str:
    lines = [f"cost-model audit — device_sig={table['device_sig']} "
             f"({table['n_obs']} measured/model pairs)"]
    if table["n_obs"]:
        lines.append(f"global measured/model ratio: "
                     f"{table['global_ratio']:.4g} us per byte-equivalent")
        bps = 1e6 / max(float(table["global_ratio"]), 1e-30)
        lines.append(f"  implied {bps / 1e9:.2f} GB-equiv/s vs the H100's "
                     f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s HBM roofline "
                     f"({bps / HBM_BYTES_PER_S:.1%}; CPU hosts are expected "
                     "to sit far below it)")
        lines.append("")
        lines.append("per-class calibration (cold DP consumes 'ratio'):")
        lines.append(_fmt_table(
            [[ck, f"{c['ratio']:.4g}", c["n"],
              f"{c['rel_err_p50']:.1%}", f"{c['rel_err_p90']:.1%}"]
             for ck, c in table["classes"].items()],
            ["class", "ratio", "n", "rel_err_p50", "rel_err_p90"]))
        if table["groups"]:
            lines.append("")
            lines.append("rank quality per trial group "
                         "(spearman(model, measured); 1.0 = model ranks "
                         "perfectly):")
            lines.append(_fmt_table(
                [[g[:72], f"{v['spearman']:+.2f}", v["n_cands"]]
                 for g, v in table["groups"].items()],
                ["group", "spearman", "cands"]))
    misranks = table.get("misranks", [])
    if misranks:
        lines.append("")
        lines.append(f"DRIFT: {len(misranks)} candidate pair(s) the model "
                     f"misranks by >{tol:.2f}x:")
        lines.append(_fmt_table(
            [[m["group"][:48], m["model_prefers"], m["measured_prefers"],
              f"{m['measured_slowdown']:.2f}x"]
             for m in misranks[:20]],
            ["group", "model prefers", "measured prefers", "cost of model"]))
    if findings:
        lines.append("")
        lines.append(f"DRIFT: {len(findings)} finding(s) from traces / "
                     "BENCH documents:")
        for f in findings[:20]:
            detail = {k: v for k, v in f.items() if k != "kind"}
            lines.append(f"  - {f['kind']}: "
                         + " ".join(f"{k}={v}" for k, v in detail.items()))
    if not misranks and not findings:
        lines.append("")
        lines.append("no drift: measured ordering agrees with the model "
                     f"everywhere (tol {tol:.2f}x)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.audit",
        description="Join measured autotune evidence against the cold cost "
                    "model; emit a calibration table + drift report.")
    ap.add_argument("files", nargs="*",
                    help="TRACE.json and/or BENCH.json documents; with no "
                         "files the autotune disk cache is audited")
    ap.add_argument("--cache-dir", default=None,
                    help="autotune cache root (default: "
                         "$REPRO_TORCH_EXEC_CACHE or "
                         "~/.cache/repro_torch/exec)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="whose cache entries to audit and whose table to "
                         "write: device_sig of this device (default "
                         "%(default)s, the card; raises without one)")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="misrank tolerance (default %(default)s)")
    ap.add_argument("--no-write", action="store_true",
                    help="report only; don't persist calibration.json")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..exec.autotune import device_sig as _device_sig
    dev_sig = _device_sig(resolve_device(args.device).type)

    observations: List[Observation] = []
    findings: List[dict] = []
    sig: Optional[str] = None
    use_cache = not args.files
    for path in args.files:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"unreadable {path}: {e}", file=sys.stderr)
            return 1
        trace_obs = observations_from_trace(doc)
        observations.extend(trace_obs)
        if trace_obs and sig is None:
            sig = trace_device_sig(doc)
        findings.extend(forward_verdict_findings(doc, tol=args.tol))
        findings.extend(bench_findings(doc, tol=args.tol))
    if use_cache:
        observations.extend(observations_from_cache(args.cache_dir,
                                                    sig=dev_sig))
    if sig is None:
        sig = dev_sig

    table = compute_calibration(observations, sig, tol=args.tol)
    print(render_report(table, findings, tol=args.tol))
    if table["n_obs"] and not args.no_write:
        path = save_calibration(table, args.cache_dir)
        print(f"\ncalibration table written to {path} "
              f"(device_sig={sig}); the cold DP now consumes it")
    elif not table["n_obs"] and not args.files:
        print("\nno auditable evidence: the autotune cache holds no entries "
              "for this device (run an autotune first, or pass a trace)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
