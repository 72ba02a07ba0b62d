"""Terminal one-pager for telemetry artifacts — no chrome://tracing needed
(the port of ``repro/obs/summary.py``; the provenance header prints the
port's ``backend`` key).

``--metrics-out`` JSONL files and ``--trace`` Perfetto files are built for
machines; this renders them for operators::

    python -m repro_torch.obs.summary metrics.jsonl
    python -m repro_torch.obs.summary metrics.jsonl trace.json --top 15
    python -m repro_torch.obs.summary trace.json

Arguments are sniffed by content, not extension: JSONL metric dumps
(``repro.obs/metric@1`` lines) and Perfetto JSON traces can be passed in
any order.  Output: provenance header, counter/gauge tables, histogram
percentiles, event counts, and the top-N span names by total wall time.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple


def _fmt_table(rows: List[Tuple], header: Tuple[str, ...]) -> str:
    rows = [[str(c) for c in r] for r in ([header] + list(rows))]
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    out = []
    for j, r in enumerate(rows):
        out.append("  " + "  ".join(c.ljust(w)
                                    for c, w in zip(r, widths)).rstrip())
        if j == 0:
            out.append("  " + "  ".join("-" * w for w in widths))
    return "\n".join(out)


def _fmt_num(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _metric_full_name(rec: dict) -> str:
    labels = rec.get("labels") or {}
    if not labels:
        return rec.get("name", "?")
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{rec.get('name', '?')}{{{inner}}}"


# ---------------------------------------------------------------------------
# loaders — sniff by content
# ---------------------------------------------------------------------------
def load_file(path: str):
    """``("metrics", records)`` for a JSONL dump, ``("trace", doc)`` for a
    Perfetto trace document."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        return "trace", doc
    if isinstance(doc, list):
        return "trace", {"traceEvents": doc}
    records = []
    for ln in text.splitlines():
        ln = ln.strip()
        if ln:
            records.append(json.loads(ln))
    return "metrics", records


# ---------------------------------------------------------------------------
# metrics rendering
# ---------------------------------------------------------------------------
def render_metrics(records: List[dict]) -> str:
    lines: List[str] = []
    prov = next((r for r in records
                 if r.get("schema", "").startswith("repro.obs/provenance")),
                None)
    if prov:
        lines.append(f"run: {prov.get('ts')}  sha={prov.get('git_sha')}  "
                     f"backend={prov.get('backend')}  "
                     f"device={prov.get('device_kind')}")
    counters = [(r, _metric_full_name(r)) for r in records
                if r.get("type") == "counter"]
    gauges = [(r, _metric_full_name(r)) for r in records
              if r.get("type") == "gauge"]
    hists = [(r, _metric_full_name(r)) for r in records
             if r.get("type") == "histogram"]
    events: Dict[str, int] = {}
    for r in records:
        if r.get("schema", "").startswith("repro.obs/event"):
            events[r.get("name", "?")] = events.get(r.get("name", "?"),
                                                    0) + 1
    if counters:
        lines.append("")
        lines.append(f"counters ({len(counters)}):")
        lines.append(_fmt_table(
            sorted([(nm, _fmt_num(r.get("value"))) for r, nm in counters]),
            ("name", "value")))
    if gauges:
        lines.append("")
        lines.append(f"gauges ({len(gauges)}):")
        lines.append(_fmt_table(
            sorted([(nm, _fmt_num(r.get("value"))) for r, nm in gauges]),
            ("name", "value")))
    if hists:
        lines.append("")
        lines.append(f"histograms ({len(hists)}):")
        lines.append(_fmt_table(
            sorted([(nm, r.get("count", 0), _fmt_num(r.get("mean", 0.0)),
                     _fmt_num(r.get("p50", 0.0)), _fmt_num(r.get("p90",
                                                                 0.0)),
                     _fmt_num(r.get("p99", 0.0)), _fmt_num(r.get("max",
                                                                 0.0)))
                    for r, nm in hists]),
            ("name", "count", "mean", "p50", "p90", "p99", "max")))
    if events:
        lines.append("")
        lines.append(f"events ({sum(events.values())}):")
        lines.append(_fmt_table(
            sorted(events.items(), key=lambda kv: -kv[1]),
            ("name", "count")))
    if len(lines) <= (1 if prov else 0):
        lines.append("(no metric records — was telemetry enabled?)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# trace rendering
# ---------------------------------------------------------------------------
def span_stats(doc: dict) -> List[dict]:
    """Per span NAME: count, total/mean/max duration (ms), from ``ph: "X"``
    complete events."""
    agg: Dict[str, dict] = {}
    for ev in doc.get("traceEvents", []):
        if not (isinstance(ev, dict) and ev.get("ph") == "X"):
            continue
        dur_ms = float(ev.get("dur", 0)) / 1e3       # trace durs are us
        s = agg.setdefault(ev.get("name", "?"),
                           {"name": ev.get("name", "?"), "count": 0,
                            "total_ms": 0.0, "max_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += dur_ms
        s["max_ms"] = max(s["max_ms"], dur_ms)
    out = sorted(agg.values(), key=lambda s: -s["total_ms"])
    for s in out:
        s["mean_ms"] = s["total_ms"] / max(s["count"], 1)
    return out


def render_trace(doc: dict, top: int = 10) -> str:
    lines: List[str] = []
    other = doc.get("otherData") or {}
    if other:
        lines.append(f"trace: sha={other.get('git_sha')}  "
                     f"backend={other.get('backend')}  "
                     f"device={other.get('device_kind')}")
    stats = span_stats(doc)
    instants = sum(1 for ev in doc.get("traceEvents", [])
                   if isinstance(ev, dict) and ev.get("ph") == "i")
    if stats:
        lines.append("")
        lines.append(f"top {min(top, len(stats))} span names by total time "
                     f"({len(stats)} distinct, {instants} instant events):")
        lines.append(_fmt_table(
            [(s["name"], s["count"], f"{s['total_ms']:.3f}",
              f"{s['mean_ms']:.3f}", f"{s['max_ms']:.3f}")
             for s in stats[:top]],
            ("span", "count", "total_ms", "mean_ms", "max_ms")))
    else:
        lines.append("(no complete spans in trace)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.summary",
        description="Human-readable summary of metrics JSONL and/or "
                    "Perfetto trace files.")
    ap.add_argument("files", nargs="+",
                    help="FILE.jsonl (metrics) and/or TRACE.json, any order")
    ap.add_argument("--top", type=int, default=10,
                    help="span names to show from traces "
                         "(default %(default)s)")
    args = ap.parse_args(argv)
    first = True
    for path in args.files:
        try:
            kind, payload = load_file(path)
        except (OSError, ValueError) as e:
            print(f"unreadable {path}: {e}", file=sys.stderr)
            return 1
        if not first:
            print()
        first = False
        print(f"=== {path} ===")
        print(render_metrics(payload) if kind == "metrics"
              else render_trace(payload, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
