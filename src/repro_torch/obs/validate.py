"""Validators for the files repro_torch.obs emits (the port of
``repro/obs/validate.py``): ``python -m repro_torch.obs.validate out.jsonl
trace.json``.

* trace JSON must satisfy the Trace Event Format subset Perfetto accepts:
  a ``traceEvents`` list (or a bare event array) of dicts, every event with
  a string ``ph``; ``"X"`` events carry numeric ``ts``/``dur`` >= 0 and
  pid/tid; ``"i"`` events carry ``ts``.
* metrics JSONL must open with a ``repro.obs/provenance@1`` record carrying
  timestamp / git SHA / device kind / torch version (the port's keys: the
  reference's metrics files, which carry ``jax_version``, are rejected
  here, and the port's there), followed by
  ``repro.obs/metric@1`` or ``repro.obs/event@1`` records.
* trajectory JSONL (``BENCH_trajectory.jsonl``) is every-line
  ``repro.obs/trajectory@1`` rows with a ``rows`` map and ``_ts``; a
  ``.jsonl`` file whose FIRST record carries that schema is validated as a
  trajectory instead of a metrics dump.

Each validator returns a list of human-readable problems (empty == valid).
"""
from __future__ import annotations

import json
import sys
from typing import List

from .export import SCHEMA_EVENT, SCHEMA_METRIC, SCHEMA_PROVENANCE
from .regress import SCHEMA_TRAJECTORY

_PROVENANCE_KEYS = ("ts", "git_sha", "device_kind", "torch_version")
_METRIC_TYPES = ("counter", "gauge", "histogram")
_HIST_KEYS = ("count", "sum", "p50", "p99")


def validate_trace(doc) -> List[str]:
    """Problems with a chrome://tracing / Perfetto JSON document."""
    errs: List[str] = []
    if isinstance(doc, list):
        events = doc
    elif isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["traceEvents missing or not a list"]
    else:
        return [f"trace doc must be a dict or list, got {type(doc).__name__}"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            errs.append(f"{where}: missing ph")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"{where}: missing name")
        if ph in ("X", "i", "B", "E", "C"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"{where}: ph={ph} needs numeric ts")
            if "pid" not in ev or "tid" not in ev:
                errs.append(f"{where}: ph={ph} needs pid and tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event needs dur >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: args must be an object")
    return errs


def validate_trace_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable trace JSON ({e})"]
    return validate_trace(doc)


def validate_metrics_lines(lines) -> List[str]:
    errs: List[str] = []
    records = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            records.append((i, json.loads(line)))
        except ValueError as e:
            errs.append(f"line {i + 1}: not JSON ({e})")
    if not records:
        return errs + ["no records"]
    _, head = records[0]
    if head.get("schema") != SCHEMA_PROVENANCE:
        errs.append(f"line 1: expected {SCHEMA_PROVENANCE} header, got "
                    f"{head.get('schema')!r}")
    else:
        for k in _PROVENANCE_KEYS:
            if not head.get(k):
                errs.append(f"line 1: provenance missing {k!r}")
    for i, rec in records[1:]:
        where = f"line {i + 1}"
        schema = rec.get("schema")
        if schema == SCHEMA_METRIC:
            if rec.get("type") not in _METRIC_TYPES:
                errs.append(f"{where}: bad metric type {rec.get('type')!r}")
                continue
            if not rec.get("name"):
                errs.append(f"{where}: metric missing name")
            if rec["type"] in ("counter", "gauge") and "value" not in rec:
                errs.append(f"{where}: {rec['type']} missing value")
            if rec["type"] == "histogram":
                for k in _HIST_KEYS:
                    if k not in rec:
                        errs.append(f"{where}: histogram missing {k!r}")
        elif schema == SCHEMA_EVENT:
            if not rec.get("name"):
                errs.append(f"{where}: event missing name")
        elif schema == SCHEMA_PROVENANCE:
            pass                         # extra provenance lines are fine
        else:
            errs.append(f"{where}: unknown schema {schema!r}")
    return errs


def validate_trajectory_lines(lines) -> List[str]:
    """Problems with a ``BENCH_trajectory.jsonl`` file (every line one
    ``repro.obs/trajectory@1`` row)."""
    errs: List[str] = []
    any_rows = False
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        any_rows = True
        where = f"line {i + 1}"
        try:
            rec = json.loads(line)
        except ValueError as e:
            errs.append(f"{where}: not JSON ({e})")
            continue
        if rec.get("schema") != SCHEMA_TRAJECTORY:
            errs.append(f"{where}: expected {SCHEMA_TRAJECTORY}, got "
                        f"{rec.get('schema')!r}")
            continue
        if not isinstance(rec.get("rows"), dict):
            errs.append(f"{where}: trajectory row missing 'rows' map")
        if not isinstance(rec.get("_ts"), (int, float)):
            errs.append(f"{where}: trajectory row missing numeric '_ts'")
    if not any_rows:
        errs.append("no records")
    return errs


def _first_schema(lines) -> str:
    for line in lines:
        line = line.strip()
        if line:
            try:
                return json.loads(line).get("schema", "")
            except ValueError:
                return ""
    return ""


def validate_metrics_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    if _first_schema(lines) == SCHEMA_TRAJECTORY:
        return validate_trajectory_lines(lines)
    return validate_metrics_lines(lines)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m repro_torch.obs.validate FILE.jsonl "
              "TRACE.json ...")
        return 2
    failed = 0
    for path in args:
        errs = (validate_metrics_file(path) if path.endswith(".jsonl")
                else validate_trace_file(path))
        if errs:
            failed += 1
            print(f"INVALID {path}:")
            for e in errs[:20]:
                print(f"  - {e}")
        else:
            print(f"OK {path}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
