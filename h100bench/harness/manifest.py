"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; each
has a file of its own: ``configs/<config>.json``, ``traffic/<traffic>.json``
and ``workloads/<cell>.json`` (the cell's correctness limits).  A metric is
``metrics/<name>.py``; a configuration's ``driver`` key names
``drivers/<driver>.py``.  Adding a cell, a configuration, a traffic mix or
a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _checked(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def load_data(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return json.loads((BENCH / kind / f"{_checked(name)}.json").read_text())


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` key only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _module(package: str, name: str) -> ModuleType:
    """``<package>/<name>.py``, loaded once (a name may hold ``.`` and
    ``-``, which an import statement cannot)."""
    qual = f"h100bench.{package}.{name.replace('.', '_').replace('-', '_')}"
    if qual in sys.modules:
        return sys.modules[qual]
    importlib.import_module(f"h100bench.{package}")
    path = BENCH / package / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {package} module {path}")
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[qual]
        raise
    return mod


def driver(name: str) -> ModuleType:
    return _module("drivers", name)


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def cell_spec(bench: dict, workload: str, root: Path = ROOT,
              config: Optional[dict] = None) -> dict:
    """Everything one cell runs on: its entry, configuration, traffic mix
    and limits (``config`` replaces the configuration's file, for tests)."""
    w = cell(bench, workload)
    return {"workload": w,
            "config": config or load_config(bench, w["config"], root),
            "traffic": load_data("traffic", w["traffic"]),
            "limits": load_data("workloads", workload)}
