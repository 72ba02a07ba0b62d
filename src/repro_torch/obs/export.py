"""Export helpers: run provenance, the shared event schema, and JSONL dumps
(the port of ``repro/obs/export.py``).

Three record schemas, the reference's strings (``summary`` and ``regress``
sniff files by them):

* ``repro.obs/provenance@1`` — who/where/when: git SHA, ISO timestamp, the
  device the run resolved (``backend`` ``cuda`` or ``cpu``, ``device_kind``
  ``torch.cuda.get_device_name`` or ``cpu``), torch and CUDA versions, the
  card's power limit (``nvidia-smi``), platform.  Stamped onto every
  metrics dump and trace file, so a card number in them stands beside the
  card's name and power limit.
* ``repro.obs/metric@1``     — one registry metric (counter / gauge /
  histogram payload) as a JSON line.
* ``repro.obs/event@1``      — a free-form named event (benchmark rows ride
  this schema so BENCH files and ``--metrics-out`` share one vocabulary).

The provenance keys differ from the reference's (``backend``,
``torch_version``, ``cuda_version``, ``power_limit_w`` in place of
``jax_backend`` / ``jax_version``), so each package's validator rejects the
other's metrics files.  ``git_sha`` and the power limit are subprocesses,
run once a process.
"""
from __future__ import annotations

import datetime
import functools
import json
import os
import platform as _platform
import subprocess
from typing import Optional

import torch

from . import registry as _registry
from . import trace as _trace

SCHEMA_PROVENANCE = "repro.obs/provenance@1"
SCHEMA_METRIC = "repro.obs/metric@1"
SCHEMA_EVENT = "repro.obs/event@1"


def _iso_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds")


@functools.lru_cache(maxsize=None)
def git_sha() -> str:
    """Current commit SHA (short), or "unknown" outside a git checkout (a
    copy of the tree without ``.git``).  Read once a process."""
    here = os.path.dirname(os.path.abspath(__file__))
    for cwd in (os.getcwd(), here):
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"], cwd=cwd,
                capture_output=True, text=True, timeout=5)
            if out.returncode == 0 and out.stdout.strip():
                return out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return "unknown"


@functools.lru_cache(maxsize=None)
def _power_limits() -> tuple:
    """Every card's ``power.limit`` in watts as nvidia-smi prints it, in
    its order; empty where nvidia-smi cannot be run.  Read once a process."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return ()
    if out.returncode != 0:
        return ()
    return tuple(ln.strip() for ln in out.stdout.splitlines() if ln.strip())


def power_limit_w(device=None) -> str:
    """The power limit of ``device``'s card (nvidia-smi's text, e.g.
    ``"700.00"``), or ``"unknown"`` when it cannot be read."""
    limits = _power_limits()
    idx = 0
    if device is not None and torch.device(device).index is not None:
        idx = torch.device(device).index
    return limits[idx] if idx < len(limits) else "unknown"


def _resolve(device) -> torch.device:
    # the port's rule: ``cuda`` unless the caller asks for the CPU, and a
    # ``cuda`` request without a card raises (never a ``cpu`` stamp)
    from ..device import resolve_device
    return resolve_device("cuda" if device is None else device)


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of a ``cuda`` device, ``"cpu"`` for
    the CPU."""
    dev = _resolve(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def torch_version() -> str:
    return torch.__version__


def cuda_version() -> str:
    """The CUDA version torch was built for, ``"none"`` for a CPU build."""
    return torch.version.cuda or "none"


def provenance(device=None) -> dict:
    """The run-identity record every exported artifact is stamped with:
    ``backend`` and ``device_kind`` name the device the run resolved
    (``device``; ``cuda`` when None), not whether a card is present."""
    dev = _resolve(device)
    return {
        "schema": SCHEMA_PROVENANCE,
        "ts": _iso_now(),
        "git_sha": git_sha(),
        "device_kind": device_kind(dev),
        "backend": dev.type,
        "torch_version": torch_version(),
        "cuda_version": cuda_version(),
        "power_limit_w": power_limit_w(dev),
        "platform": _platform.platform(),
    }


def event(name: str, **fields) -> dict:
    """One shared-schema event record (benchmark rows, verdicts, ...)."""
    rec = {"schema": SCHEMA_EVENT, "name": name, "ts": _iso_now()}
    rec.update(fields)
    return rec


def metric_records(registry: Optional[_registry.Registry] = None) -> list:
    """Every registry metric as a ``repro.obs/metric@1`` record."""
    reg = registry if registry is not None else _registry.REGISTRY
    out = []
    for m in sorted(reg.metrics(), key=_registry.full_name):
        out.append({"schema": SCHEMA_METRIC, "type": m.kind, "name": m.name,
                    "labels": dict(m.labels), **m.payload()})
    return out


def dump_metrics_jsonl(path: str,
                       registry: Optional[_registry.Registry] = None,
                       extra_events: Optional[list] = None,
                       device=None) -> int:
    """Write provenance (of ``device``) + every metric (+ optional events)
    as JSON lines.  Returns the number of lines written."""
    records = [provenance(device)]
    records.extend(extra_events or [])
    records.extend(metric_records(registry))
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return len(records)


# --------------------------------------------------------------- CLI glue
def add_cli_flags(ap) -> None:
    """Attach the two observability flags every launcher shares."""
    ap.add_argument("--metrics-out", default=None, metavar="FILE.jsonl",
                    help="enable telemetry and dump the metric registry "
                         "(provenance + one JSON line per metric) on exit")
    ap.add_argument("--trace", default=None, metavar="FILE.json",
                    help="record a Perfetto / chrome://tracing trace of the "
                         "run (open at https://ui.perfetto.dev)")


class observed_run:
    """``with observed_run(args.metrics_out, args.trace,
    device=args.device):`` — turn on what the flags ask for, write the
    files when the block exits (on error too, so a crashed run still leaves
    its telemetry behind; the run's exception is not swallowed, and a file
    that cannot be written raises)."""

    def __init__(self, metrics_out: Optional[str] = None,
                 trace_path: Optional[str] = None, log=print,
                 extra_events: Optional[list] = None, device=None):
        self.metrics_out = metrics_out
        self.trace_path = trace_path
        self.log = log
        self.extra_events = extra_events
        self.device = device

    def __enter__(self):
        if self.metrics_out or self.trace_path:
            # the provenance's subprocesses run here, before any span
            git_sha()
            _power_limits()
            _registry.enable()
        if self.trace_path:
            _trace.start_trace()
        return self

    def __exit__(self, *exc):
        if self.trace_path:
            _trace.stop_trace(self.trace_path,
                              other_data=provenance(self.device))
            self.log(f"trace written to {self.trace_path}")
        if self.metrics_out:
            n = dump_metrics_jsonl(self.metrics_out,
                                   extra_events=self.extra_events,
                                   device=self.device)
            self.log(f"{n} metric records written to {self.metrics_out}")
        return False
