"""Span tracer emitting Perfetto / chrome://tracing-compatible JSON.

A framework-free copy of ``repro/obs/trace.py``: autotune trials, DP
scheduling, serve request batches and train steps become *complete* events
(``ph: "X"``) on one ``time.perf_counter`` timeline.  Host clock only —
device time on the card comes from CUDA events (see ``chip_smoke.py``); a
``train.step`` span covers its step's device work because the loop reads
the loss inside it.

Zero overhead when idle: ``span()``/``instant()`` return a shared no-op
singleton while no tracer is installed — no allocation, no clock read, no
formatting.  Install one with :func:`start_trace`, write it out with
:func:`stop_trace` (or use the :func:`tracing_to` context manager).

Output format (the JSON Object Format of the Trace Event spec, which
Perfetto and chrome://tracing both accept):

    {"traceEvents": [{"name", "cat", "ph", "ts", "dur", "pid", "tid",
                      "args"}, ...],
     "displayTimeUnit": "ms",
     "otherData": {... provenance ...}}

``ts``/``dur`` are microseconds relative to the tracer's epoch.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span; records a complete ("X") event when exited."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set(self, **kw):
        """Attach/overwrite args after the span opened (e.g. a measured
        verdict only known at exit)."""
        self.args.update(kw)
        return self

    def __exit__(self, *exc):
        self._tracer._complete(self.name, self.cat, self._t0,
                               time.perf_counter(), self.args)
        return False


class Tracer:
    """Collects trace events; thread-safe appends, one perf_counter epoch."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        self._pid = os.getpid()

    def _tid(self) -> int:
        ident = threading.get_ident()
        t = self._tids.get(ident)
        if t is None:
            with self._lock:
                t = self._tids.setdefault(ident, len(self._tids))
        return t

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _complete(self, name: str, cat: str, t0: float, t1: float,
                  args: dict) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._us(t0), "dur": max(self._us(t1) - self._us(t0), 0.0),
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, cat: str = "repro", **args) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._us(time.perf_counter()),
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def to_json(self, other_data: Optional[dict] = None) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "repro"}}]
        doc = {"traceEvents": meta + list(self.events),
               "displayTimeUnit": "ms"}
        if other_data:
            doc["otherData"] = other_data
        return doc

    def write(self, path: str, other_data: Optional[dict] = None) -> dict:
        doc = self.to_json(other_data)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


# ---------------------------------------------------------------------------
# the installed tracer (module-level, like the registry's enabled flag)
# ---------------------------------------------------------------------------
class _TraceState:
    __slots__ = ("tracer",)

    def __init__(self) -> None:
        self.tracer: Optional[Tracer] = None


_TRACE = _TraceState()


def start_trace() -> Tracer:
    """Install (and return) a fresh global tracer."""
    _TRACE.tracer = Tracer()
    return _TRACE.tracer


def stop_trace(path: Optional[str] = None,
               other_data: Optional[dict] = None) -> Optional[dict]:
    """Uninstall the tracer; write/return its JSON doc (None if not tracing)."""
    t, _TRACE.tracer = _TRACE.tracer, None
    if t is None:
        return None
    if path is not None:
        return t.write(path, other_data)
    return t.to_json(other_data)


def tracing() -> bool:
    return _TRACE.tracer is not None


def current_tracer() -> Optional[Tracer]:
    return _TRACE.tracer


def span(name: str, cat: str = "repro", **args):
    """A span on the installed tracer, or the shared no-op when idle.

    The no-op path is one attribute load and a ``None`` check — safe to
    leave in warm code.  Truly per-element hot loops (kernel grid steps,
    per-edge work) should not call even this.
    """
    t = _TRACE.tracer
    if t is None:
        return NOOP_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    t = _TRACE.tracer
    if t is None:
        return
    t.instant(name, cat, **args)


class tracing_to:
    """``with obs.tracing_to("run.json"):`` — trace a block, write on exit."""

    def __init__(self, path: str, other_data: Optional[dict] = None):
        self.path = path
        self.other_data = other_data
        self.doc: Optional[dict] = None

    def __enter__(self) -> Tracer:
        return start_trace()

    def __exit__(self, *exc):
        self.doc = stop_trace(self.path, self.other_data)
        return False
