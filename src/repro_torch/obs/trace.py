"""Span tracer emitting Perfetto / chrome://tracing-compatible JSON, and
following ``torch.profiler`` onto its clock.

The port of ``repro/obs/trace.py``, extended: autotune trials,
DP scheduling, plan builds, serve request batches, train steps and their
phases become *complete* events (``ph: "X"``) on one ``time.perf_counter``
timeline.  Each span records an ``id`` and the ``id`` of its ``parent``,
the span open on its thread when it started (or one named explicitly: a
span opened on autograd's device thread names the span open on the thread
that called ``torch.autograd.grad``); both go into its ``args``.

A span records into two sinks:

* the installed :class:`Tracer` (:func:`start_trace`, :func:`tracing_to`),
  written out as JSON;
* while a ``torch.profiler`` session records
  (``torch.autograd.profiler._is_profiler_enabled``, :func:`profiling`),
  a process-local :class:`ProfiledSpans`, one per session, which stays
  readable after the session (:func:`profiled_spans`).  On the session's
  first span it enters and exits an empty ``record_function("obs.clock")``
  and notes ``perf_counter`` just after: that marker is the only event the
  program puts into the profiler.  A reader maps a span's ``perf_counter``
  time ``t`` to the profiler's clock as the marker's end plus ``(t -
  clock)`` seconds.  Spans never open profiler ranges of their own: a range
  gets a device-side twin spanning the kernels launched inside it, which a
  reader of the device trace would count as device work.  A span opened
  with ``timed=True`` also records a ``torch.cuda.Event`` at its start and
  its end on the current stream while a session is collected on a CUDA
  process; they are read after the steps, so no synchronise enters them.

Zero overhead when idle: with no tracer installed and no profiler
recording, ``span()`` returns a shared no-op singleton: one attribute load
and one flag check, no allocation, no clock read.  A session is closed by
the first span opened while the profiler is off; two sessions with no span
in between share the first one's marker, and a reader of the second finds
none in its trace.

Output format (the JSON Object Format of the Trace Event spec, which
Perfetto and chrome://tracing both accept):

    {"traceEvents": [{"name", "cat", "ph", "ts", "dur", "pid", "tid",
                      "args"}, ...],
     "displayTimeUnit": "ms",
     "otherData": {... provenance ...}}

``ts``/``dur`` are microseconds relative to the tracer's epoch.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

CLOCK_MARK = "obs.clock"


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()
    thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


NOOP_SPAN = _NoopSpan()

_IDS = itertools.count(1)
# thread ident -> the spans open on it, innermost last
_OPEN: Dict[int, list] = {}


def open_span(thread: Optional[int]) -> Optional["Span"]:
    """The innermost span open on thread ``thread`` (an ident, as
    :attr:`Span.thread`), or None."""
    try:
        return _OPEN[thread][-1]
    except (KeyError, IndexError):      # none, or closed while we looked
        return None


class Span:
    """One live span; on exit it records a complete ("X") event in the
    tracer it was opened under and joins the profiler session's spans."""

    __slots__ = ("_tracer", "_session", "_explicit", "_timed", "name", "cat",
                 "args", "id", "parent", "thread", "t0", "t1", "events")

    def __init__(self, tracer: Optional["Tracer"],
                 session: Optional["ProfiledSpans"], name: str, cat: str,
                 args: dict, parent: Optional["Span"] = None,
                 timed: bool = False):
        self._tracer = tracer
        self._session = session
        self._explicit = parent
        self._timed = timed
        self.name = name
        self.cat = cat
        self.args = args
        self.id = next(_IDS)
        self.parent: Optional[int] = None
        self.thread: Optional[int] = None
        self.t0 = self.t1 = 0.0
        self.events = None

    def __enter__(self):
        self.thread = threading.get_ident()
        stack = _OPEN.get(self.thread)
        if stack is None:
            stack = _OPEN.setdefault(self.thread, [])
        parent = self._explicit or (stack[-1] if stack else None)
        self.parent = None if parent is None else parent.id
        self.args["id"] = self.id
        self.args["parent"] = self.parent
        stack.append(self)
        if (self._timed and self._session is not None
                and torch.cuda.is_initialized()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def set(self, **kw):
        """Attach/overwrite args after the span opened (e.g. a measured
        verdict only known at exit)."""
        self.args.update(kw)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        stack = _OPEN[self.thread]
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._tracer is not None:
            self._tracer._complete(self.name, self.cat, self.t0, self.t1,
                                   self.args)
        if self._session is not None:
            self._session.spans.append(self)
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
        return Span(self, None, name, cat, args)

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


class ProfiledSpans:
    """The finished spans of one ``torch.profiler`` session, in memory, and
    ``clock``: ``perf_counter`` just after the session's ``obs.clock``
    marker ended."""

    __slots__ = ("spans", "clock")

    def __init__(self) -> None:
        self.spans: List[Span] = []
        with _profiler.record_function(CLOCK_MARK):
            pass
        self.clock = time.perf_counter()


# ---------------------------------------------------------------------------
# the installed tracer and the profiler session being collected
# ---------------------------------------------------------------------------
class _TraceState:
    __slots__ = ("tracer", "session", "last", "live", "lock")

    def __init__(self) -> None:
        self.tracer: Optional[Tracer] = None
        self.session: Optional[ProfiledSpans] = None
        self.last: Optional[ProfiledSpans] = None
        self.live = False               # a tracer or a session is open
        self.lock = threading.Lock()

    def sinks(self):
        """The tracer and the session a span opened now records into,
        opening or closing the session as the profiler is on or off."""
        with self.lock:
            on = _profiler._is_profiler_enabled
            if on and self.session is None:
                self.session = self.last = ProfiledSpans()
            elif not on:
                self.session = None
            self.live = self.tracer is not None or self.session is not None
            return self.tracer, self.session


_TRACE = _TraceState()


def start_trace() -> Tracer:
    """Install (and return) a fresh global tracer."""
    _TRACE.tracer = Tracer()
    _TRACE.live = True
    return _TRACE.tracer


def stop_trace(path: Optional[str] = None,
               other_data: Optional[dict] = None) -> Optional[dict]:
    """Uninstall the tracer; write/return its JSON doc (None if not tracing)."""
    t, _TRACE.tracer = _TRACE.tracer, None
    _TRACE.live = _TRACE.session is not None
    if t is None:
        return None
    if path is not None:
        return t.write(path, other_data)
    return t.to_json(other_data)


def tracing() -> bool:
    return _TRACE.tracer is not None


def current_tracer() -> Optional[Tracer]:
    return _TRACE.tracer


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording: the flag spans
    follow."""
    return _profiler._is_profiler_enabled


def profiled_spans() -> Optional[ProfiledSpans]:
    """The spans of the newest profiler session, open or ended (None if no
    span has opened under a profiler)."""
    return _TRACE.last


def span(name: str, cat: str = "repro", *, parent: Optional[Span] = None,
         timed: bool = False, **args):
    """A span on the installed tracer and the profiler's session, or the
    shared no-op when neither is recording.

    ``parent`` names the span this one belongs to where it is not the one
    open on this thread; ``timed`` adds the CUDA event pair.  The no-op path
    is one attribute load and one flag check — safe to leave in warm code.
    Truly per-element hot loops (kernel grid steps, per-edge work) should
    not call even this.
    """
    if not _TRACE.live and not _profiler._is_profiler_enabled:
        return NOOP_SPAN
    tracer, session = _TRACE.sinks()
    if tracer is None and session is None:
        return NOOP_SPAN
    return Span(tracer, session, name, cat, args, parent, timed)


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
