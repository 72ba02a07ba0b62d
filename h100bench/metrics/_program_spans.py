"""What the program records of itself: its spans of the traced steps, moved
onto the device trace's clock, and its set-up histograms.

While ``torch.profiler`` records, ``repro_torch.obs`` keeps the program's
spans in memory (``obs.trace.profiled_spans()``) and puts one empty
``obs.clock`` marker into the profiler, noting ``perf_counter`` just after
it ended.  A span's ``perf_counter`` times map onto the trace's clock
(microseconds) as the marker's end plus their distance from that note.
Each helper returns None where there is nothing to read: a program that
keeps no such records, a run without a trace, a trace without the marker.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

CLOCK_MARK = "obs.clock"


class Aligned(NamedTuple):
    name: str
    start: float        # µs on the trace's clock
    end: float
    span: object        # the program's span: ``args``, ``events``


def aligned_spans(ctx) -> Optional[List[Aligned]]:
    """The program's spans that overlap the traced window, on its clock."""
    trace = ctx.trace
    if trace is None:
        return None
    marks = [end for name, _, end in trace.host_ops if name == CLOCK_MARK]
    if not marks:
        return None
    try:
        from repro_torch.obs import trace as program
    except ImportError:
        return None
    fetch = getattr(program, "profiled_spans", None)
    session = fetch() if fetch is not None else None
    if session is None:
        return None
    end = marks[-1]
    out = []
    for sp in session.spans:
        a = Aligned(sp.name, end + (sp.t0 - session.clock) * 1e6,
                    end + (sp.t1 - session.clock) * 1e6, sp)
        if a.end >= trace.lo and a.start <= trace.hi:
            out.append(a)
    return out or None


def histogram_sum(name: str) -> Optional[float]:
    """The sum of the program's histogram ``name`` (no labels), or None
    where it has no observation."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    h = obs.snapshot()["histograms"].get(name)
    if not h or not h["count"]:
        return None
    return float(h["sum"])
