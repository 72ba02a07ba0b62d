"""The idle device time of the traced window that the program holds, as a
share of the window: of each gap between device operations, the part that
one of the program's spans (``_program_spans``) covers, less what of it the
profiler's own buffer requests cover.  ``device_idle_pct`` less this is
the harness's (the loss read, the step marker) and the profiler's.

Covered time, not the gap's middle: the gap at a step's start runs from
the harness's loss read into the program's first launches, and a gap
given whole to whatever is open at its middle moves between the two from
run to run."""
from ..harness.devtrace import gaps, union_length
from ._program_spans import aligned_spans

BUFFER_REQUEST = "Activity_Buffer_Request"


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx):
    aligned = aligned_spans(ctx)
    if aligned is None:
        return None
    trace = ctx.trace
    if trace.hi <= trace.lo:
        return None
    spans = [(a.start, a.end) for a in aligned]
    buffers = _merged((s, e) for name, s, e in trace.host_ops
                      if name.replace(" ", "_") == BUFFER_REQUEST)
    idle = 0.0
    for s, e in gaps([(a, b) for _, a, b in trace.device_ops], trace.lo,
                     trace.hi):
        idle += union_length(spans, s, e)
        for bs, be in buffers:
            if be > s and bs < e:
                idle -= union_length(spans, max(s, bs), min(e, be))
    return 100.0 * idle / (trace.hi - trace.lo)
