"""The device trace of a few steps, from ``torch.profiler``.

Each profiled step runs inside a ``record_function`` marker.  The traced
window runs from the first marker's start to the last one's end, on the
profiler's clock, which the host's and the device's events share.  Busy
time is the union of the intervals in which a device operation (a kernel,
a copy or a fill) ran inside the window; kernel times by name are sums of
the operations' own durations.  Idle gaps are named by the innermost host
operation open at the middle of the gap.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

STEP_MARK = "h100bench.step"
NAME_CHARS = 160

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval], lo: float, hi: float
                 ) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


class DeviceTrace:
    """Device and host operations of the profiled steps (times in µs)."""

    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]],
                 steps: List[Interval]):
        if not steps:
            raise ValueError("the trace holds no step marker")
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.steps = sorted(steps)
        self.lo, self.hi = self.steps[0][0], self.steps[-1][1]

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device_ops],
                            self.lo, self.hi) / 1e6

    def device_s(self, keep: Optional[Callable[[str], bool]] = None
                 ) -> float:
        """Summed duration of the device operations whose names ``keep``
        accepts (all of them without ``keep``)."""
        return sum(e - s for n, s, e in self.device_ops
                   if keep is None or keep(n)) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, s, e in self.device_ops:
            by[n[:NAME_CHARS]] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time inside the window, summed by what the host was doing."""
        host = sorted(self.host_ops, key=lambda o: o[1])
        by = defaultdict(float)
        for s, e in gaps([(a, b) for _, a, b in self.device_ops],
                         self.lo, self.hi):
            mid = (s + e) / 2
            open_ = [o for o in host if o[1] <= mid <= o[2]]
            name = max(open_, key=lambda o: o[1])[0] if open_ else "(none)"
            by[name[:NAME_CHARS]] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def from_profiler(prof) -> DeviceTrace:
    from torch.autograd import DeviceType
    device, host, steps = [], [], []
    for ev in prof.events():
        iv = (float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CPU:
            if ev.name == STEP_MARK:
                steps.append(iv)
            else:
                host.append((ev.name, *iv))
        elif ev.name != STEP_MARK:      # the marker's device-side twin
            device.append((ev.name, *iv))
    return DeviceTrace(device, host, steps)


def profile_steps(step: Callable[[], object], n: int) -> DeviceTrace:
    """Run ``step`` ``n`` times under the profiler; ``step`` returns only
    once its device work has ended (it reads its result on the host)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(STEP_MARK):
                step()
    return from_profiler(prof)
