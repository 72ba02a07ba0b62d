"""The program's attention kernels' (``gat::``) device time over all
device time of the traced steps."""
from . import _gat_work as work


def read(ctx):
    if ctx.trace is None or not work.applies(ctx):
        return None
    total = ctx.trace.device_s()
    t = ctx.trace.device_s(work.is_attention)
    if total <= 0 or t <= 0:
        return None
    return 100.0 * t / total
