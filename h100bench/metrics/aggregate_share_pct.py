"""The program's block-ELL kernels' device time over all device time of
the traced steps."""
from . import _gnn_work as work


def read(ctx):
    if ctx.trace is None or not work.applies(ctx):
        return None
    total = ctx.trace.device_s()
    if total <= 0:
        return None
    return 100.0 * ctx.trace.device_s(work.is_aggregate) / total
