"""The step's aggregations' least time (``_gnn_work``: the work counted
from the graph and the widths, at 3.35 TB/s) over the device time, per
step, of the program's block-ELL kernels in the trace."""
from . import _gnn_work as work


def read(ctx):
    if ctx.trace is None or not work.applies(ctx):
        return None
    t = ctx.trace.device_s(work.is_aggregate) / ctx.trace.n_steps
    if t <= 0:
        return None
    return 100.0 * work.aggregate_bound_s(ctx.shape) / t
