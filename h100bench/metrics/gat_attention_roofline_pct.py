"""The step's forward attention passes' least time (``_gat_work``: counted
from the graph and the widths) over the device time, per step, of the
program's forward attention kernels (``gat::fwd::``) in the trace."""
from . import _gat_work as work


def read(ctx):
    if ctx.trace is None or not work.applies(ctx):
        return None
    t = ctx.trace.device_s(work.is_forward) / ctx.trace.n_steps
    if t <= 0:
        return None
    return 100.0 * work.attention_bound_s(ctx.shape, backward=False) / t
