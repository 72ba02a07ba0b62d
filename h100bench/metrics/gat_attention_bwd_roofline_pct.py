"""The step's backward attention passes' least time (``_gat_work``) over
the device time, per step, of the program's backward attention kernels
(``gat::bwd::``) in the trace."""
from . import _gat_work as work


def read(ctx):
    if ctx.trace is None or not work.applies(ctx):
        return None
    t = ctx.trace.device_s(work.is_backward) / ctx.trace.n_steps
    if t <= 0:
        return None
    return 100.0 * work.attention_bound_s(ctx.shape, backward=True) / t
