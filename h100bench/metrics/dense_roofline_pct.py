"""The step's dense products' least time (``_gnn_work``: from the
configuration's shapes, each product bound by 67 TFLOP/s fp32 or by its
operands' bytes at 3.35 TB/s) over the device time, per step, of the
kernels that run them: cuBLAS's.  A product that the program fuses into
an aggregation kernel is timed with the aggregations (``_gnn_work``), and
its least time stays in the bound here."""
from . import _gnn_work as work


def read(ctx):
    if ctx.trace is None or not work.applies(ctx):
        return None
    t = ctx.trace.device_s(work.is_dense) / ctx.trace.n_steps
    if t <= 0:
        return None
    return 100.0 * work.dense_bound_s(ctx.shape) / t
