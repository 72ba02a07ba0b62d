"""The step's model FLOPs (``_gnn_work``: dense products plus 2 e d for
each aggregation) over the untraced window's time per step and the card's
67 TFLOP/s fp32 peak (stated at 700 W; the run's ``device`` gives the
card's power limit)."""
from . import _gnn_work as work
from ..harness import peaks


def read(ctx):
    if not work.applies(ctx) or not ctx.step_times:
        return None
    step_s = ctx.window_s / len(ctx.step_times)
    return 100.0 * work.model_flops(ctx.shape) / (step_s
                                                  * peaks.PEAK_FLOPS_FP32)
