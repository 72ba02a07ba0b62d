"""The 95th percentile (nearest rank) of every step of the window, each
timed on the host clock from its call to its loss read."""
import math


def read(ctx):
    if not ctx.step_times:
        return None
    times = sorted(ctx.step_times)
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
