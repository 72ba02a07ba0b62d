"""The measured window over the steps it completed: its length on the
host clock, from the first step's call to the last step's loss read,
over their number."""


def read(ctx):
    if not ctx.step_times:
        return None
    return 1e3 * ctx.window_s / len(ctx.step_times)
