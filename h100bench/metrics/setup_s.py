"""Host clock from the process's start to the first step of the window:
graph making, reordering, plan building, weights, the checked and warm-up
steps, and in a run that compiles, the kernels' build."""


def read(ctx):
    return ctx.setup_s
