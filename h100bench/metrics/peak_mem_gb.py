"""The device allocator's peak (``max_memory_allocated``) over set-up and
the window, in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
