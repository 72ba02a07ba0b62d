"""The rise of the device allocator's ``memory_allocated`` across
``plan_forward``: the plans' tiles, offsets and transpose plans."""


def read(ctx):
    return ctx.readings.get("plan_mem_gb")
