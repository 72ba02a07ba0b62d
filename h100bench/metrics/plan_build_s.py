"""Host clock around ``plan_forward``, ending in a device synchronise."""


def read(ctx):
    return ctx.readings.get("plan_build_s")
