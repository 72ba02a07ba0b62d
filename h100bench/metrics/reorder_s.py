"""Host clock around ``minhash_reorder`` and ``Graph.permute``."""


def read(ctx):
    return ctx.readings.get("reorder_s")
