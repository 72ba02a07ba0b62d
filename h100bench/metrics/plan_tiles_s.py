"""The program's ``exec.plan.tiles_seconds``: host time building the plans'
block-ELL tiles and host arrays, one observation a direction of a plan."""
from ._program_spans import histogram_sum


def read(ctx):
    return histogram_sum("exec.plan.tiles_seconds")
