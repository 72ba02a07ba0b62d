"""The program's ``exec.plan.upload_seconds``: the plans' host-to-device
copies, each direction's ending in a synchronise of the plan's device."""
from ._program_spans import histogram_sum


def read(ctx):
    return histogram_sum("exec.plan.upload_seconds")
