"""Device time of the clip and the optimizer's update a step: from the CUDA
event at the start of the program's ``train.clip`` span to the one at the
end of its ``train.update`` span of the same step, mean over the traced
steps.  The events are read after the steps."""
from ._program_spans import aligned_spans


def read(ctx):
    spans = aligned_spans(ctx)
    if spans is None:
        return None
    starts, ends = {}, {}
    for a in spans:
        events = getattr(a.span, "events", None)
        if events is None:
            continue
        step = a.span.args.get("step")
        if a.name == "train.clip":
            starts[step] = events[0]
        elif a.name == "train.update":
            ends[step] = events[1]
    ms = []
    for step in sorted(starts.keys() & ends.keys()):
        ends[step].synchronize()
        ms.append(starts[step].elapsed_time(ends[step]))
    return sum(ms) / len(ms) if ms else None
