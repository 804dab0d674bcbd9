"""Device seconds of an aggregation step's loss (every client's no-grad
forward at its pre-update weights): the program's ``loss`` spans in the
profiled cycle over its aggregation steps (``step.fresh`` and
``step.cached`` spans)."""
from portbench.harness import program_trace


def read(run):
    if run.trace is None:
        return None
    record = program_trace.record()
    if record is None:
        return None
    steps = program_trace.count(record, "step.fresh", "step.cached")
    seconds = program_trace.device_seconds(record, "loss")
    if not steps or seconds is None:
        return None
    return seconds / steps
