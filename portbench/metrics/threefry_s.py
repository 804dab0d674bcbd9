"""Device seconds of a fresh round's threefry draws: the program's
``draw`` spans inside its ``average`` spans in the profiled cycle, over
its ``step.fresh`` spans.  The flat transport draws inside its codec
kernels and has no such span: nothing to read there."""
from portbench.harness import program_trace


def read(run):
    if run.trace is None:
        return None
    record = program_trace.record()
    if record is None:
        return None
    rounds = program_trace.count(record, "step.fresh")
    seconds = program_trace.device_seconds(record, "draw", inside="average")
    if not rounds or seconds is None:
        return None
    return seconds / rounds
