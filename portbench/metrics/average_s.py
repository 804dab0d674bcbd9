"""Device seconds of a fresh round's compressed average (the uplink
codecs and their draws, the mean, the downlink): the program's
``average`` spans in the profiled cycle over its ``step.fresh`` spans."""
from portbench.harness import program_trace


def read(run):
    if run.trace is None:
        return None
    record = program_trace.record()
    if record is None:
        return None
    rounds = program_trace.count(record, "step.fresh")
    seconds = program_trace.device_seconds(record, "average")
    if not rounds or seconds is None:
        return None
    return seconds / rounds
