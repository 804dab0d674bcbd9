"""The share of the profiled cycle in which no device operation ran
while the host was inside one of the program's ``step.*`` spans, in
percent: the part of ``idle_share`` that the program's own host work
left, not the harness's synchronize and bookkeeping between steps."""
from portbench.harness import program_trace


def read(run):
    if run.trace is None:
        return None
    record = program_trace.record()
    if record is None:
        return None
    steps = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in record
             if s.name.startswith("step.")]
    if not steps:
        return None
    idle = program_trace.overlap_s(program_trace.idle_gaps(run.trace),
                                   steps)
    return 100.0 * idle / run.trace.window_s
