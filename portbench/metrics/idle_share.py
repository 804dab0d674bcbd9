"""The share of the profiled cycle in which no device operation ran, in
percent."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
