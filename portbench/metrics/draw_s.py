"""Device seconds a fresh round spends in the threefry draws (int64
elementwise operations that start inside a fresh step) in the profiled
cycle.  Only the leafwise transport draws with threefry; the flat one
makes its noise inside the codec kernels, so there it reads nothing."""
from portbench.harness.trace import DRAWS


def read(run):
    if run.trace is None or run.cell.get("transport") != "leafwise":
        return None
    seconds = dict(run.trace.by_class("fresh")).get(DRAWS)
    rounds = run.trace_fresh_rounds
    if not seconds or not rounds:
        return None
    return seconds / rounds
