"""The compressed average's least bytes (every client's model read once,
the target written once) at HBM bandwidth, over the device time of the
codec kernels in the profiled cycle, in percent.  The kernels are those
of the program's two codec libraries, by their profiler names."""
from portbench.harness import roofline

KERNELS = ("qsgd_", "natural_")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(KERNELS)
    rounds = run.trace_fresh_rounds
    if not seconds or not rounds:
        return None
    least = rounds * roofline.codec_bytes(run.config, run.shapes) \
        / roofline.HBM_BW
    return 100.0 * least / seconds
