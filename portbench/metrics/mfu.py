"""The window's training FLOPs (its local steps, counted analytically by
the configuration's plain model) over its seconds times the float32
peak, in percent."""
from portbench.harness import roofline, spec


def read(run):
    if not run.steps_of(0):
        return None
    flops = spec.reference(run.config).train_flops(run.config, run.shapes) \
        * run.steps_of(0)
    return 100.0 * flops / (run.window_s * roofline.PEAK_F32)
