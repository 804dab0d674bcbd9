"""The port's kernels: counter RNG, device dispatch, build, QSGD."""
