"""The port's kernels: counter RNG, device dispatch, build; QSGD, natural,
flash attention and the selective scan."""
