"""Threefry-2x32 array-draw kernel: CUDA source and wrapper (its plain
version is ``repro_torch.core.prng``'s int64 passes)."""
