"""Natural-compression kernels: CUDA sources, wrappers, plain versions."""
