"""Flat-buffer QSGD kernels: CUDA sources, wrappers, plain versions."""
