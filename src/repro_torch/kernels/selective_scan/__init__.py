"""Mamba selective scan: the CUDA kernel, its plain PyTorch version and
the entry point the Mamba mixer calls."""
