"""Flash attention: the CUDA kernel, its plain PyTorch version and the
(B, S, H, D) GQA entry point."""
