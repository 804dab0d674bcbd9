"""PyTorch port of the compressed-L2GD system for NVIDIA Hopper GPUs.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.core.flatbuf`` is the counterpart of
``repro.core.flatbuf``, and so on) and never imports it, nor jax.  Every
Pallas kernel on the ported path is a hand-written CUDA kernel here
(``repro_torch/kernels/*/csrc``), built at first use into ``build/``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.
"""
