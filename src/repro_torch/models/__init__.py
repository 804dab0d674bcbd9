"""Models of the port: the dense GQA decoders (``stablelm-1.6b``,
``gemma3-1b``), the MoE decoders (``granite-moe-1b-a400m``,
``moonshot-v1-16b-a3b``; ``deepseek-v2-lite-16b`` with latent attention
and a dense first layer), the attention-free Mamba decoder
(``falcon-mamba-7b``), the hybrid attention-and-Mamba decoder
(``hymba-1.5b``), the GQA decoder with a vision prefix
(``internvl2-26b``) and the encoder-decoder (``whisper-medium``), with
their KV-cache, latent-cache, Mamba-state and cross-attention decode
paths; ``models.frontends`` makes the stub patch and frame embeddings."""
from repro_torch.models.model import (decode_step, encoder_forward, forward,
                                      hidden, init_caches, init_params,
                                      layer_kinds, loss_fn, param_count)

__all__ = ["init_params", "forward", "hidden", "loss_fn", "layer_kinds",
           "init_caches", "decode_step", "param_count", "encoder_forward"]
