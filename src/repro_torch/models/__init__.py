"""Models of the port: the dense GQA decoders (``stablelm-1.6b``,
``gemma3-1b``), the MoE decoders (``granite-moe-1b-a400m``,
``moonshot-v1-16b-a3b``; ``deepseek-v2-lite-16b`` with latent attention
and a dense first layer), the attention-free Mamba decoder
(``falcon-mamba-7b``) and the hybrid attention-and-Mamba decoder
(``hymba-1.5b``), with their KV-cache, latent-cache and Mamba-state
decode paths."""
from repro_torch.models.model import (decode_step, forward, hidden,
                                      init_caches, init_params, layer_kinds,
                                      loss_fn, param_count)

__all__ = ["init_params", "forward", "hidden", "loss_fn", "layer_kinds",
           "init_caches", "decode_step", "param_count"]
