"""Models of the port: the dense GQA decoder family (configs
``stablelm-1.6b`` and ``gemma3-1b``) with its KV-cache decode path."""
from repro_torch.models.model import (decode_step, forward, hidden,
                                      init_caches, init_params, layer_kinds,
                                      loss_fn, param_count)

__all__ = ["init_params", "forward", "hidden", "loss_fn", "layer_kinds",
           "init_caches", "decode_step", "param_count"]
