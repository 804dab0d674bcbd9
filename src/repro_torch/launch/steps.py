"""Step builders — the serving half of ``repro.launch.steps``.

  prefill -> full-sequence forward, last-position logits (only the last
             position is unembedded: the (B, S, V) logits never exist)
  decode  -> one-token decode against the KV caches (updated in place)

Both run without autograd: they serve, nothing is trained through them.
The sharded and rollout builders come with the slices that train the LM
and add the multi-device launch layer.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, decode_step, hidden

__all__ = ["build_prefill_step", "build_serve_step"]


def build_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        x = hidden(params, cfg, batch)
        return blocks.unembed(params["embed"], x[:, -1])
    return prefill_step


def build_serve_step(cfg: ArchConfig):
    @torch.no_grad()
    def serve_step(params, caches, index, batch):
        logits, new_caches = decode_step(params, cfg, caches, index, batch)
        return logits[:, 0], new_caches
    return serve_step
