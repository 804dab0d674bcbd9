"""Stub modality frontends — the counterpart of ``repro.models.frontends``.

The audio and vision architectures specify the transformer backbone
only: the mel-spectrogram and conv feature extractor (whisper) and the
ViT and its projector (InternVL) are not implemented, in the reference
either.  These helpers make precomputed frame / patch embeddings of the
right shape, ``0.02 * normal``, deterministic given a threefry key (the
port's numpy key words, ``core.prng``), drawn on ``device`` (CUDA
unless the caller names another) by ``prng.tensor_normal``, within
``prng.NORMAL_ULPS`` of the reference's ``jax.random.normal`` before
the scale.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["stub_patch_embeddings", "stub_frame_embeddings", "stub_frontend"]


def _stub(key, cfg: ArchConfig, lead, device) -> torch.Tensor:
    return 0.02 * prng.tensor_normal(
        key, (*lead, cfg.n_frontend_tokens, cfg.d_model),
        resolve_device(device))


def stub_patch_embeddings(key, cfg: ArchConfig, *lead,
                          device=None) -> torch.Tensor:
    """ViT patch embeddings stand-in: (*lead, n_patches, d_model)."""
    assert cfg.frontend == "vision"
    return _stub(key, cfg, lead, device)


def stub_frame_embeddings(key, cfg: ArchConfig, *lead,
                          device=None) -> torch.Tensor:
    """Audio frame embeddings stand-in: (*lead, n_frames, d_model)."""
    assert cfg.frontend == "audio" or cfg.is_encdec
    return _stub(key, cfg, lead, device)


def stub_frontend(key, cfg: ArchConfig, batch: dict, *lead,
                  device=None) -> dict:
    """Attach the right stub embedding (if any) to a token batch."""
    if cfg.frontend == "vision":
        batch = dict(batch, patches=stub_patch_embeddings(
            key, cfg, *lead, device=device))
    elif cfg.is_encdec:
        batch = dict(batch, frames=stub_frame_embeddings(
            key, cfg, *lead, device=device))
    return batch
