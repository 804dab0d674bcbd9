"""Architecture config schema + registry + the 4 assigned input shapes —
the counterpart of ``repro.configs.base``, field for field.

Each ported architecture lives in ``repro_torch/configs/<id>.py`` (dashes
mapped to underscores) and registers an :class:`ArchConfig` carrying the
exact assigned hyper-parameters.  ``reduced()`` derives the smoke-test
variant (2 layers, d_model <= 512, <= 4 experts) that the CPU parity
tests run.  The port carries the architectures of the families it runs;
``get_config`` of another assigned architecture raises and names the
slice of the port that brings its family.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "register", "get_config",
           "list_archs", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # mixer / ffn selection
    mixer: str = "gqa"              # gqa | mla | mamba | hybrid
    ffn: str = "dense"              # dense | moe

    # attention details
    attn_layout: str = "fused"          # fused (d,H*hd) | split (d,H,hd)
    rope_theta: float = 1e4
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # window for local layers
    global_pattern: str = "all_global"     # all_global | every_k | hymba
    global_every: int = 6                  # for every_k (gemma3: 1 global per 6)

    # MLA
    kv_lora_rank: int = 0
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gather"        # gather | einsum
    aux_loss_weight: float = 0.01

    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    scan_chunk: int = 16

    # encoder-decoder (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    n_frontend_tokens: int = 0      # stubbed frames (audio) / patches (vlm)
    frontend: Optional[str] = None  # audio | vision

    # numerics
    norm_eps: float = 1e-5
    activation: str = "silu"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_impl: str = "dense"        # dense | flash: full-sequence attention
                                    # (flash = the hand-written CUDA kernel;
                                    # models/model.py falls back to dense
                                    # when a layer's mask is not plain
                                    # causal)
    remat: bool = True              # checkpoint each layer when training
    mlp_fused: bool = False         # fuse gate+up input projections (§Perf)
    remat_policy: str = "full"      # full | dots (dots_saveable: keep matmul
                                    # outputs -> bwd skips recomputing the TP
                                    # collectives at the cost of temp memory)

    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def supports_long_context(self) -> bool:
        """True iff every layer is sub-quadratic-servable at 500k: SSM/hybrid
        or sliding-window attention."""
        return self.mixer in ("mamba", "hybrid") or self.sliding_window is not None

    def supports_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 512, <= 4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        changes = dict(
            n_layers=2, d_model=d, n_heads=heads, n_kv_heads=kv,
            head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else None,
            global_every=2,
            kv_lora_rank=min(self.kv_lora_rank, 32),
            mla_nope_dim=32, mla_rope_dim=16, mla_v_dim=32,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            encoder_layers=2 if self.encoder_layers else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16) if self.n_frontend_tokens else 0,
            scan_chunk=4,
            remat=False,
        )
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "moonshot-v1-16b-a3b", "granite-moe-1b-a400m", "falcon-mamba-7b",
    "mistral-large-123b", "stablelm-1.6b", "gemma3-1b", "internvl2-26b",
    "deepseek-v2-lite-16b", "whisper-medium", "hymba-1.5b",
]

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        mod = "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
        importlib.import_module(mod)
    return _REGISTRY[name]


def list_archs():
    return list(ARCH_IDS)
