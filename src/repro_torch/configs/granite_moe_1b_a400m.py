"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

Assigned spec: 24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155,
MoE 32e top-8 (no shared experts)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    mixer="gqa", ffn="moe",
    n_experts=32, n_shared_experts=0, experts_per_token=8, moe_d_ff=512,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
