"""moonshot-v1-16b-a3b — Moonlight-16B-A3B family [hf:moonshotai/Moonlight-16B-A3B].

Assigned spec: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840,
MoE 64e top-6.  (Listed [dense] in the assignment but the spec carries MoE
fields; implemented as MoE per the concrete numbers — see DESIGN.md §4.)
2 shared experts per the model card."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b", arch_type="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840,
    mixer="gqa", ffn="moe",
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    rope_theta=5e4,
    source="hf:moonshotai/Moonlight-16B-A3B",
))
