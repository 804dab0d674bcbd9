"""deepseek-v2-lite-16b [arXiv:2405.04434].

Assigned spec: 27L d_model=2048 16H d_ff=1408(expert) vocab=102400,
MLA kv_lora=512, MoE 2 shared + 64 routed top-6 (the primary spec line says
64e; the bracket note's '160 routed' belongs to full V2 — we follow the
primary spec, see DESIGN.md §4).  First layer is dense with d_ff=10944 per
the paper."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    mixer="mla", ffn="moe",
    kv_lora_rank=512, mla_nope_dim=128, mla_rope_dim=64, mla_v_dim=128,
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=1e4,
    source="arXiv:2405.04434",
))
