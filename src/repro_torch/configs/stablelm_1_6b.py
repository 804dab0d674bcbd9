"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b].

Assigned spec: 24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-1.6b", arch_type="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    mixer="gqa", ffn="dense",
    rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b",
))
