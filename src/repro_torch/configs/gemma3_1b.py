"""gemma3-1b [hf:google/gemma-3-1b-pt].

Assigned spec: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144;
5:1 local:global layer pattern (sliding window 512 on local layers, one
global layer per 6), qk-norm, head_dim 256.  Sub-quadratic serving via the
windowed KV ring buffer (global layers keep a full cache)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b", arch_type="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    mixer="gqa", ffn="dense",
    qk_norm=True, activation="gelu",
    sliding_window=512, global_pattern="every_k", global_every=6,
    rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt",
))
