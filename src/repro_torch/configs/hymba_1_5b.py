"""hymba-1.5b [arXiv:2411.13676].

Assigned spec: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; hybrid heads — attention and Mamba heads run in PARALLEL on
the same input and their normalized outputs are mean-fused.  Sliding-window
attention everywhere except the first/middle/last layers (global), per the
paper -> runs long_500k."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", arch_type="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    mixer="hybrid", ffn="dense",
    ssm_state=16, ssm_conv=4, ssm_expand=1,
    sliding_window=1024, global_pattern="hymba",
    rope_theta=1e4,
    source="arXiv:2411.13676",
))
