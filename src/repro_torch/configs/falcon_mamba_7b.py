"""falcon-mamba-7b — attention-free Mamba-1 [arXiv:2410.05355].

Assigned spec: 64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16.  Mamba blocks carry their own gated expansion (expand=2), so
there is no separate FFN (ffn='none', d_ff=0)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=65024,
    mixer="mamba", ffn="none",
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2410.05355",
))
