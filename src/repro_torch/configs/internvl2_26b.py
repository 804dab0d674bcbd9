"""internvl2-26b — InternViT + InternLM2 [arXiv:2404.16821].

Assigned spec (language backbone): 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553.  The InternViT vision encoder and its MLP
projector are stubbed — ``models.frontends`` supplies 256 precomputed
patch embeddings an example, which the decoder takes in front of the
tokens."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b", arch_type="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    mixer="gqa", ffn="dense",
    frontend="vision", n_frontend_tokens=256,
    rope_theta=1e6,
    source="arXiv:2404.16821",
))
