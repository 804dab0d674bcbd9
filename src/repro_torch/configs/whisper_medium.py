"""whisper-medium [arXiv:2212.04356].

Assigned spec (transformer backbone): 24L d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865; encoder-decoder with the conv/mel frontend
stubbed — ``models.frontends`` supplies 1500 precomputed frame
embeddings.  Sinusoidal positions, a gated MLP with GELU (the
reference keeps the gated block for every family)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium", arch_type="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    mixer="gqa", ffn="dense",
    is_encdec=True, encoder_layers=24,
    frontend="audio", n_frontend_tokens=1500,
    activation="gelu",
    source="arXiv:2212.04356",
))
