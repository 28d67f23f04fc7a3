"""mistral-7b-v0.2 — the paper's GQA evaluation model (§5.1).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
