"""llama2-7b-chat — the paper's primary evaluation model (§5.1). MHA.

32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32_000,
    rope_theta=10_000.0,
    tie_embeddings=False,
)
