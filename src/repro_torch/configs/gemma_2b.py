"""gemma-2b — dense, GeGLU, head_dim=256, MQA (kv=1). [arXiv:2403.08295; hf]

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    mlp_act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
