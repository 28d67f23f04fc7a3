"""granite-3-8b — dense GQA. [hf:ibm-granite/granite-3.0-2b-base family; hf]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49_155,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
