"""qwen3-moe-235b-a22b — MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family; hf]
94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
Qwen3 uses head_dim=128 (explicit, decoupled from d_model/n_heads).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=151_936,
    n_experts=128,
    experts_per_token=8,
    n_shared_experts=0,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
