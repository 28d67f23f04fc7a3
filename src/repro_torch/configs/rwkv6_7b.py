"""rwkv6-7b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892; hf]

32L d_model=4096 d_ff=14336 vocab=65536. rwkv head_size=64 (64 wkv heads).
SALS is inapplicable (no KV cache — fixed-size wkv state); see DESIGN §5.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads = d_model / rwkv_head_size
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65_536,
    use_rope=False,
    rwkv_head_size=64,
    tie_embeddings=False,
)
