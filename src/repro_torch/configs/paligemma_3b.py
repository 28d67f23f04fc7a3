"""paligemma-3b — VLM: SigLIP patch-embedding stub + gemma LM backbone.

[arXiv:2407.07726; hf]
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=257216.
The vision frontend is a stub: the caller provides precomputed patch
embeddings (256 patches for 224px/14px SigLIP), prepended to the text.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    mlp_act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    frontend="vision_stub",
    vision_patches=256,
)
