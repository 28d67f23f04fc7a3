"""hubert-xlarge — encoder-only audio transformer (w2v2 backbone).

[arXiv:2106.07447; unverified]
48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (codebook targets).
Backbone only: the conv feature extractor is a stub — ``input_specs`` feeds
precomputed frame embeddings. No RoPE (conv positional embedding in the real
model); bidirectional attention; no decode phase.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    use_rope=False,
    causal=False,
    frontend="audio_stub",
    tie_embeddings=False,
)
