"""Basic layers: RMSNorm, RoPE, gated MLP, embeddings (port of
``repro/models/layers.py``).

Parameters live in small ``nn.Module`` containers whose tensors keep the
reference's layouts (a projection weight is ``(d_in, d_out)`` and is applied
as ``x @ w``), so weights carry over from the reference unchanged.  The
apply functions are plain tensor functions with the reference's casts at the
same places.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig


def frozen_param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with stddev · N(0, 1) truncated to [-2, 2] (the
    reference's initializer; drawn in f32, then cast to ``t``'s dtype)."""
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_(tmp.mul_(stddev))
    return t


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = frozen_param(torch.ones(dim, dtype=dtype, device=device))


def rmsnorm_apply(params: RMSNorm, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (half-rotation convention, llama-style)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), f32."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), ar)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Returns x's
    dtype (the rotation itself runs in f32)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = frozen_param(torch.empty(d, f, dtype=dtype, device=device))
        self.w_up = frozen_param(torch.empty(d, f, dtype=dtype, device=device))
        self.w_down = frozen_param(torch.empty(f, d, dtype=dtype, device=device))

    def init_(self, generator: torch.Generator) -> None:
        d, f = self.w_gate.shape
        truncated_normal_(self.w_gate.data, d ** -0.5, generator)
        truncated_normal_(self.w_up.data, d ** -0.5, generator)
        truncated_normal_(self.w_down.data, f ** -0.5, generator)


def mlp_apply(params: MLP, x: torch.Tensor, act: str = "swiglu"
              ) -> torch.Tensor:
    gate = x @ params.w_gate
    up = x @ params.w_up
    if act == "geglu":
        gate = F.gelu(gate, approximate="tanh")
    else:
        gate = F.silu(gate)
    return (gate * up) @ params.w_down


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.embedding = frozen_param(torch.empty(cfg.vocab_size, cfg.d_model,
                                            dtype=dtype, device=device))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = frozen_param(torch.empty(cfg.d_model, cfg.vocab_size,
                                              dtype=dtype, device=device))

    def init_(self, generator: torch.Generator) -> None:
        std = self.embedding.shape[1] ** -0.5
        truncated_normal_(self.embedding.data, std, generator)
        if self.lm_head is not None:
            truncated_normal_(self.lm_head.data, std, generator)


def embed_apply(params: Embedding, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    x = params.embedding[tokens.long()]
    # gemma-style sqrt(d) scaling, in the embedding's dtype as the reference
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def unembed_apply(params: Embedding, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params.embedding.T.to(x.dtype)
    else:
        logits = x @ params.lm_head
    logits = logits.float()
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return logits
