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
from repro_torch.distributed.sharding import (P, axis_index, constrain,
                                              is_dtensor, local_map,
                                              replicate_like)


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


def rmsnorm_specs() -> dict:
    return {"scale": P(None)}


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
    """Inverse frequencies, shape (head_dim//2,), f32.  The base is filled
    on the device (no host-to-device copy, so a CUDA graph can capture
    it), with the bits ``torch.tensor(theta, dtype=f32)`` would hold."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
    def __init__(self, cfg: ModelConfig, dtype, device, d_ff: int = 0):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = frozen_param(torch.empty(d, f, dtype=dtype, device=device))
        self.w_up = frozen_param(torch.empty(d, f, dtype=dtype, device=device))
        self.w_down = frozen_param(torch.empty(f, d, dtype=dtype, device=device))

    def init_(self, generator: torch.Generator) -> None:
        d, f = self.w_gate.shape
        truncated_normal_(self.w_gate.data, d ** -0.5, generator)
        truncated_normal_(self.w_up.data, d ** -0.5, generator)
        truncated_normal_(self.w_down.data, f ** -0.5, generator)


def mlp_specs() -> dict:
    return {
        "w_gate": P(None, "model"),
        "w_up": P(None, "model"),
        "w_down": P("model", None),
    }


def mlp_apply(params: MLP, x: torch.Tensor, act: str = "swiglu"
              ) -> torch.Tensor:
    """The gated MLP.  A DTensor ``x`` split along the sequence (the
    sequence-parallel residual) is gathered along it first, as Megatron's
    sequence parallelism does before a column-split product."""
    x = constrain(x, ("batch", "seq", "embed"))
    gate = x @ params.w_gate
    up = x @ params.w_up
    if act == "geglu":
        gate = F.gelu(gate, approximate="tanh")
    else:
        gate = F.silu(gate)
    return constrain(gate * up, ("batch", "seq", "mlp")) @ params.w_down


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


def embedding_specs(cfg: ModelConfig) -> dict:
    specs = {"embedding": P("model", None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    return specs


def _embed_sharded(table, tokens):
    """Vocab-parallel lookup (``local_map``): the table whole along d and
    split along the vocab as its placement says, the ids whole on those
    axes; each rank reads the rows it holds, zeros elsewhere, and the
    partial rows sum.  The table's gradient leaves each batch shard
    partial."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    on_vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    vocab_axes = tuple(mesh.mesh_dim_names[i] for i in on_vocab)
    tpl = tuple(Shard(0) if i in on_vocab else Replicate()
                for i in range(mesh.ndim))
    ipl = tuple(Replicate() if i in on_vocab else
                (p if isinstance(p, Shard) else Replicate())
                for i, p in enumerate(tokens.placements))
    gpl = tuple(Shard(0) if i in on_vocab else
                (Partial() if isinstance(ipl[i], Shard) else Replicate())
                for i in range(mesh.ndim))
    opl = tuple(Partial() if i in on_vocab else ipl[i]
                for i in range(mesh.ndim))

    def body(tab, ids):
        v_loc = tab.shape[0]
        rel = ids.long() - axis_index(mesh, vocab_axes) * v_loc
        mine = (rel >= 0) & (rel < v_loc)
        rows = tab[rel.clamp(0, v_loc - 1)]
        return torch.where(mine[..., None], rows, torch.zeros_like(rows))

    return local_map(body, opl, (tpl, ipl), mesh,
                     in_grad_placements=(gpl, ipl))(table, tokens)


def embed_apply(params: Embedding, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings · sqrt(d).  A DTensor table is looked up by
    :func:`_embed_sharded`."""
    if is_dtensor(params.embedding):
        x = _embed_sharded(params.embedding, tokens)
    else:
        x = params.embedding[tokens.long()]
    # gemma-style sqrt(d) scaling, in the embedding's dtype as the reference
    # (a device fill, not a host-to-device copy)
    x = x * replicate_like(torch.full((), math.sqrt(cfg.d_model),
                                      dtype=x.dtype, device=x.device), x)
    return constrain(x, ("batch", "seq", "embed"))


def unembed_apply(params: Embedding, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params.embedding.T.to(x.dtype)
    else:
        logits = x @ params.lm_head
    logits = constrain(logits.float(), ("batch", "seq", "vocab"))
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return logits
