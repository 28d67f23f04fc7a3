"""Multi-head / grouped-query attention (port of the prefill and
full-precision decode paths of ``repro/models/attention.py``).

  * ``attend_prefill``     — causal attention over the prompt through the
                             flash kernel (``ops.flash_attention``: the CUDA
                             kernel on the card at every length, the
                             materialized twin on the CPU); also returns the
                             pre-RoPE K and V for the cache builds.
  * ``attend_decode_full`` — one-token decode against a full-precision cache
                             of post-RoPE keys (the SALS skip layers and the
                             SALS-disabled baseline).  The cache tensors are
                             updated IN PLACE (the reference returns new
                             arrays).

The SALS decode path is ``core/sparse_attention.py``; it reuses
``qkv_proj`` / ``out_proj`` from here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, frozen_param,
                                       truncated_normal_)

NEG_INF = -2.0 ** 30


class Attention(nn.Module):
    """wq (d, q_dim), wk/wv (d, kv_dim), wo (q_dim, d) [+ biases]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

        def e(*shape):
            return frozen_param(torch.empty(shape, dtype=dtype, device=device))

        self.wq, self.wk, self.wv, self.wo = e(d, qd), e(d, kvd), e(d, kvd), \
            e(qd, d)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = e(qd), e(kvd), e(kvd)
            for bias in (self.bq, self.bk, self.bv):
                bias.data.zero_()

    def init_(self, generator: torch.Generator) -> None:
        d, qd = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            truncated_normal_(w.data, d ** -0.5, generator)
        truncated_normal_(self.wo.data, qd ** -0.5, generator)


def qkv_proj(params: Attention, x: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,dh), k/v (B,S,Hkv,dh).  No RoPE applied."""
    b, s, _ = x.shape
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def out_proj(params: Attention, attn_out: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """attn_out: (B, S, H, dh) -> (B, S, d)."""
    b, s = attn_out.shape[:2]
    return attn_out.reshape(b, s, cfg.q_dim) @ params.wo


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, Hkv, dh) -> (B, S, Hkv*group, dh) for GQA head expansion."""
    if group == 1:
        return x
    b, s, hkv, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, hkv, group, dh) \
        .reshape(b, s, hkv * group, dh)


def attend_prefill(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor] = None,
                   prefix_len: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over a block; also returns (pre-RoPE K, V).

    Returns (y (B,S,d), k_pre (B,S,Hkv,dh), v (B,S,Hkv,dh)).  K/V go to the
    flash kernel unexpanded: the kernel reads kv head h // group, which is
    the same function as attending ``repeat_kv``'s copy."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k_pre, v = qkv_proj(params, x, cfg)
    q_r = apply_rope(q, positions, cfg.rope_theta) if cfg.use_rope else q
    k_r = apply_rope(k_pre, positions, cfg.rope_theta) if cfg.use_rope \
        else k_pre
    o = ops.flash_attention(q_r.contiguous(), k_r.contiguous(),
                            v.contiguous(),
                            causal=cfg.causal and not prefix_len,
                            softcap=cfg.attn_logit_softcap,
                            prefix_len=prefix_len)
    return out_proj(params, o, cfg), k_pre, v


def attend_decode_full(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, pos
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a full-precision cache.

    x: (B, 1, d); k_cache/v_cache: (B, S_max, Hkv, dh), k_cache holding
    post-RoPE keys; pos: scalar or (B,) per-row positions.  The new token's
    K/V are written into the caches in place.  Logits and the value sum are
    taken in f32 over the cache's working-dtype values, as the reference's
    ``preferred_element_type=f32`` contractions are.
    Returns (y, k_cache, v_cache)."""
    b = x.shape[0]
    dev = x.device
    pos_v = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1) \
        .expand(b)
    q, k, v = qkv_proj(params, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, pos_v[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_v[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=dev)
    k_cache[rows, pos_v] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, pos_v] = v[:, 0].to(v_cache.dtype)
    s_max = k_cache.shape[1]
    valid = torch.arange(s_max, device=dev)[None, :] <= pos_v[:, None]
    q_g = q[:, 0].reshape(b, cfg.n_kv_heads, cfg.group_size, cfg.head_dim)
    logits = torch.einsum("bkrd,bskd->bkrs", q_g.float(),
                          k_cache.to(q.dtype).float()) \
        * cfg.head_dim ** -0.5
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrs,bskd->bkrd", p.to(q.dtype).float(),
                     v_cache.to(q.dtype).float())
    o = o.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return out_proj(params, o, cfg), k_cache, v_cache


def init_full_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device="cuda") -> dict:
    """Cache of one full-precision layer."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
