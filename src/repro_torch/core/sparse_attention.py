"""SALS decode attention (paper §4.4, Algorithm 1): port of the global plan
of ``repro/core/sparse_attention.py``.

One decode step per SALS layer:

  1. project the new token's pre-RoPE key to the latent space and append it
     (in place); quantize + append its value; insert (k_pre, v) into the
     recent ring (and the sink while pos < n_sink);
  2-3. score the cached latents with the truncated latent query and take the
     global top-N_c (``ops.latent_topk``: the CUDA kernel on the card);
  4. gather, dequantize and reconstruct only the selected tokens, RoPE them
     at their own positions and attend (``ops.sparse_recon_attention``);
  5. exact attention over the sink + recent window, LSE-merged with step 4.

The grouped (``n_groups > 1``), paged and tiered plans of the reference are
ported in later slices; the cache constructors, the engine and
``kernels.ops`` raise ``NotImplementedError`` for them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core import selection as sel
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.kernels import ops
from repro_torch.models.attention import out_proj, qkv_proj
from repro_torch.models.layers import apply_rope

NEG = sel.NEG


def _region_logits(q_r: torch.Tensor, k_pre: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RoPE + GQA QKᵀ for one region of pre-RoPE keys.  q_r: (B, H, dh)
    RoPE'd query; k_pre: (B, N, Hkv, dh); positions broadcastable to
    (B, N).  Returns (B, H, N) f32 logits (scaled, softcapped)."""
    if cfg.use_rope:
        k = apply_rope(k_pre, positions.expand(k_pre.shape[:-2]),
                       cfg.rope_theta)
    else:
        k = k_pre
    b = q_r.shape[0]
    q_g = q_r.reshape(b, cfg.n_kv_heads, cfg.group_size,
                      cfg.head_dim).float()
    logits = torch.einsum("bkrd,bnkd->bkrn", q_g, k.float())
    logits = logits.reshape(b, cfg.n_heads, k.shape[1])
    logits = logits * (cfg.head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return logits


def _partial_attend(logits: torch.Tensor, v: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-style partial softmax stats over the last axis.  logits:
    (B, H, N) f32; v: (B, N, Hkv, dh) unexpanded.  Returns (m, l, o)."""
    m = torch.max(logits, dim=-1).values
    p = torch.exp(logits - m[..., None])
    p = torch.where(logits <= NEG / 2, torch.zeros_like(p), p)
    l = torch.sum(p, dim=-1)
    b, _, n = logits.shape
    p_g = p.reshape(b, cfg.n_kv_heads, cfg.group_size, n)
    o = torch.einsum("bkrn,bnkd->bkrd", p_g, v.float())
    return m, l, o.reshape(b, cfg.n_heads, cfg.head_dim)


def _global_partials(q0, q_bar, u, cache: LatentKVCache, pos,
                     cfg: ModelConfig, sals: SALSConfig):
    """Paper-faithful global top-N_c → fused recon attention.  Returns
    (m, l, o) with a G=1 axis."""
    r_star = sals.score_rank(cfg.kv_dim)
    k_lat, k_scale = cache.latent_views()
    idx, valid = sel.topk_latent(q_bar, u, k_lat, k_scale, pos, sals, r_star)
    idx, valid = sel.sort_selected(idx, valid)
    m, l, o = ops.sparse_recon_attention(
        q0.contiguous(), k_lat, k_scale, cache.v_q, cache.v_scale,
        cache.v_zero, u, idx, valid, pos, n_kv=cfg.n_kv_heads,
        v_bits=sals.v_bits, v_group=sals.v_group, theta=cfg.rope_theta,
        softcap=cfg.attn_logit_softcap, use_rope=cfg.use_rope)
    return m[:, None], l[:, None], o[:, None]


def sals_decode_attend(params, u: torch.Tensor, cache: LatentKVCache,
                       x: torch.Tensor, pos, cfg: ModelConfig,
                       sals: SALSConfig):
    """One-token SALS attention for one layer (the global plan: the port's
    cache is the dense arena, whose constructors refuse the grouped and
    paged layouts).

    x: (B, 1, d); pos: scalar or (B,) per-row positions; ``cache`` is a
    single-layer view, updated in place.  Returns (y (B, 1, d), cache)."""
    b = x.shape[0]
    dev = x.device
    kvd = cfg.kv_dim
    w = sals.n_recent
    pos_v = torch.as_tensor(pos, device=dev).to(torch.int32).reshape(-1) \
        .expand(b).contiguous()

    q, k_new, v_new = qkv_proj(params, x, cfg)
    k_flat = k_new.reshape(b, kvd)
    v_flat = v_new.reshape(b, kvd)

    # ---- stage 1: append (latent of the new key in f32) -------------------
    k_lat_new = k_flat.float() @ u.float()
    cache.write(sals, pos_v, k_lat_new, v_flat, k_new[:, 0], v_new[:, 0])

    q_bar = sel.group_query(q[:, 0], cfg)
    q_r = (apply_rope(q, pos_v[:, None], cfg.rope_theta)
           if cfg.use_rope else q)[:, 0]

    # ---- sink + recent region (always attended, full precision) ----------
    ns = sals.n_sink
    sink_pos = torch.arange(ns, device=dev)[None, :].expand(b, ns)
    rec_pos = sel.ring_positions(pos_v.long(), w)
    sr_k = torch.cat([cache.sink_k, cache.recent_k], dim=1)
    sr_v = torch.cat([cache.sink_v, cache.recent_v], dim=1)
    sr_positions = torch.cat([sink_pos, rec_pos], dim=1)
    sr_valid = (sr_positions >= 0) & (sr_positions <= pos_v[:, None])
    sr_logits = _region_logits(q_r, sr_k, sr_positions, cfg)
    sr_logits = torch.where(sr_valid[:, None, :], sr_logits,
                            torch.tensor(NEG, device=dev))
    m_sr, l_sr, o_sr = _partial_attend(sr_logits, sr_v, cfg)

    # ---- stages 2-4: fused selected-token partials (B, 1, H[, dh]) ------
    m_c, l_c, o_c = _global_partials(q[:, 0], q_bar, u, cache, pos_v, cfg,
                                     sals)

    # ---- stage 5: LSE merge -----------------------------------------------
    m_all = torch.maximum(torch.max(m_c, dim=1).values, m_sr)
    wc = torch.exp(m_c - m_all[:, None, :])
    wsr = torch.exp(m_sr - m_all)
    denom = torch.sum(wc * l_c, dim=1) + wsr * l_sr
    numer = torch.sum(wc[..., None] * o_c, dim=1) + wsr[..., None] * o_sr
    o = numer / torch.clamp_min(denom, 1e-30)[..., None]
    return out_proj(params, o[:, None].to(x.dtype), cfg), cache
