"""SALS quality metrics: the overlap score (paper §3.2, Fig. 2), the rank of
keys before and after RoPE (paper appendix A, Fig. 4) and the projector's
reconstruction error.  Port of ``repro/core/metrics.py``; everything runs
on the device of its inputs."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core import selection as sel
from repro_torch.core.projection import effective_rank
from repro_torch.models.layers import apply_rope


def overlap_score(q: torch.Tensor, k_pre: torch.Tensor, u: torch.Tensor,
                  cfg: ModelConfig, sals: SALSConfig, pos: int
                  ) -> torch.Tensor:
    """OS = Σ_{i∈C} p_i / Σ_i p_i for one decode query.

    q: (B, H, dh) pre-RoPE query at position ``pos``; k_pre: (B, S, Hkv,
    dh) pre-RoPE keys of the context (S <= pos+1).  C = latent top-N_c ∪
    sink ∪ recent (the full SALS selection); the latent scores go through
    ``ops.latent_score`` (one launch of the CUDA kernel on the card).  The
    full attention mass p is taken with RoPE, as the model would.
    Returns (B,) f32."""
    b, s = k_pre.shape[:2]
    dev = k_pre.device
    r_star = sals.score_rank(cfg.kv_dim)
    ar = torch.arange(s, device=dev)

    # full attention distribution (head-averaged, post-RoPE: the reference)
    if cfg.use_rope:
        q_r = apply_rope(q[:, None], torch.full((b, 1), pos, device=dev),
                         cfg.rope_theta)[:, 0]
        k_r = apply_rope(k_pre, ar[None, :], cfg.rope_theta)
    else:
        q_r, k_r = q, k_pre
    kk = torch.repeat_interleave(k_r, cfg.group_size, dim=2)   # (B,S,H,dh)
    logits = torch.einsum("bhd,bshd->bhs", q_r.float(), kk.float()) \
        * cfg.head_dim ** -0.5
    p_tok = torch.softmax(logits, dim=-1).mean(dim=1)        # (B, S)

    # SALS selection
    q_bar = sel.group_query(q, cfg)
    k_lat = k_pre.reshape(b, s, cfg.kv_dim).float() @ u.float()
    scores = sel.latent_scores(q_bar, u, k_lat, r_star)
    mask = sel.selectable_mask(ar, pos, sals)[None, :].expand(b, s)
    idx, valid = sel.topk_global(scores, mask, min(sals.n_critical, s))
    selected = torch.zeros((b, s), dtype=torch.bool, device=dev)
    selected[torch.arange(b, device=dev)[:, None], idx.long()] = valid
    always = (ar < sals.n_sink) | (ar > pos - sals.n_recent)
    seen = ar <= pos
    keep = (selected | always[None, :]) & seen[None, :]
    zero = torch.zeros((), device=dev)
    return torch.where(keep, p_tok, zero).sum(-1) / torch.clamp_min(
        torch.where(seen[None, :], p_tok, zero).sum(-1), 1e-9)


def rank_pre_post_rope(k_pre: torch.Tensor, cfg: ModelConfig,
                       v: float = 90.0
                       ) -> Tuple[int, int, torch.Tensor, torch.Tensor]:
    """Effective Rank_l(v) of keys before vs after RoPE (paper Fig. 4).

    k_pre: (n, Hkv, dh) pre-RoPE keys at positions 0..n-1 (a tensor, or an
    array taken to the CPU).  The (kv_dim, kv_dim) covariances and their
    float64 eigenvalues are computed on the keys' device.  Returns
    (rank_pre, rank_post, eig_pre, eig_post), eigenvalues descending."""
    k_pre = torch.as_tensor(k_pre)
    n = k_pre.shape[0]
    k_post = apply_rope(k_pre[None], torch.arange(n, device=k_pre.device)
                        [None], cfg.rope_theta)[0]

    def spec(k):
        flat = k.double().reshape(n, -1)
        return torch.flip(torch.linalg.eigvalsh(flat.T @ flat), dims=(0,))

    ev_pre, ev_post = spec(k_pre), spec(k_post)
    return (effective_rank(ev_pre, v), effective_rank(ev_post, v),
            ev_pre, ev_post)


def latent_mse(k_pre: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Relative reconstruction error of the rank-r projector on keys:
    ‖K − K·U·Uᵀ‖² / ‖K‖²."""
    flat = k_pre.reshape(-1, k_pre.shape[-2] * k_pre.shape[-1]) \
        if k_pre.dim() > 2 else k_pre
    flat = flat.float()
    uf = u.float()
    rec = (flat @ uf) @ uf.T
    return torch.sum((flat - rec) ** 2) / torch.clamp_min(
        torch.sum(flat ** 2), 1e-9)
