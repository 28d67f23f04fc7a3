"""Critical-token selection in latent space (paper §4.3), port of the
global plan of ``repro/core/selection.py``.

The query is head-group-summed, projected by U_r and truncated to r*; it is
scored against the leading r* dims of every cached latent (fused with the
top-N_c in ``kernels.ops.latent_topk``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.kernels import ops

NEG = -2.0 ** 30


def group_query(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sum query heads within each kv group: (B, H, dh) -> (B, kv_dim)."""
    b = q.shape[0]
    qg = q.reshape(b, cfg.n_kv_heads, cfg.group_size, cfg.head_dim)
    return torch.sum(qg, dim=2).reshape(b, cfg.kv_dim)


def latent_query(q_bar: torch.Tensor, u: torch.Tensor,
                 r_star: int) -> torch.Tensor:
    """Truncated latent query q̃[:r*]: (B, kv_dim) -> (B, r*) f32."""
    return q_bar.float() @ u[:, :r_star].float()


def topk_latent(q_bar: torch.Tensor, u: torch.Tensor, k_lat: torch.Tensor,
                k_scale, pos, sals: SALSConfig, r_star: int, *,
                n_critical=None, pos_base=None, page_table=None,
                page_size=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused score → top-N_c over the raw latent cache.  Returns
    (idx (B, N_c) int32, valid (B, N_c) bool)."""
    q_lat = latent_query(q_bar, u, r_star)
    return ops.latent_topk(q_lat, k_lat, k_scale, pos,
                           n_critical=n_critical or sals.n_critical,
                           n_sink=sals.n_sink, n_recent=sals.n_recent,
                           pos_base=pos_base, page_table=page_table,
                           page_size=page_size)


def sort_selected(idx: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder the selected set ascending by position, invalid slots last
    (stable), which fixes the kernels' accumulation order."""
    big = torch.iinfo(torch.int32).max
    key = torch.where(valid, idx, torch.full_like(idx, big))
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(idx, -1, order), torch.gather(valid, -1, order)


def ring_positions(pos, n_recent: int) -> torch.Tensor:
    """Global position held by each ring slot at decode step ``pos`` (after
    the current token was inserted at slot pos % W); negative -> empty.
    ``pos`` scalar -> (W,); (B,) -> (B, W)."""
    p = torch.as_tensor(pos)
    i = torch.arange(n_recent, device=p.device)
    if p.dim() >= 1:
        p = p[..., None]
    return p - torch.remainder(p - i, n_recent)   # floored: non-negative
