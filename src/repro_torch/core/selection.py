"""Critical-token selection in latent space (paper §4.3), port of
``repro/core/selection.py``.

The query is head-group-summed, projected by U_r and truncated to r*; it is
scored against the leading r* dims of every cached latent (fused with the
top-N_c in ``kernels.ops.latent_topk`` on the decode path; as plain (B, S)
scores through ``kernels.ops.latent_score`` + :func:`topk_global` for the
quality metrics).  :func:`topk_grouped` is the per-slab top-⌈N_c/G⌉ of the
grouped layout stated on plain scores: the oracle of the decode path's
slab fold (``core/sparse_attention.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_desc_stable

NEG = -2.0 ** 30


def group_query(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sum query heads within each kv group: (B, H, dh) -> (B, kv_dim)."""
    b = q.shape[0]
    qg = q.reshape(b, cfg.n_kv_heads, cfg.group_size, cfg.head_dim)
    return torch.sum(qg, dim=2).reshape(b, cfg.kv_dim)


def latent_scores(q_bar: torch.Tensor, u: torch.Tensor, k_lat: torch.Tensor,
                  r_star: int) -> torch.Tensor:
    """s_j = q̃[:r*]·k̃_j[:r*].  q_bar: (B, kv_dim); k_lat: (B, S, r).
    Returns (B, S) f32 through ``ops.latent_score`` (the CUDA kernel on the
    card)."""
    return ops.latent_score(latent_query(q_bar, u, r_star), k_lat)


def latent_query(q_bar: torch.Tensor, u: torch.Tensor,
                 r_star: int) -> torch.Tensor:
    """Truncated latent query q̃[:r*]: (B, kv_dim) -> (B, r*) f32."""
    return q_bar.float() @ u[:, :r_star].float()


def sort_selected(idx: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder the selected set ascending by position, invalid slots last
    (stable), which fixes the kernels' accumulation order."""
    big = torch.iinfo(torch.int32).max
    key = torch.where(valid, idx, torch.full_like(idx, big))
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(idx, -1, order), torch.gather(valid, -1, order)


def selectable_mask(seq_positions: torch.Tensor, pos,
                    sals: SALSConfig) -> torch.Tensor:
    """True where a cached token may be SELECTED: not a sink, not in the
    recent ring, already written.  seq_positions: integer positions."""
    return (seq_positions >= sals.n_sink) & \
        (seq_positions <= pos - sals.n_recent)


def topk_global(scores: torch.Tensor, mask: torch.Tensor, n_critical: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper-faithful top-N_c.  scores/mask: (B, S).  Returns (idx (B, Nc)
    int32, valid (B, Nc) bool); ``valid`` is False for slots that fell on
    masked entries.  Ties go to the lower index, as ``lax.top_k`` breaks
    them (a stable descending sort, never ``torch.topk``)."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG))
    vals, idx = topk_desc_stable(masked, n_critical)
    return idx.to(torch.int32), vals > NEG / 2


def topk_grouped(scores: torch.Tensor, mask: torch.Tensor, n_critical: int,
                 n_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slab top-k: (B, S) -> (idx (B, G, ⌈N_c/G⌉) int32, valid), the
    indices LOCAL to each of the G slabs of S/G positions (slab g holds
    positions g·S/G ..).  Ties go to the lower index, as in
    :func:`topk_global`."""
    b, s = scores.shape
    if s % n_groups:
        raise ValueError(f"S {s} must be divisible by n_groups {n_groups}")
    k_loc = -(-n_critical // n_groups)
    sg = torch.where(mask, scores, torch.full_like(scores, NEG)) \
        .reshape(b, n_groups, s // n_groups)
    vals, idx = topk_desc_stable(sg, k_loc)
    return idx.to(torch.int32), vals > NEG / 2


def window_query(q_win: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Scoring query of a speculative verify window: (B, Q, H, dh) ->
    (B, kv_dim).  Latent scores are RoPE-free, so one selection serves the
    window; the FIRST window token (always committed) anchors it, and at
    Q = 1 this is the sequential scoring query."""
    return group_query(q_win[:, 0], cfg)


def ring_positions(pos, n_recent: int) -> torch.Tensor:
    """Global position held by each ring slot at decode step ``pos`` (after
    the current token was inserted at slot pos % W); negative -> empty.
    ``pos`` scalar -> (W,); (B,) -> (B, W); (B, Q) per-query window
    positions -> (B, Q, W) (query t sees the ring as of step base + t)."""
    p = torch.as_tensor(pos)
    i = torch.arange(n_recent, device=p.device)
    if p.dim() >= 1:
        p = p[..., None]
    return p - torch.remainder(p - i, n_recent)   # floored: non-negative
