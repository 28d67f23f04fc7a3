"""Comparison baselines from the paper's Tables 2-4, port of
``repro/core/baselines.py``.

The selection / compression mechanism of each competitor, so Table 4's
comparison (overlap quality per byte moved) runs on the port:

  palu_mode     — low-rank only (Palu): latent cache, no sparsity — every
                  token reconstructed each step (an all-token SALSConfig);
  kivi_mode     — quantization only (KIVI): full-rank "latent" (U ≈ I),
                  int8 keys, int8/int4 values;
  quest_scores  — Quest: page-level upper-bound scores from per-page
                  (min, max) key summaries;
  ds_scores     — Double Sparsity: token scores from a few high-energy
                  ("outlier") key channels chosen offline.

Each scoring function returns per-token (B, S) scores comparable to
``selection.latent_scores``, so mechanisms rank at equal token budgets.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, SALSConfig

PAGE = 16          # Quest page size (the paper's x=16 granularity)
DS_CHANNELS = 16   # Double-Sparsity label channels


def palu_mode(max_seq: int, rank_ratio: float = 0.25) -> SALSConfig:
    """Low-rank-only cache: select EVERYTHING (full reconstruction)."""
    return SALSConfig(rank_ratio=rank_ratio, score_ratio=1.0,
                      n_critical=max_seq, n_sink=0, n_recent=1,
                      v_bits=8, skip_layers_front=0, skip_layers_back=0)


def kivi_mode(n_critical: int, v_bits: int = 4) -> SALSConfig:
    """Quant-only cache: full-rank 'latent' (U≈I) + int8 keys/int4 values."""
    return SALSConfig(rank_ratio=1.0, score_ratio=1.0,
                      n_critical=n_critical, n_sink=16, n_recent=64,
                      v_bits=v_bits, k_latent_dtype="int8")


# ---------------------------------------------------------------------------
# Quest-style page selection
# ---------------------------------------------------------------------------

def quest_page_summaries(k: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k: (B, S, d) post-RoPE keys -> per-page (min, max): (B, S/PAGE, d)."""
    b, s, d = k.shape
    if s % PAGE:
        raise ValueError(f"sequence {s} is not a whole number of "
                         f"{PAGE}-token pages")
    pages = k.reshape(b, s // PAGE, PAGE, d)
    return pages.amin(dim=2), pages.amax(dim=2)


def quest_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-token scores from Quest's page upper bound.  q: (B, d)
    aggregated query; k: (B, S, d).  Every token inherits its page's bound
    Σ_c max(q_c·min_c, q_c·max_c); returns (B, S)."""
    kmin, kmax = quest_page_summaries(k)
    qe = q[:, None, :]
    ub = torch.maximum(qe * kmin, qe * kmax).sum(-1)           # (B, S/P)
    return torch.repeat_interleave(ub, PAGE, dim=1)


# ---------------------------------------------------------------------------
# Double-Sparsity-style channel selection
# ---------------------------------------------------------------------------

def ds_label_channels(k_calib, n_channels: int = DS_CHANNELS) -> np.ndarray:
    """Offline: the highest-energy key channels (outlier channels) of
    calibration keys (n, d), as host indices."""
    k = np.asarray(torch.as_tensor(k_calib).detach().cpu(), np.float64)
    energy = np.mean(k ** 2, axis=0)
    return np.argsort(energy)[::-1][:n_channels].copy()


def ds_scores(q: torch.Tensor, k: torch.Tensor, channels) -> torch.Tensor:
    """s_j = q[C]·k_j[C] over the label channels.  q: (B, d); k: (B, S, d).
    Returns (B, S) f32."""
    ch = torch.as_tensor(channels, device=q.device).long()
    return torch.einsum("bc,bsc->bs", q.index_select(-1, ch).float(),
                        k.index_select(-1, ch).float())


# ---------------------------------------------------------------------------
# Traffic bookkeeping (paper Table 4 'Memory Access' column)
# ---------------------------------------------------------------------------

def traffic_per_step(method: str, cfg: ModelConfig, s: int, n_sel: int,
                     sals: SALSConfig = None) -> float:
    """Bytes moved per decode step per layer, normalized to full attention.

    full    : 2·s·kvd bf16
    sals    : s·r* latents + n_sel·(r + v_q) + windows (paper §4.5)
    palu    : s·r latents + s·(r + v_q)  — reconstructs everything
    kivi    : s·(kvd int8 + kvd v_bits)  — quant-only, all tokens
    quest   : s/PAGE·2·kvd summaries + n_sel·2·kvd bf16 (no compression)
    ds      : s·DS_CHANNELS bf16 labels + n_sel·2·kvd bf16
    """
    kvd = cfg.kv_dim
    full = 2 * s * kvd * 2.0
    if method == "full":
        return 1.0
    if method == "sals":
        from repro_torch.core import latent_cache as lc
        r = sals.rank(kvd)
        r_star = sals.score_rank(kvd)
        lat_b = 1 if sals.k_latent_dtype == "int8" else 2
        v_b = lc.cache_bytes_per_token(cfg, sals) - r * lat_b
        t = s * r_star * lat_b + n_sel * (r * lat_b + v_b) \
            + (sals.n_sink + sals.n_recent) * 2 * kvd * 2
        return t / full
    if method == "palu":
        r = int(0.25 * kvd)
        return (s * r * 2 + s * (r * 2 + kvd)) / full
    if method == "kivi":
        return (s * (kvd + kvd / 2 + 8)) / full          # int8 K + int4 V
    if method == "quest":
        return (s / PAGE * 2 * kvd * 2 + n_sel * 2 * kvd * 2) / full
    if method == "ds":
        return (s * DS_CHANNELS * 2 + n_sel * 2 * kvd * 2) / full
    raise ValueError(method)
