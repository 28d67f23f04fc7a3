"""Offline calibration (paper §4.2 / §5.1), port of
``repro/core/calibration.py``.

Runs the model over calibration batches, collects pre-RoPE keys per layer
and fits one rank-r PCA projector per layer.  At full width (kv_dim 4096,
32 layers) the reference's host-side f64 eigh is slow, so the port
accumulates each layer's key covariance on the model's device in float64
and takes ``torch.linalg.eigh`` there; :func:`collect_keys` keeps the
reference's materialized form for small runs and tests.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.projection import fit_projector, fit_projector_from_cov

U_DTYPE = torch.bfloat16   # stored projector dtype (consumers upcast to f32)


def collect_keys(key_fn: Callable[[torch.Tensor], torch.Tensor],
                 batches: Iterable[np.ndarray],
                 max_tokens: int = 65_536) -> torch.Tensor:
    """Run ``key_fn(tokens) -> (L, B, S, kvd)`` over batches and stack to
    (L, n_tokens, kvd) f32 on the host, capped at ``max_tokens``."""
    chunks, n = [], 0
    for tokens in batches:
        k = key_fn(tokens).float().cpu()
        l, b, s, kvd = k.shape
        chunks.append(k.reshape(l, b * s, kvd))
        n += b * s
        if n >= max_tokens:
            break
    return torch.cat(chunks, dim=1)[:, :max_tokens]


def accumulate_covariance(key_fn: Callable[[torch.Tensor], torch.Tensor],
                          batches: Iterable[np.ndarray],
                          max_tokens: int = 65_536) -> torch.Tensor:
    """Σ kᵀk per layer over the same token stream :func:`collect_keys`
    takes (keys cast to f32, then f64), accumulated on the keys' device.
    Returns (L, kvd, kvd) float64."""
    cov, n = None, 0
    for tokens in batches:
        k = key_fn(tokens)
        l, b, s, kvd = k.shape
        k = k.reshape(l, b * s, kvd)[:, :max_tokens - n].float().double()
        part = k.transpose(1, 2) @ k
        cov = part if cov is None else cov + part
        n += k.shape[1]
        if n >= max_tokens:
            break
    return cov


def fit_layer_projectors(keys, rank: int) -> dict:
    """keys: (L, n, kvd) -> {"u": (L, kvd, r) bf16, "eigvals": (L, kvd)}."""
    fits = [fit_projector(keys[l], rank) for l in range(keys.shape[0])]
    return {"u": torch.stack([f["u"] for f in fits]).to(U_DTYPE),
            "eigvals": torch.stack([f["eigvals"] for f in fits])}


def fit_layer_projectors_from_cov(cov: torch.Tensor, rank: int) -> dict:
    """cov: (L, kvd, kvd) f64 -> {"u": (L, kvd, r) bf16, "eigvals"}."""
    fits = [fit_projector_from_cov(cov[l], rank) for l in range(cov.shape[0])]
    return {"u": torch.stack([f["u"] for f in fits]).to(U_DTYPE),
            "eigvals": torch.stack([f["eigvals"] for f in fits])}
