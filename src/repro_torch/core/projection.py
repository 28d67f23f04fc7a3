"""Latent-space projection (paper §4.2, Lemma 1), port of
``repro/core/projection.py``.

``U_r`` (kv_dim × r) holds the leading eigenvectors of the pre-RoPE key
covariance, ordered by descending eigenvalue, so the leading r* latent dims
carry the most energy.  K̃ = K·U_r; K ≈ K̃·U_rᵀ.  The eigendecomposition
runs in float64 on whatever device holds the covariance.
"""
from __future__ import annotations

import numpy as np
import torch


def fit_projector_from_cov(cov: torch.Tensor, rank: int) -> dict:
    """cov: (kv_dim, kv_dim) f64.  Returns {"u": (kv_dim, rank) f32,
    "eigvals": (kv_dim,) f32 descending}."""
    eigvals, eigvecs = torch.linalg.eigh(cov.double())       # ascending
    order = torch.argsort(eigvals, descending=True)
    return {"u": eigvecs[:, order[:rank]].float(),
            "eigvals": eigvals[order].float()}


def fit_projector(keys, rank: int) -> dict:
    """PCA fit from calibration keys (n_samples, kv_dim) — numpy or torch."""
    k = torch.as_tensor(np.asarray(keys) if not torch.is_tensor(keys)
                        else keys).double()
    return fit_projector_from_cov(k.T @ k, rank)


def to_latent(u: torch.Tensor, k_flat: torch.Tensor) -> torch.Tensor:
    """K̃ = K·U_r. k_flat: (..., kv_dim) -> (..., r) in k_flat's dtype."""
    return (k_flat.float() @ u.float()).to(k_flat.dtype)


def reconstruct(u: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """K ≈ K̃·U_rᵀ. lat: (..., r) -> (..., kv_dim)."""
    return (lat.float() @ u.float().T).to(lat.dtype)
