"""Latent-space projection (paper §4.2, Lemma 1), port of
``repro/core/projection.py``.

``U_r`` (kv_dim × r) holds the leading eigenvectors of the pre-RoPE key
covariance, ordered by descending eigenvalue, so the leading r* latent dims
carry the most energy.  K̃ = K·U_r; K ≈ K̃·U_rᵀ.  The eigendecomposition
runs in float64 on whatever device holds the covariance.

Two groupings, as the reference's: one projector over all kv heads
(:func:`fit_projector`, the paper's default) and a block-diagonal one with
an independent PCA per kv-head group (:func:`fit_projector_grouped`).
:func:`random_projector` is the uncalibrated stand-in: the QR of a
Gaussian matrix, drawn (:func:`gaussian`) and factored
(:func:`orthonormal_projector`) in separate steps.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _eigh_desc(cov: torch.Tensor):
    """(eigvals, eigvecs) of a symmetric matrix in f64, by descending
    eigenvalue."""
    eigvals, eigvecs = torch.linalg.eigh(cov.double())       # ascending
    order = torch.argsort(eigvals, descending=True)
    return eigvals[order], eigvecs[:, order]


def fit_projector_from_cov(cov: torch.Tensor, rank: int) -> dict:
    """cov: (kv_dim, kv_dim) f64.  Returns {"u": (kv_dim, rank) f32,
    "eigvals": (kv_dim,) f32 descending}."""
    eigvals, eigvecs = _eigh_desc(cov)
    return {"u": eigvecs[:, :rank].float(), "eigvals": eigvals.float()}


def _keys_f64(keys) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keys) if not torch.is_tensor(keys)
                           else keys).double()


def fit_projector(keys, rank: int) -> dict:
    """PCA fit from calibration keys (n_samples, kv_dim) — numpy or torch."""
    k = _keys_f64(keys)
    return fit_projector_from_cov(k.T @ k, rank)


def fit_projector_grouped(keys, rank: int, n_groups: int) -> dict:
    """Block-diagonal projector: an independent PCA per kv-head group of
    kv_dim / G channels, rank / G columns each (Lemma 1's B_r set), the
    covariance and ``eigh`` in f64 on the keys' device.  Returns {"u":
    (kv_dim, rank) f32 with disjoint row blocks, "eigvals": (G, kv_dim/G)
    f32 descending per group}."""
    k = _keys_f64(keys)
    kv_dim = k.shape[-1]
    if kv_dim % n_groups or rank % n_groups:
        raise ValueError(f"kv_dim {kv_dim} and rank {rank} must be "
                         f"divisible by n_groups {n_groups}")
    gd, gr = kv_dim // n_groups, rank // n_groups
    u = torch.zeros((kv_dim, rank), dtype=torch.float64, device=k.device)
    eigvals = []
    for g in range(n_groups):
        blk = k[:, g * gd:(g + 1) * gd]
        ev, evec = _eigh_desc(blk.T @ blk)
        u[g * gd:(g + 1) * gd, g * gr:(g + 1) * gr] = evec[:, :gr]
        eigvals.append(ev)
    return {"u": u.float(), "eigvals": torch.stack(eigvals).float()}


def gaussian(kv_dim: int, generator: Optional[torch.Generator] = None,
             device="cpu") -> torch.Tensor:
    """A (kv_dim, kv_dim) f32 standard-normal matrix on ``device``
    (``generator`` lives there too)."""
    return torch.randn((kv_dim, kv_dim), generator=generator,
                       dtype=torch.float32, device=device)


def orthonormal_projector(g: torch.Tensor, rank: int) -> dict:
    """The first ``rank`` columns of the QR of a square f32 matrix ``g``,
    and all-one eigenvalues: {"u": (kv_dim, rank) f32, "eigvals":
    (kv_dim,) f32}."""
    q, _ = torch.linalg.qr(g.float())
    return {"u": q[:, :rank],
            "eigvals": torch.ones(g.shape[0], dtype=torch.float32,
                                  device=g.device)}


def random_projector(kv_dim: int, rank: int,
                     generator: Optional[torch.Generator] = None,
                     device="cpu") -> dict:
    """Orthonormal random projector — used for tests and un-calibrated
    init (the reference draws its matrix from ``jax.random``)."""
    return orthonormal_projector(gaussian(kv_dim, generator, device), rank)


def to_latent(u: torch.Tensor, k_flat: torch.Tensor) -> torch.Tensor:
    """K̃ = K·U_r. k_flat: (..., kv_dim) -> (..., r) in k_flat's dtype."""
    return (k_flat.float() @ u.float()).to(k_flat.dtype)


def reconstruct(u: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """K ≈ K̃·U_rᵀ. lat: (..., r) -> (..., kv_dim)."""
    return (lat.float() @ u.float().T).to(lat.dtype)


def captured_energy(eigvals, rank: int) -> torch.Tensor:
    """Fraction of total variance captured by the leading ``rank``
    components (eigvals descending, last axis)."""
    ev = torch.as_tensor(eigvals)
    return torch.sum(ev[..., :rank], dim=-1) / \
        torch.clamp_min(torch.sum(ev, dim=-1), 1e-12)


def effective_rank(eigvals, v: float = 90.0) -> int:
    """Rank_l(v) (the Loki metric of the paper's appendix): the smallest d
    whose top-d eigenvalues capture at least v% of the total variance.
    A handful of values, summed on the host in float64."""
    ev = np.sort(np.asarray(torch.as_tensor(eigvals).detach().cpu(),
                            np.float64))[::-1]
    total = ev.sum()
    if total <= 0:
        return len(ev)
    c = np.cumsum(ev) / total
    return int(np.searchsorted(c, v / 100.0) + 1)
