"""Offline calibration (paper §4.2 / §5.1), port of
``repro/core/calibration.py``.

Runs the model over calibration batches, collects pre-RoPE keys per layer
and fits one rank-r PCA projector per layer.  At full width (kv_dim 4096,
32 layers) the reference's host-side f64 eigh is slow, so the port
accumulates each layer's key covariance on the model's device in float64
and takes ``torch.linalg.eigh`` there; :func:`collect_keys` keeps the
reference's materialized form for small runs and tests.
:func:`random_layer_projectors` is the uncalibrated stand-in (orthonormal
random bases) and :func:`adaptive_ranks` the layer-adaptive rank choice.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core.projection import (fit_projector, fit_projector_from_cov,
                                         gaussian, orthonormal_projector)

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


def adaptive_ranks(eigvals, target_energy: float = 0.90,
                   round_to: int = 8) -> list:
    """Layer-adaptive rank selection (paper appendix A): per layer of
    ``eigvals`` (L, kv_dim), descending, the rank capturing
    ``target_energy`` of the variance, rounded up to ``round_to``.  The
    runtime cache keeps one uniform r; these ranks are bookkeeping."""
    ev = np.asarray(eigvals.detach().cpu() if torch.is_tensor(eigvals)
                    else eigvals, np.float64)
    ranks = []
    for l in range(ev.shape[0]):
        e = np.maximum(ev[l], 0)
        c = np.cumsum(e) / max(e.sum(), 1e-12)
        r = int(np.searchsorted(c, target_energy) + 1)
        ranks.append(max(round_to, ((r + round_to - 1) // round_to)
                         * round_to))
    return ranks


def layer_gaussians(kv_dim: int, n_layers: int,
                    generator: Optional[torch.Generator] = None,
                    device="cpu") -> torch.Tensor:
    """(n_layers, kv_dim, kv_dim) f32 standard-normal matrices on
    ``device``, one per layer, each from its own generator seeded by a draw
    of ``generator`` (made on ``device`` with seed 0 when None): the
    counterpart of the reference's ``jax.random.split`` per layer."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    seeds = torch.randint(0, 2**62, (n_layers,), generator=generator,
                          device=generator.device).tolist()
    return torch.stack([
        gaussian(kv_dim, torch.Generator(device=device).manual_seed(s),
                 device) for s in seeds])


def random_layer_projectors(cfg: ModelConfig, sals: SALSConfig,
                            n_layers: int,
                            generator: Optional[torch.Generator] = None,
                            device="cpu",
                            gaussians: Optional[torch.Tensor] = None) -> dict:
    """Orthonormal random projectors — the placeholder before calibration:
    {"u": (L, kvd, r) bf16, "eigvals": (L, kvd) f32 ones} on ``device``.
    ``gaussians`` (L, kvd, kvd) replaces the draw of
    :func:`layer_gaussians` (a test passes the reference's)."""
    g = layer_gaussians(cfg.kv_dim, n_layers, generator, device) \
        if gaussians is None else gaussians.to(device)
    fits = [orthonormal_projector(g[l], sals.rank(cfg.kv_dim))
            for l in range(n_layers)]
    return {"u": torch.stack([f["u"] for f in fits]).to(U_DTYPE),
            "eigvals": torch.stack([f["eigvals"] for f in fits])}


def projector_specs() -> dict:
    from repro_torch.distributed.sharding import P
    return {"u": P(None, None, None), "eigvals": P(None, None)}
