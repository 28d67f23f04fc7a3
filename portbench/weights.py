"""Seeded weights, made on the device in a few large calls.

The port and the plain reference are handed the SAME tensors: the
benchmark makes them, neither side derives them.  Every linear layer is
drawn at once for all layers (one ``randn`` per kind, in the served
dtype) at the port's initializer scales (std = fan_in^-1/2).

The keys are the one place the draw has structure.  Keys of trained
models are low-rank before RoPE (the premise of SALS, paper §3); keys of
an isotropic random ``W_k`` are not, and their PCA is then decided by
rounding alone, so two correct programs could keep different latent
subspaces.  Each layer's ``W_k`` is therefore ``Q_d · diag(σ) · Q_kᵀ``
with orthonormal ``Q_d`` (d_model × kv_dim) and orthogonal ``Q_k``
(kv_dim × kv_dim), both from the seed, and σ on three plateaus split
at r* and r (``key_sigma``): the kept subspaces have clear eigen-gaps.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.spec import ModelSpec


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _normal(g, shape, std: float, dtype, device) -> torch.Tensor:
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return t.mul_(std)


def _low_rank_keys(g, spec: ModelSpec, device) -> torch.Tensor:
    """(L, d_model, kv_dim) keys of plateau spectrum ``key_sigma``."""
    l, d, kvd = spec.n_layers, spec.d_model, spec.kv_dim
    sig = torch.empty(kvd, dtype=torch.float32, device=device)
    a, b, c = spec.key_sigma
    sig[:spec.r_star] = a
    sig[spec.r_star:spec.r] = b
    sig[spec.r:] = c
    q_d = torch.linalg.qr(torch.randn((l, d, kvd), generator=g,
                                      device=device)).Q
    q_k = torch.linalg.qr(torch.randn((l, kvd, kvd), generator=g,
                                      device=device)).Q
    return ((q_d * sig) @ q_k.transpose(1, 2)).to(spec.torch_dtype)


@torch.no_grad()
def make_weights(spec: ModelSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a dense decoder, stacked over layers: ``embed``
    (V, d), ``lm_head`` (d, V), ``wq`` / ``wk`` / ``wv`` (L, d, ·), ``wo``
    (L, q_dim, d), ``w_gate`` / ``w_up`` (L, d, f), ``w_down`` (L, f, d),
    the norm scales ``attn_norm`` / ``mlp_norm`` (L, d) and
    ``final_norm`` (d), all ones."""
    g = _generator(seed, device)
    dt = spec.torch_dtype
    l, d, f, v = spec.n_layers, spec.d_model, spec.d_ff, spec.vocab_size
    qd, kvd = spec.q_dim, spec.kv_dim

    def normal(shape, fan_in):
        return _normal(g, shape, fan_in ** -0.5, dt, device)

    gain = spec.query_gain
    w = {
        "embed": normal((v, d), d),
        "lm_head": normal((d, v), d),
        "wq": normal((l, d, qd), d / gain ** 2),
        "wv": normal((l, d, kvd), d),
        "wo": normal((l, qd, d), qd),
        "w_gate": normal((l, d, f), d),
        "w_up": normal((l, d, f), d),
        "w_down": normal((l, f, d), f),
        "wk": _low_rank_keys(g, spec, device),
    }
    w["attn_norm"] = torch.ones((l, d), dtype=dt, device=device)
    w["mlp_norm"] = torch.ones((l, d), dtype=dt, device=device)
    w["final_norm"] = torch.ones((d,), dtype=dt, device=device)
    return w


LINEAR = ("lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@torch.no_grad()
def fp8_weights(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The control's weights: every linear layer rounded through fp8
    e4m3 with one scale per output column, back in the served dtype (the
    step below bf16 that would tempt a later change); the embedding and
    the norm scales as they are."""
    out = dict(w)
    for name in LINEAR:
        t = w[name]
        mats = t if t.dim() == 3 else t[None]
        res = torch.empty_like(mats)
        for i in range(mats.shape[0]):        # one layer at a time
            m = mats[i].float()
            scale = m.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) \
                / 448.0
            q = (m / scale).to(torch.float8_e4m3fn)
            res[i] = (q.float() * scale).to(t.dtype)
        out[name] = res if t.dim() == 3 else res[0]
    return out
