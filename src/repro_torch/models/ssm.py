"""State-space sequence mixers: Mamba2-style SSD heads (hymba) and RWKV6
— port of ``repro/models/ssm.py``.

The Mamba head (hymba's parallel-SSM branch) uses the chunked SSD form:
within a chunk of ``SSD_CHUNK`` tokens a masked quadratic product, across
chunks a carried state (a Python loop over chunks here, a ``lax.scan``
there).  RWKV6 (Finch) has data-dependent per-channel decay; its wkv
recurrence runs token by token over a (B, H, hs, hs) state.  The
reference runs both recurrences as scans with no Pallas kernel, so plain
PyTorch is their counterpart.

Which parameters are f32 follows the reference's initializers: the
Mamba ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip`` and the RWKV ``mu``,
``w0``, ``w_lora_a`` / ``w_lora_b``, ``bonus_u``, ``mu_cm``; the rest are in
the model dtype.  The decode functions return new state tensors; the
transformer copies them into the cache's own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import frozen_param, truncated_normal_

SSD_CHUNK = 128
RWKV_LORA = 64


def _param(shape, dtype, device) -> nn.Parameter:
    return frozen_param(torch.empty(shape, dtype=dtype, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ===========================================================================
# Mamba2-style multihead SSD (hymba parallel branch)
# ===========================================================================

class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        h, p, n = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
        inner = h * p
        f32 = torch.float32
        self.w_in = _param((d, 2 * inner), dtype, device)     # x, z
        self.conv = _param((cfg.ssm_conv, inner), dtype, device)
        self.w_dt = _param((d, h), f32, device)
        self.dt_bias = frozen_param(torch.zeros(h, dtype=f32, device=device))
        self.a_log = frozen_param(torch.zeros(h, dtype=f32, device=device))
        self.d_skip = frozen_param(torch.ones(h, dtype=f32, device=device))
        self.w_bc = _param((d, 2 * n), dtype, device)          # B, C
        self.w_out = _param((inner, d), dtype, device)
        self.norm_scale = frozen_param(torch.ones(inner, dtype=dtype,
                                                  device=device))

    def init_(self, generator: torch.Generator) -> None:
        d = self.w_in.shape[0]
        inner = self.w_out.shape[0]
        std = d ** -0.5
        truncated_normal_(self.w_in.data, std, generator)
        truncated_normal_(self.conv.data, 0.2, generator)
        truncated_normal_(self.w_dt.data, std, generator)
        truncated_normal_(self.w_bc.data, std, generator)
        truncated_normal_(self.w_out.data, inner ** -0.5, generator)


def mamba_specs(cfg: ModelConfig) -> dict:
    return {
        "w_in": P(None, "model"),
        "conv": P(None, "model"),
        "w_dt": P(None, None),
        "dt_bias": P(None),
        "a_log": P(None),
        "d_skip": P(None),
        "w_bc": P(None, None),
        "w_out": P("model", None),
        "norm_scale": P("model"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C), w: (K, C); ``state`` (B, K-1,
    C) holds the K-1 inputs before x."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+K-1, C)
    s = x.shape[1]
    return sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))


def _ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor,
                    h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: h_t = exp(A·dt_t)·h_{t-1} + dt_t·(x_t ⊗ B_t);
    y_t = C_t·h_t.

    x: (B, S, H, P) f32; dt: (B, S, H) f32 (post-softplus); a_log: (H,);
    bmat / cmat: (B, S, N); h0: (B, H, P, N).  Returns (y (B, S, H, P),
    h_final).  S must be a multiple of min(SSD_CHUNK, S)."""
    b, s, h, p = x.shape
    q = min(SSD_CHUNK, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    neg_a = -torch.exp(a_log)                          # (H,) < 0
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h_c = h0
    ys = []
    for c0 in range(0, s, q):
        xc, dtc = x[:, c0:c0 + q], dt[:, c0:c0 + q]
        bc, cc = bmat[:, c0:c0 + q], cmat[:, c0:c0 + q]
        la = dtc * neg_a                               # (B, q, H)
        lcum = torch.cumsum(la, dim=1)                 # L_t inclusive
        # inter-chunk: y_in[t] = exp(L_t) * C_t · h_in
        y_in = torch.einsum("bqn,bhpn->bqhp", cc, h_c) \
            * torch.exp(lcum)[..., None]
        # within-chunk: scores[t,s] = (C_t·B_s)·exp(L_t-L_s)·dt_s, s<=t
        cb = torch.einsum("bqn,bkn->bqk", cc, bc)      # (B, q, q)
        ldiff = lcum[:, :, None, :] - lcum[:, None, :, :]   # (B, q, k, H)
        dec = torch.where(mask[None, :, :, None], torch.exp(ldiff), zero)
        scores = cb[:, :, :, None] * dec * dtc[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", scores, xc)
        # h_out = exp(L_Q)·h_in + Σ_s exp(L_Q-L_s)·dt_s·x_s⊗B_s
        ltot = lcum[:, -1, :]                          # (B, H)
        w_s = torch.exp(ltot[:, None, :] - lcum) * dtc
        h_c = torch.exp(ltot)[:, :, None, None] * h_c + \
            torch.einsum("bqh,bqhp,bqn->bhpn", w_s, xc, bc)
        ys.append(y_in + y_intra)
    return torch.cat(ys, dim=1), h_c


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
         ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _conv_tail(x: torch.Tensor, k: int, prev) -> torch.Tensor:
    """The last k-1 raw conv inputs (decode continues from them)."""
    b, s, c = x.shape
    if s >= k - 1:
        return x[:, s - (k - 1):, :].float()
    pad = torch.zeros((b, k - 1 - s, c), dtype=torch.float32,
                      device=x.device) if prev is None \
        else prev[:, s:, :].float()
    return torch.cat([pad, x.float()], dim=1)


def mamba_apply(params: Mamba, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None, return_state: bool = False):
    """Full-sequence SSD.  x: (B, S, d) -> (B, S, d) [, state {"ssm":
    (B, H, P, N) f32, "conv": (B, K-1, inner) f32}]."""
    b, s, d = x.shape
    h, p, n = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
    inner = h * p
    xz = x @ params.w_in
    xs, z = xz[..., :inner], xz[..., inner:]
    conv_state_in = None if state is None else state["conv"]
    xs = F.silu(_causal_conv(xs, params.conv, conv_state_in))
    dt = _softplus(x.float() @ params.w_dt + params.dt_bias)   # (B, S, H)
    bc = (x @ params.w_bc).float()
    bmat, cmat = bc[..., :n], bc[..., n:]                      # (B, S, N)
    xh = xs.reshape(b, s, h, p).float()
    h0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if state is None else state["ssm"].float()
    y, h_fin = _ssd_chunk_scan(xh, dt, params.a_log, bmat, cmat, h0)
    y = y + params.d_skip[None, None, :, None] * xh
    y = y.reshape(b, s, inner).to(x.dtype)
    y = _rms(y, params.norm_scale) * F.silu(z)
    out = y @ params.w_out
    if return_state:
        return out, {"ssm": h_fin.float(),
                     "conv": _conv_tail(xz[..., :inner],
                                        params.conv.shape[0], conv_state_in)}
    return out


def mamba_decode(params: Mamba, x: torch.Tensor, cfg: ModelConfig,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """One-token SSD update.  x: (B, 1, d); state {"ssm": (B, H, P, N),
    "conv": (B, K-1, inner)}.  Returns (y (B, 1, d), new state)."""
    b = x.shape[0]
    h, p, n = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
    inner = h * p
    xz = x @ params.w_in
    xs_raw, z = xz[..., :inner], xz[..., inner:]               # (B, 1, inner)
    conv_in = torch.cat([state["conv"].to(x.dtype), xs_raw], dim=1)
    xs = F.silu(torch.sum(conv_in * params.conv[None], dim=1, keepdim=True))
    dt = _softplus(x.float() @ params.w_dt + params.dt_bias)[:, 0]  # (B, H)
    bc = (x @ params.w_bc).float()[:, 0]
    bmat, cmat = bc[..., :n], bc[..., n:]                      # (B, N)
    xh = xs.reshape(b, h, p).float()
    decay = torch.exp(dt * (-torch.exp(params.a_log)))         # (B, H)
    h_new = decay[:, :, None, None] * state["ssm"] + \
        torch.einsum("bh,bhp,bn->bhpn", dt, xh, bmat)
    y = torch.einsum("bn,bhpn->bhp", cmat, h_new)
    y = y + params.d_skip[None, :, None] * xh
    y = y.reshape(b, 1, inner).to(x.dtype)
    y = _rms(y, params.norm_scale) * F.silu(z)
    out = y @ params.w_out
    return out, {"ssm": h_new, "conv": conv_in[:, 1:, :].float()}


def mamba_state_init(cfg: ModelConfig, batch: int, device) -> dict:
    h, p, n = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, h, p, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, h * p),
                            dtype=torch.float32, device=device),
    }


# ===========================================================================
# RWKV6 (Finch): data-dependent decay time-mix + squared-relu channel-mix
# ===========================================================================

class RWKV(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hs = cfg.d_model, cfg.rwkv_head_size
        h = d // hs
        f32 = torch.float32
        self.mu = _param((5, d), f32, device)                 # r,k,v,g,w
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _param((d, d), dtype, device))
        self.w0 = _param((d,), f32, device)
        self.w_lora_a = _param((d, RWKV_LORA), f32, device)
        self.w_lora_b = _param((RWKV_LORA, d), f32, device)
        self.bonus_u = _param((h, hs), f32, device)
        self.ln_scale = frozen_param(torch.ones(d, dtype=dtype,
                                                device=device))
        self.mu_cm = _param((2, d), f32, device)
        self.cm_k = _param((d, cfg.d_ff), dtype, device)
        self.cm_v = _param((cfg.d_ff, d), dtype, device)
        self.cm_r = _param((d, d), dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        d, d_ff = self.cm_k.shape
        std = d ** -0.5
        truncated_normal_(self.mu.data, 0.5, generator)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            truncated_normal_(getattr(self, name).data, std, generator)
        truncated_normal_(self.w0.data, 0.5, generator)
        truncated_normal_(self.w_lora_a.data, std, generator)
        truncated_normal_(self.w_lora_b.data, RWKV_LORA ** -0.5, generator)
        truncated_normal_(self.bonus_u.data, 0.5, generator)
        truncated_normal_(self.mu_cm.data, 0.5, generator)
        truncated_normal_(self.cm_k.data, std, generator)
        truncated_normal_(self.cm_v.data, d_ff ** -0.5, generator)
        truncated_normal_(self.cm_r.data, std, generator)


def rwkv_specs(cfg: ModelConfig) -> dict:
    return {
        "mu": P(None, None),
        "w_r": P(None, "model"), "w_k": P(None, "model"),
        "w_v": P(None, "model"), "w_g": P(None, "model"),
        "w_o": P("model", None),
        "w0": P(None), "w_lora_a": P(None, None), "w_lora_b": P(None, None),
        "bonus_u": P(None, None), "ln_scale": P(None),
        "mu_cm": P(None, None),
        "cm_k": P(None, "model"), "cm_v": P("model", None),
        "cm_r": P(None, "model"),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """x_{t-1} with a carried boundary token.  x: (B, S, d); prev: (B, d)."""
    first = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _groupnorm_heads(y: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm (RWKV's group norm).  y: (B, S, H, hs) ->
    (B, S, H·hs) f32."""
    y32 = y.float()
    mean = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, unbiased=False, keepdim=True)
    yn = (y32 - mean) * torch.rsqrt(var + eps)
    b, s, h, hs = y.shape
    return yn.reshape(b, s, h * hs) * scale.float()


def rwkv_time_mix(params: RWKV, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Finch time-mix over a sequence.  Returns (y, wkv_state (B, H, hs,
    hs) f32, last_x (B, d) f32)."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    xp = _shift(x, None if state is None else state["tm_x"])
    mu = params.mu
    xr, xk, xv, xg, xw = (_lerp(x, xp, mu[i]) for i in range(5))
    r = (xr @ params.w_r).reshape(b, s, h, hs).float()
    k = (xk @ params.w_k).reshape(b, s, h, hs).float()
    v = (xv @ params.w_v).reshape(b, s, h, hs).float()
    g = F.silu(xg @ params.w_g)
    # data-dependent decay (the Finch contribution)
    dw = torch.tanh(xw.float() @ params.w_lora_a) @ params.w_lora_b
    logw = -torch.exp(params.w0 + dw)                   # (B, S, d), < 0
    w = torch.exp(logw).reshape(b, s, h, hs)            # decay in (0, 1)
    u = params.bonus_u[None, :, :, None]

    wkv = torch.zeros((b, h, hs, hs), dtype=torch.float32, device=x.device) \
        if state is None else state["wkv"]
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hs, hs)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], wkv + u * kv))
        wkv = w[:, t, :, :, None] * wkv + kv
    y = torch.stack(ys, dim=1)                          # (B, S, H, hs)
    y = _groupnorm_heads(y, params.ln_scale).to(x.dtype)
    out = (y * g) @ params.w_o
    return out, wkv, x[:, -1, :].float()


def rwkv_channel_mix(params: RWKV, x: torch.Tensor, state: Optional[dict]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    xp = _shift(x, None if state is None else state["cm_x"])
    xk = _lerp(x, xp, params.mu_cm[0])
    xr = _lerp(x, xp, params.mu_cm[1])
    kk = torch.square(torch.relu(xk @ params.cm_k))
    out = torch.sigmoid(xr @ params.cm_r) * (kk @ params.cm_v)
    return out, x[:, -1, :].float()


def rwkv_state_init(cfg: ModelConfig, batch: int, device) -> dict:
    d, hs = cfg.d_model, cfg.rwkv_head_size
    h = d // hs
    f32 = torch.float32
    return {
        "wkv": torch.zeros((batch, h, hs, hs), dtype=f32, device=device),
        "tm_x": torch.zeros((batch, d), dtype=f32, device=device),
        "cm_x": torch.zeros((batch, d), dtype=f32, device=device),
    }
