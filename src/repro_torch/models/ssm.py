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

Under a sharding context a DTensor input runs on local blocks
(:func:`_on_local_blocks`, one ``local_map`` a call): each rank holds its
batch rows with the sequence whole, and its heads where the ``model``
axis divides them (the Mamba heads, the RWKV heads, the channel mix's
hidden units), so no recurrence runs its loop on DTensors.  The outputs
leave a partial sum over the head split; the Mamba norm over the inner
width is one small all-reduce.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import frozen_param, truncated_normal_

SSD_CHUNK = 128
RWKV_LORA = 64
HEAD_AXIS = "model"      # the mesh axis the heads split over


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


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
         split=None) -> torch.Tensor:
    """RMS norm over the last dim; ``split`` (mesh, dims): the dim is
    split over those mesh dims and the mean of squares is summed across
    them."""
    x32 = x.float()
    if split is None:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        mesh, dims = split
        n = x.shape[-1]
        for i in dims:
            n *= mesh.shape[i]
        var = shd.group_sum(torch.sum(x32 * x32, dim=-1, keepdim=True),
                            mesh, dims) / n
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
    if shd.is_dtensor(x):
        out, st = _mamba_sharded(functools.partial(
            _mamba_seq, return_state=True), params, x, cfg, state)
        return (out, st) if return_state else out
    return _mamba_seq(params, x, cfg, state, return_state)


def _mamba_seq(params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[dict] = None, return_state: bool = False,
               split=None):
    """:func:`mamba_apply` on plain tensors; the head count is the
    parameters' (``a_log``'s), and ``split`` is :func:`_rms`'s."""
    b, s, d = x.shape
    h, p, n = params.a_log.shape[0], cfg.head_dim, cfg.ssm_state
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
    y = _rms(y, params.norm_scale, split=split) * F.silu(z)
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
    if shd.is_dtensor(x):
        return _mamba_sharded(_mamba_step, params, x, cfg, state)
    return _mamba_step(params, x, cfg, state)


def _mamba_step(params, x: torch.Tensor, cfg: ModelConfig, state: dict,
                split=None):
    """:func:`mamba_decode` on plain tensors (see :func:`_mamba_seq`)."""
    b = x.shape[0]
    h, p, n = params.a_log.shape[0], cfg.head_dim, cfg.ssm_state
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
    y = _rms(y, params.norm_scale, split=split) * F.silu(z)
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
    if shd.is_dtensor(x):
        return _rwkv_sharded(params, x, cfg, state)
    b, s, _ = x.shape
    hs = cfg.rwkv_head_size
    h = params.w_r.shape[1] // hs
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
    if shd.is_dtensor(x):
        return _channel_mix_sharded(params, x, state)
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


# ===========================================================================
# Sharded runs: every recurrence on local blocks
# ===========================================================================

def _head_dim(x: torch.Tensor, n_heads: int) -> Optional[int]:
    """The mesh dim ``n_heads`` split over for DTensor ``x``: the
    ``HEAD_AXIS`` one where it divides them and does not split ``x``'s
    rows, else None (every rank runs every head)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    if HEAD_AXIS not in names:
        return None
    i = names.index(HEAD_AXIS)
    if mesh.shape[i] == 1 or n_heads % mesh.shape[i] or \
            x.placements[i] == Shard(0):
        return None
    return i


def _on_local_blocks(fn, x: torch.Tensor, n_heads: int, weights: dict,
                     state: Optional[dict], state_out: dict):
    """``fn(x, params, state, (h0, h1), split)`` on each rank's local
    blocks (``local_map``): ``x`` (B, S, d) with its rows where they are
    split (Shard(0)) and every other dim whole; ``weights`` {name:
    (tensor, head dim or None)}, each this rank's heads along its head
    dim, whole when it has none; ``state`` {name: (tensor, head dim or
    None)} (B, ...) the same way, or None.  ``fn`` returns (out, {name:
    state}) with ``out`` (B, S, d) a partial sum over the head split and
    the state laid out as ``state_out`` {name: head dim or None} says.
    ``split`` is (mesh, [the head mesh dim]) or None.  A weight's
    gradient leaves every rank partial where the rows or the heads split
    the work."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    hdim = _head_dim(x, n_heads)
    rows = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    rep = Replicate()

    def pl(head, row=True, part=False):
        """Placements: rows Shard(0) (``row``) or partial / whole; on the
        head dim Shard(head), else partial (``part``) or whole."""
        out = []
        for i in range(mesh.ndim):
            if i in rows:
                out.append(Shard(0) if row else
                           (Partial() if part else rep))
            elif i == hdim:
                out.append(Shard(head) if head is not None else
                           (Partial() if part else rep))
            else:
                out.append(rep)
        return tuple(out)

    names = list(weights)
    states = state or {}
    in_pl = [pl(None)] + [pl(h, row=False) for _, h in weights.values()] \
        + [pl(h) for _, h in states.values()]
    grad_pl = [pl(None, part=True)] + \
        [pl(h, row=False, part=True) for _, h in weights.values()] + \
        [pl(h) for _, h in states.values()]
    out_pl = [pl(None, part=True)] + [pl(h) for h in state_out.values()]
    n_loc = n_heads if hdim is None else n_heads // mesh.shape[hdim]
    split = None if hdim is None else (mesh, [hdim])

    def body(xl, *args):
        h0 = 0 if hdim is None else mesh.get_local_rank(hdim) * n_loc
        ws = dict(zip(names, args[:len(names)]))
        st = dict(zip(states, args[len(names):])) if state is not None \
            else None
        out, new = fn(xl, ws, st, (h0, h0 + n_loc), split)
        return (out, *(new[k] for k in state_out))

    res = shd.local_map(body, tuple(out_pl), tuple(in_pl), mesh,
                        in_grad_placements=tuple(grad_pl))(
        x, *(t for t, _ in weights.values()),
        *(t for t, _ in states.values()))
    return res[0], dict(zip(state_out, res[1:]))


def _mamba_sharded(run, params: Mamba, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[dict]):
    """:func:`_mamba_seq` / :func:`_mamba_step` (``run``) of a DTensor
    ``x``: rows local, the sequence whole, the heads split where the
    ``model`` axis divides them.  ``w_in``'s columns are [x | z], so it
    comes whole and each rank takes its heads' columns of both halves;
    the norm over the inner width sums its squares across the split."""
    from types import SimpleNamespace
    hp = cfg.head_dim
    inner = cfg.ssm_heads * hp
    weights = {"w_in": (params.w_in, None), "conv": (params.conv, 1),
               "w_dt": (params.w_dt, 1), "dt_bias": (params.dt_bias, 0),
               "a_log": (params.a_log, 0), "d_skip": (params.d_skip, 0),
               "w_bc": (params.w_bc, None), "w_out": (params.w_out, 0),
               "norm_scale": (params.norm_scale, 0)}
    st = None if state is None else {"ssm": (state["ssm"], 1),
                                     "conv": (state["conv"], 2)}

    def fn(xl, ws, stl, heads, split):
        c0, c1 = heads[0] * hp, heads[1] * hp
        w_in = ws["w_in"]
        ws["w_in"] = torch.cat([w_in[:, c0:c1],
                                w_in[:, inner + c0:inner + c1]], dim=1)
        return run(SimpleNamespace(**ws), xl, cfg, stl, split=split)

    return _on_local_blocks(fn, x, cfg.ssm_heads, weights, st,
                            {"ssm": 1, "conv": 2})


def _rwkv_sharded(params: RWKV, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict]):
    """:func:`rwkv_time_mix` of a DTensor ``x`` on local blocks: rows
    local, the sequence whole, the heads split where the ``model`` axis
    divides them (the r / k / v / g projections' columns, ``w_o``'s rows,
    the decay and the bonus of each head); the token shift's lerp weights
    and the decay's first LoRA factor come whole."""
    from types import SimpleNamespace
    weights = {"mu": (params.mu, None), "w_r": (params.w_r, 1),
               "w_k": (params.w_k, 1), "w_v": (params.w_v, 1),
               "w_g": (params.w_g, 1), "w_o": (params.w_o, 0),
               "w0": (params.w0, 0), "w_lora_a": (params.w_lora_a, None),
               "w_lora_b": (params.w_lora_b, 1),
               "bonus_u": (params.bonus_u, 0),
               "ln_scale": (params.ln_scale, 0)}
    st = None if state is None else {"wkv": (state["wkv"], 1),
                                     "tm_x": (state["tm_x"], None)}

    def fn(xl, ws, stl, heads, split):
        out, wkv, last = rwkv_time_mix(SimpleNamespace(**ws), xl, cfg, stl)
        return out, {"wkv": wkv, "tm_x": last}

    out, new = _on_local_blocks(fn, x, cfg.d_model // cfg.rwkv_head_size,
                                weights, st, {"wkv": 1, "tm_x": None})
    return out, new["wkv"], new["tm_x"]


def _channel_mix_sharded(params: RWKV, x: torch.Tensor,
                         state: Optional[dict]):
    """:func:`rwkv_channel_mix` of a DTensor ``x`` on local blocks: the
    hidden units (``cm_k``'s columns, ``cm_v``'s rows) split where the
    ``model`` axis divides them; the receptance ``cm_r`` comes whole."""
    from types import SimpleNamespace
    weights = {"mu_cm": (params.mu_cm, None), "cm_k": (params.cm_k, 1),
               "cm_v": (params.cm_v, 0), "cm_r": (params.cm_r, None)}
    st = None if state is None else {"cm_x": (state["cm_x"], None)}

    def fn(xl, ws, stl, heads, split):
        out, last = rwkv_channel_mix(SimpleNamespace(**ws), xl, stl)
        return out, {"cm_x": last}

    out, new = _on_local_blocks(fn, x, params.cm_k.shape[1], weights, st,
                                {"cm_x": None})
    return out, new["cm_x"]
