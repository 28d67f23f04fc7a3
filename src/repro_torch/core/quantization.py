"""Channel-group quantization of the value cache (port of
``repro/core/quantization.py``).

Asymmetric per-token, per-channel-group quantization at int8 (codes stored
with a -128 offset) or packed int4 (two codes per uint8, the even channel in
the low nibble), with bf16 scale and zero.  Rounding is half-to-even, as in
the reference, so the codes match it exactly.  All functions work over the
last axis and are shape-polymorphic.
"""
from __future__ import annotations

from typing import Tuple

import torch

SCALE_DTYPE = torch.bfloat16


def _grouped(x: torch.Tensor, group: int) -> torch.Tensor:
    c = x.shape[-1]
    if c % group:
        raise ValueError(f"channels {c} not divisible by group {group}")
    return x.reshape(*x.shape[:-1], c // group, group)


def quantize(x: torch.Tensor, bits: int, group: int) -> dict:
    """Returns {"q", "scale", "zero"}: int8 codes (value-zero)/scale - 128,
    or uint8 bytes holding two 4-bit codes."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    levels = (1 << bits) - 1
    xg = _grouped(x.float(), group)
    lo = torch.amin(xg, dim=-1, keepdim=True)
    hi = torch.amax(xg, dim=-1, keepdim=True)
    scale = torch.clamp_min((hi - lo) / levels, 1e-8)
    code = torch.clamp(torch.round((xg - lo) / scale), 0, levels)
    code = code.to(torch.uint8).reshape(x.shape)
    if bits == 4:
        code = code[..., 0::2] | (code[..., 1::2] << 4)
    else:
        code = (code.to(torch.int32) - 128).to(torch.int8)
    return {"q": code, "scale": scale[..., 0].to(SCALE_DTYPE),
            "zero": lo[..., 0].to(SCALE_DTYPE)}


def dequantize(qv: dict, bits: int, group: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    code = qv["q"]
    if bits == 4:
        c = code.to(torch.int32)
        lo = (c & 0x0F).float()
        hi = ((c >> 4) & 0x0F).float()
        vals = torch.stack([lo, hi], dim=-1).reshape(
            *code.shape[:-1], code.shape[-1] * 2)
    else:
        vals = code.float() + 128.0
    vg = _grouped(vals, group)
    out = vg * qv["scale"][..., None].float() + qv["zero"][..., None].float()
    return out.reshape(vals.shape).to(dtype)


def quant_channels(channels: int, bits: int) -> int:
    """Stored width of the code array for ``channels`` logical channels."""
    return channels // 2 if bits == 4 else channels


def quantize_latent_int8(lat: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 quantization of latent keys."""
    a = torch.amax(torch.abs(lat.float()), dim=-1, keepdim=True)
    scale = torch.clamp_min(a / 127.0, 1e-8)
    q = torch.clamp(torch.round(lat / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(SCALE_DTYPE)


def dequantize_latent_int8(q: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def bytes_per_token(kv_dim: int, bits: int, group: int) -> float:
    """Value-cache bytes per token incl. scale/zero overhead."""
    code = kv_dim / 2 if bits == 4 else kv_dim
    return code + 2 * 2 * (kv_dim / group)
