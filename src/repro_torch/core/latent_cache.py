"""Latent KV cache of the SALS layers (port of the dense slot arena of
``repro/core/latent_cache.py``).

Per SALS layer and cached position it stores ``k_lat`` (pre-RoPE keys
projected to the r-dim latent space, bf16 — or int8 + per-token
``k_scale``) and the group-quantized values ``v_q`` / ``v_scale`` /
``v_zero``; plus two small full-precision regions that are always attended:
``sink_k/v`` (the first n_sink tokens) and ``recent_k/v`` (a ring of the
last n_recent tokens, slot = position % n_recent), all pre-RoPE.  The batch
axis is a slot arena with per-slot ``lengths``.

Unlike the reference, whose arrays are immutable and whose methods return
new caches, the port's arrays are preallocated arena tensors that
:meth:`LatentKVCache.write` (and the layer views of :meth:`layer_view`)
update IN PLACE; the methods return ``self`` so call sites read the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core import quantization as qz
from repro_torch.core.projection import to_latent

_PER_TOKEN_FIELDS = ("k_lat", "k_scale", "v_q", "v_scale", "v_zero")
_ALL_FIELDS = ("k_lat", "v_q", "v_scale", "v_zero", "sink_k", "sink_v",
               "recent_k", "recent_v", "k_scale", "lengths")


def _row_positions(pos, batch: int, device) -> torch.Tensor:
    """Scalar-or-(B,) decode position -> (B,) int64 index vector."""
    return torch.as_tensor(pos, device=device).to(torch.int64) \
        .reshape(-1).expand(batch)


@dataclasses.dataclass
class LatentKVCache:
    """One SALS cache: a layer stack ([L,] leading axis) or one layer."""

    k_lat: torch.Tensor                    # ([L,] B, S, r) bf16 | int8
    v_q: torch.Tensor                      # ([L,] B, S, code_w)
    v_scale: torch.Tensor                  # ([L,] B, S, G) bf16
    v_zero: torch.Tensor                   # ([L,] B, S, G) bf16
    sink_k: torch.Tensor                   # ([L,] B, n_sink, Hkv, dh)
    sink_v: torch.Tensor
    recent_k: torch.Tensor                 # ([L,] B, n_recent, Hkv, dh)
    recent_v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # ([L,] B, S) int8-latent scale
    lengths: Optional[torch.Tensor] = None  # ([L,] B) int32 tokens per slot

    # ------------------------------------------------------------------ init

    @classmethod
    def init(cls, cfg: ModelConfig, sals: SALSConfig, n_layers: int,
             batch: int, max_seq: int, dtype=torch.bfloat16,
             n_groups: int = 1, device="cuda") -> "LatentKVCache":
        """Zero-initialized arena with a leading layer axis."""
        if n_groups > 1:
            raise NotImplementedError("the grouped layout (n_groups > 1) is "
                                      "ported in the layouts slice")
        kvd = cfg.kv_dim
        r = sals.rank(kvd)
        groups = kvd // sals.v_group
        code_w = qz.quant_channels(kvd, sals.v_bits)
        code_dtype = torch.int8 if sals.v_bits == 8 else torch.uint8
        win = (n_layers, batch, sals.n_sink, cfg.n_kv_heads, cfg.head_dim)
        ring = (n_layers, batch, sals.n_recent, cfg.n_kv_heads, cfg.head_dim)
        tok = (n_layers, batch, max_seq)

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        if sals.k_latent_dtype == "int8":
            k_lat, k_scale = z((*tok, r), torch.int8), z(tok, qz.SCALE_DTYPE)
        else:
            k_lat, k_scale = z((*tok, r), dtype), None
        return cls(k_lat=k_lat, k_scale=k_scale,
                   v_q=z((*tok, code_w), code_dtype),
                   v_scale=z((*tok, groups), qz.SCALE_DTYPE),
                   v_zero=z((*tok, groups), qz.SCALE_DTYPE),
                   sink_k=z(win, dtype), sink_v=z(win, dtype),
                   recent_k=z(ring, dtype), recent_v=z(ring, dtype),
                   lengths=z((n_layers, batch), torch.int32))

    @classmethod
    def prefill_layer(cls, cfg: ModelConfig, sals: SALSConfig,
                      u: torch.Tensor, k_pre: torch.Tensor, v: torch.Tensor,
                      max_seq: int, dtype=torch.bfloat16, n_groups: int = 1,
                      lengths: Optional[torch.Tensor] = None
                      ) -> "LatentKVCache":
        """Build ONE layer's cache (no leading L axis) from prefill tensors.

        k_pre/v: (B, S, n_kv, dh) pre-RoPE keys / values, S <= max_seq.
        ``lengths`` (B,): per-row true prompt lengths of a right-padded
        ragged batch — the sink/recent windows hold each row's own real
        positions.  None means every row is exactly S tokens."""
        if n_groups > 1:
            raise NotImplementedError("the grouped layout (n_groups > 1) is "
                                      "ported in the layouts slice")
        b, s = k_pre.shape[:2]
        dev = k_pre.device
        kvd = cfg.kv_dim
        lat = to_latent(u.float(), k_pre.reshape(b, s, kvd))     # (B,S,r)
        vq = qz.quantize(v.reshape(b, s, kvd), sals.v_bits, sals.v_group)

        def pad(x):
            if s == max_seq:
                return x.contiguous()
            out = torch.zeros((b, max_seq, *x.shape[2:]), dtype=x.dtype,
                              device=dev)
            out[:, :s] = x
            return out

        w, ns = sals.n_recent, sals.n_sink
        win = (b, ns, cfg.n_kv_heads, cfg.head_dim)
        n_head = min(s, ns)
        sk = torch.zeros(win, dtype=dtype, device=dev)
        sv = torch.zeros_like(sk)
        sk[:, :n_head] = k_pre[:, :n_head].to(dtype)
        sv[:, :n_head] = v[:, :n_head].to(dtype)
        if lengths is None:
            len_v = torch.full((b,), s, dtype=torch.int32, device=dev)
            n_tail = min(s, w)
            slots = torch.arange(s - n_tail, s, device=dev) % w
            rk = torch.zeros((b, w, cfg.n_kv_heads, cfg.head_dim),
                             dtype=dtype, device=dev)
            rv = torch.zeros_like(rk)
            rk[:, slots] = k_pre[:, s - n_tail:].to(dtype)
            rv[:, slots] = v[:, s - n_tail:].to(dtype)
        else:
            len_v = torch.as_tensor(lengths, device=dev).to(torch.int32) \
                .clone()                    # the cache owns its lengths
            # slot j of row b holds position last - (last - j) % w
            last = (len_v.long() - 1)[:, None]
            p = last - torch.remainder(last - torch.arange(w, device=dev), w)
            ring_ok = (p >= 0)[..., None, None]
            pc = p.clamp(0, s - 1)
            bi = torch.arange(b, device=dev)[:, None]
            zero = torch.zeros((), dtype=k_pre.dtype, device=dev)
            rk = torch.where(ring_ok, k_pre[bi, pc], zero).to(dtype)
            rv = torch.where(ring_ok, v[bi, pc], zero).to(dtype)
            sink_ok = ((torch.arange(ns, device=dev)[None, :] < len_v[:, None])
                       & (torch.arange(ns, device=dev)[None, :] < n_head))
            sk = torch.where(sink_ok[..., None, None], sk,
                             torch.zeros((), dtype=dtype, device=dev))
            sv = torch.where(sink_ok[..., None, None], sv,
                             torch.zeros((), dtype=dtype, device=dev))

        if sals.k_latent_dtype == "int8":
            q8, scale = qz.quantize_latent_int8(lat)
            k_lat, k_scale = pad(q8), pad(scale.to(qz.SCALE_DTYPE))
        else:
            k_lat, k_scale = pad(lat.to(dtype)), None
        return cls(k_lat=k_lat, k_scale=k_scale, v_q=pad(vq["q"]),
                   v_scale=pad(vq["scale"]), v_zero=pad(vq["zero"]),
                   sink_k=sk, sink_v=sv, recent_k=rk, recent_v=rv,
                   lengths=len_v)

    # ----------------------------------------------------------------- views

    def layer_view(self, l: int) -> "LatentKVCache":
        """Layer ``l`` of a stacked cache, as views: writes through it land
        in the arena."""
        return dataclasses.replace(self, **{
            f: (None if getattr(self, f) is None else getattr(self, f)[l])
            for f in _ALL_FIELDS})

    def set_layer(self, l: int, layer: "LatentKVCache") -> None:
        """Copy a single-layer cache into layer ``l`` of this stack."""
        for f in _ALL_FIELDS:
            dst = getattr(self, f)
            if dst is not None:
                dst[l].copy_(getattr(layer, f))

    def latent_views(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Raw quantized latent arrays (k_lat (B, S, r), k_scale (B, S) or
        None) exactly as stored, for the fused decode kernels."""
        return self.k_lat, self.k_scale

    # ---------------------------------------------------------------- writes

    def write(self, sals: SALSConfig, pos, k_lat: torch.Tensor,
              v_flat: torch.Tensor, k_pre: torch.Tensor, v: torch.Tensor
              ) -> "LatentKVCache":
        """Append one token in place: latent K + quantized V at ``pos``
        (scalar or (B,) per row) and the recent-ring / sink insert.
        k_lat: (B, r); v_flat: (B, kv_dim); k_pre/v: (B, n_kv, dh)."""
        return self.write_latents(sals, pos, k_lat, v_flat) \
                   .write_ring(sals, pos, k_pre, v)

    def write_latents(self, sals: SALSConfig, pos, k_lat: torch.Tensor,
                      v_flat: torch.Tensor) -> "LatentKVCache":
        b = k_lat.shape[0]
        pos_v = _row_positions(pos, b, k_lat.device)
        rows = torch.arange(b, device=k_lat.device)
        if sals.k_latent_dtype == "int8":
            q8, scale = qz.quantize_latent_int8(k_lat)
            self.k_lat[rows, pos_v] = q8
            self.k_scale[rows, pos_v] = scale
        else:
            self.k_lat[rows, pos_v] = k_lat.to(self.k_lat.dtype)
        vq = qz.quantize(v_flat, sals.v_bits, sals.v_group)
        self.v_q[rows, pos_v] = vq["q"]
        self.v_scale[rows, pos_v] = vq["scale"]
        self.v_zero[rows, pos_v] = vq["zero"]
        if self.lengths is not None:
            self.lengths.copy_(torch.maximum(self.lengths,
                                             (pos_v + 1).to(torch.int32)))
        return self

    def write_ring(self, sals: SALSConfig, pos, k_pre: torch.Tensor,
                   v: torch.Tensor) -> "LatentKVCache":
        """Insert one token into the recent ring, and into the sink while
        pos < n_sink.  k_pre/v: (B, n_kv, dh)."""
        b = k_pre.shape[0]
        pos_v = _row_positions(pos, b, k_pre.device)
        rows = torch.arange(b, device=k_pre.device)
        slot = torch.remainder(pos_v, sals.n_recent)
        self.recent_k[rows, slot] = k_pre.to(self.recent_k.dtype)
        self.recent_v[rows, slot] = v.to(self.recent_v.dtype)
        # rows past the sink rewrite sink slot 0 with its own value (no
        # host sync on a data-dependent branch)
        in_sink = (pos_v < sals.n_sink)[:, None, None]
        sink_pos = torch.where(pos_v < sals.n_sink, pos_v,
                               torch.zeros_like(pos_v))
        for arr, val in ((self.sink_k, k_pre), (self.sink_v, v)):
            arr[rows, sink_pos] = torch.where(in_sink, val.to(arr.dtype),
                                              arr[rows, sink_pos])
        return self

    # ------------------------------------------------------------ bookkeeping

    @property
    def bytes_per_token(self) -> float:
        """Stored bytes/token/layer from the per-token fields' shapes and
        dtypes (the compression bookkeeping of paper Table 1)."""
        n_slots = math.prod(self.k_lat.shape[:-1])
        total = sum(getattr(self, f).numel() * getattr(self, f).element_size()
                    for f in _PER_TOKEN_FIELDS if getattr(self, f) is not None)
        return total / n_slots


def cache_bytes_per_token(cfg: ModelConfig, sals: SALSConfig) -> float:
    """Stored bytes/token/layer for a (cfg, sals) setting, derived from the
    cache's field shapes and dtypes (on the meta device: no allocation)."""
    shapes = LatentKVCache.init(cfg, sals, 1, 1, max(sals.n_recent, 8),
                                device="meta")
    return shapes.bytes_per_token
