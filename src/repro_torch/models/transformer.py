"""Model assembly for the dense family: init / prefill / decode (port of
``repro/models/transformer.py``).

Parameters are an ``nn.Module`` tree (:class:`Transformer`) whose tensors
keep the reference's per-layer layouts; ``convert.params_from_numpy``
carries the reference's layer-stacked pytree over.  The reference scans
over layers; here a Python loop walks them.

Segments.  The SALS layer mask is front/back-contiguous, so the stack
splits into up to three segments ``full | sals | full``, each with its own
cache: ``{"k", "v"}`` tensors of shape (ls, B, S, Hkv, dh) for the full
segments and a layer-stacked :class:`LatentKVCache` for the SALS segment.
Decode updates these caches in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.core.sparse_attention import sals_decode_attend
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, embed_apply,
                                       mlp_apply, rmsnorm_apply,
                                       unembed_apply)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family is ported in "
                                  "the families slice")


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------

def segment_plan(cfg: ModelConfig, sals: Optional[SALSConfig]
                 ) -> List[Tuple[int, int, str]]:
    """[(start, stop, mode)] with mode in {"full", "sals"}."""
    l = cfg.n_layers
    if (sals is None or not sals.enabled or not cfg.has_attention
            or not cfg.is_decoder):
        return [(0, l, "full")]
    f = min(sals.skip_layers_front, l)
    b = min(sals.skip_layers_back, l - f)
    segs = []
    if f:
        segs.append((0, f, "full"))
    if l - f - b > 0:
        segs.append((f, l - b, "sals"))
    if b:
        segs.append((l - b, l, "full"))
    return segs


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg, dtype, device)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class Transformer(nn.Module):
    """Dense decoder parameters: embed, blocks[L], final_norm."""

    def __init__(self, cfg: ModelConfig, dtype=None, device="cuda"):
        super().__init__()
        _dense_only(cfg)
        dtype = torch_dtype(dtype or cfg.dtype)
        self.embed = Embedding(cfg, dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=None, seed: int = 0) -> Transformer:
    """Seeded random parameters (the reference's initializer and scales;
    the numbers differ from ``jax.random``'s).  ``generator`` must live on
    ``device``; without one, a generator seeded with ``seed`` is made."""
    params = Transformer(cfg, dtype, device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    params.embed.init_(generator)
    for blk in params.blocks:
        blk.attn.init_(generator)
        blk.mlp.init_(generator)
    return params


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _block_fwd(bp: Block, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, prefix_len: int, collect_kv: bool):
    """One block over a full sequence.  Returns (x, extras) with extras =
    {"k_pre", "v"} when ``collect_kv``."""
    h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
    a, k_pre, v = attn.attend_prefill(bp.attn, h, cfg, positions, prefix_len)
    extras = {"k_pre": k_pre, "v": v} if collect_kv else None
    x = x + a
    h2 = rmsnorm_apply(bp.mlp_norm, x, cfg.norm_eps)
    return x + mlp_apply(bp.mlp, h2, cfg.mlp_act), extras


def embed_inputs(params: Transformer, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Returns (x (B,S,d), prefix_len) from {"tokens": (B, S)}."""
    _dense_only(cfg)
    return embed_apply(params.embed, batch["tokens"], cfg), 0


def _finish_block(bp: Block, x, a, cfg: ModelConfig):
    x = x + a
    h2 = rmsnorm_apply(bp.mlp_norm, x, cfg.norm_eps)
    return x + mlp_apply(bp.mlp, h2, cfg.mlp_act)


# ---------------------------------------------------------------------------
# Cache init / prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, sals: Optional[SALSConfig], batch: int,
               max_seq: int, dtype=None, n_groups: int = 1,
               device="cuda") -> dict:
    """Zero caches for every segment (see the module docstring)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    cache: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        ls = i1 - i0
        if mode == "full":
            shape = (ls, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            cache[f"seg{si}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            cache[f"seg{si}"] = LatentKVCache.init(
                cfg, sals, ls, batch, max_seq, dtype, n_groups=n_groups,
                device=device)
    return cache


def prefill(params: Transformer, projectors: Optional[dict],
            cfg: ModelConfig, sals: Optional[SALSConfig],
            batch: Dict[str, torch.Tensor], max_seq: int, n_groups: int = 1,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Process the prompt monolithically and build the decode cache.

    ``lengths`` (B,): per-row true lengths of a right-padded ragged batch
    (windows hold each row's real positions; logits are taken at each row's
    last real token).  Returns (last-position logits (B, V) f32, cache)."""
    dtype = torch_dtype(cfg.dtype)
    x, prefix_len = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    len_v = None if lengths is None else \
        torch.as_tensor(lengths, device=dev).to(torch.int32)
    cache = init_cache(cfg, sals, b, max_seq, dtype, n_groups, dev)
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        for li in range(i0, i1):
            x, ex = _block_fwd(params.blocks[li], x, cfg, positions,
                               prefix_len, True)
            if mode == "sals":
                layer = LatentKVCache.prefill_layer(
                    cfg, sals, projectors["u"][li], ex["k_pre"], ex["v"],
                    max_seq, dtype, n_groups=n_groups, lengths=len_v)
                seg.set_layer(li - i0, layer)
            else:
                k_r = attn.apply_rope(ex["k_pre"], positions,
                                      cfg.rope_theta) \
                    if cfg.use_rope else ex["k_pre"]
                seg["k"][li - i0, :, :s] = k_r.to(dtype)
                seg["v"][li - i0, :, :s] = ex["v"].to(dtype)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    if len_v is None:
        last = x[:, -1:, :]
    else:
        last_idx = (prefix_len + len_v - 1).long()
        last = x[torch.arange(b, device=dev), last_idx][:, None]
    return unembed_apply(params.embed, last, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step(params: Transformer, projectors: Optional[dict], cache: dict,
                tokens: torch.Tensor, pos, cfg: ModelConfig,
                sals: Optional[SALSConfig]):
    """One decode step.  tokens: (B,) int; pos: scalar or (B,) per-row
    positions.  Updates ``cache`` in place; returns (logits (B, V) f32,
    cache)."""
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode step")
    x = embed_apply(params.embed, tokens[:, None], cfg)       # (B,1,d)
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        for li in range(i0, i1):
            bp = params.blocks[li]
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            if mode == "sals":
                a, _ = sals_decode_attend(bp.attn, projectors["u"][li],
                                          seg.layer_view(li - i0), h, pos,
                                          cfg, sals)
            else:
                a, _, _ = attn.attend_decode_full(
                    bp.attn, h, cfg, seg["k"][li - i0], seg["v"][li - i0],
                    pos)
            x = _finish_block(bp, x, a, cfg)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    return unembed_apply(params.embed, x, cfg)[:, 0], cache
