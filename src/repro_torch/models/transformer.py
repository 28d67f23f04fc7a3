"""Model assembly for the dense and vlm families: init / prefill / decode
(port of ``repro/models/transformer.py``).

Parameters are an ``nn.Module`` tree (:class:`Transformer`) whose tensors
keep the reference's per-layer layouts; ``convert.params_from_numpy``
carries the reference's layer-stacked pytree over.  The reference scans
over layers; here a Python loop walks them.

Segments.  The SALS layer mask is front/back-contiguous, so the stack
splits into up to three segments ``full | sals | full``, each with its own
cache: ``{"k", "v"}`` tensors of shape (ls, B, S, Hkv, dh) for the full
segments and a layer-stacked :class:`LatentKVCache` for the SALS segment
(the dense slot arena, or page pools when ``page_size`` > 0).  A vlm
prompt is {"patches": (B, P, d), "tokens": (B, S)}: the patch embeddings
come first, attend each other bidirectionally (prefix-LM) and hold cache
positions 0 .. P-1, so decode continues at P + S; chunked prefill and the
serving engine take tokens only, as the reference's do.  Prefill is
monolithic (:func:`prefill`) or chunked (:func:`prefill_chunk`, which
serving uses); decode and chunked prefill update the caches in place.
Speculative decode runs Q tokens through :func:`decode_window` and commits
the accepted prefix with :func:`commit_window`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.core.sparse_attention import (sals_decode_attend,
                                               sals_window_attend)
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, embed_apply,
                                       mlp_apply, rmsnorm_apply,
                                       unembed_apply)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm"):
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
    """Decoder parameters (dense or vlm): embed, blocks[L], final_norm."""

    def __init__(self, cfg: ModelConfig, dtype=None, device="cuda"):
        super().__init__()
        _check_family(cfg)
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
    """Returns (x (B,S,d), prefix_len) from {"tokens": (B, S)}, or for the
    vlm family {"patches": (B, P, d), "tokens": (B, S)}: the patch
    embeddings, cast to the token embedding's dtype and not scaled, then
    the tokens' (P + S positions, prefix_len P)."""
    _check_family(cfg)
    tok_emb = embed_apply(params.embed, batch["tokens"], cfg)
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(tok_emb.dtype)
        return torch.cat([patches, tok_emb], dim=1), patches.shape[1]
    return tok_emb, 0


def _finish_block(bp: Block, x, a, cfg: ModelConfig):
    x = x + a
    h2 = rmsnorm_apply(bp.mlp_norm, x, cfg.norm_eps)
    return x + mlp_apply(bp.mlp, h2, cfg.mlp_act)


# ---------------------------------------------------------------------------
# Cache init / prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, sals: Optional[SALSConfig], batch: int,
               max_seq: int, dtype=None, n_groups: int = 1,
               page_size: int = 0, n_pages: int = 0, hbm_pages: int = 0,
               device="cuda") -> dict:
    """Zero caches for every segment (see the module docstring).
    ``page_size`` > 0 backs the SALS segments with ``n_pages`` physical
    pages instead of the dense (B, max_seq, ·) arena; the full segments
    keep their dense per-slot caches.  ``hbm_pages`` > 0 makes the pool
    two-tier: payload pools of that many device slots (+1 trash), while
    the r* score pool and the page table keep all ``n_pages``."""
    dtype = torch_dtype(dtype or cfg.dtype)
    cache: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        ls = i1 - i0
        if mode == "full":
            shape = (ls, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            cache[f"seg{si}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        elif page_size:
            cache[f"seg{si}"] = LatentKVCache.init_paged(
                cfg, sals, ls, batch, max_seq, n_pages, page_size, dtype,
                n_groups=n_groups, hbm_pages=hbm_pages, device=device)
        else:
            cache[f"seg{si}"] = LatentKVCache.init(
                cfg, sals, ls, batch, max_seq, dtype, n_groups=n_groups,
                device=device)
    return cache


def init_prefill_scratch(cfg: ModelConfig, sals: Optional[SALSConfig],
                         batch: int, max_seq: int, dtype=None,
                         device="cuda") -> dict:
    """Full-precision prompt-K/V scratch for the SALS segments of a chunked
    prefill: chunk queries attend exactly to every earlier prompt token,
    which the SALS layers store only compressed, so each SALS layer keeps a
    transient post-RoPE K/V buffer until the prompt is done (the full
    segments use their own decode cache).  Returns {"seg{i}": {"k": (ls,
    B, S, Hkv, dh), "v": ...}} for the SALS segments only."""
    dtype = torch_dtype(dtype or cfg.dtype)
    scratch: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        if mode == "sals":
            shape = (i1 - i0, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            scratch[f"seg{si}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return scratch


def prefill(params: Transformer, projectors: Optional[dict],
            cfg: ModelConfig, sals: Optional[SALSConfig],
            batch: Dict[str, torch.Tensor], max_seq: int, n_groups: int = 1,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Process the prompt monolithically and build the decode cache.

    ``lengths`` (B,): per-row true token lengths of a right-padded ragged
    batch (windows hold each row's real positions; logits are taken at
    each row's last real token).  A vlm batch's patches come first: a
    row's cache span is prefix_len + its token length, and ``max_seq``
    must hold P + S and the tokens to decode.  Returns (last-position
    logits (B, V) f32, cache)."""
    dtype = torch_dtype(cfg.dtype)
    x, prefix_len = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    len_v = None if lengths is None else \
        torch.as_tensor(lengths, device=dev).to(torch.int32)
    # cache positions include any vision prefix
    cache_len = None if len_v is None else prefix_len + len_v
    cache = init_cache(cfg, sals, b, max_seq, dtype, n_groups, device=dev)
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        for li in range(i0, i1):
            x, ex = _block_fwd(params.blocks[li], x, cfg, positions,
                               prefix_len, True)
            if mode == "sals":
                layer = LatentKVCache.prefill_layer(
                    cfg, sals, projectors["u"][li], ex["k_pre"], ex["v"],
                    max_seq, dtype, n_groups=n_groups, lengths=cache_len)
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
        last_idx = (cache_len - 1).long()
        last = x[torch.arange(b, device=dev), last_idx][:, None]
    return unembed_apply(params.embed, last, cfg)[:, 0], cache


def prefill_chunk(params: Transformer, projectors: Optional[dict],
                  cfg: ModelConfig, sals: Optional[SALSConfig], cache: dict,
                  scratch: dict, batch: Dict[str, torch.Tensor], off,
                  lengths: torch.Tensor) -> Tuple[torch.Tensor, dict, dict]:
    """One chunked-prefill step: prompt tokens [off, off+C) against the
    cache so far.

    ``batch`` {"tokens": (B, C)} is one chunk of the right-padded prompt;
    ``off`` the chunk's first position, a 0-d integer tensor on the
    device (as the reference's traced offset; a Python int from a direct
    caller), which no step reads on the host, so one captured program
    (``ServeEngine._prefill_chunk``) serves every chunk;
    ``lengths`` (B,) the true prompt lengths.  ``cache`` (from
    :func:`init_cache`, dense) and ``scratch`` (:func:`init_prefill_scratch`)
    are updated in place: each layer LSE-merges a history partial with the
    intra-chunk causal partial (``attention.attend_prefill_chunk``) and
    appends the chunk's K/V — full layers into their decode cache, SALS
    layers into the scratch plus the latent / ring / sink writes of
    ``LatentKVCache.append_chunk``.  Returns (logits (B, V) f32 at each
    row's last real token covered so far (index clip(lengths-1-off, 0,
    C-1) in the chunk: the chunk holding position lengths-1 returns the
    prompt's next-token logits), cache, scratch).  Tokens only: a vlm
    model's chunks carry no patches, as the reference's."""
    _check_family(cfg)
    x = embed_apply(params.embed, batch["tokens"], cfg)
    b, c, _ = x.shape
    dev = x.device
    len_v = torch.as_tensor(lengths, device=dev).to(torch.int64) \
        .reshape(-1).expand(b)
    off = torch.as_tensor(off, device=dev)
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        kv = scratch[f"seg{si}"] if mode == "sals" else seg
        for li in range(i0, i1):
            bp = params.blocks[li]
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            a, k_pre, v, _, _ = attn.attend_prefill_chunk(
                bp.attn, h, cfg, off, kv["k"][li - i0], kv["v"][li - i0])
            if mode == "sals":
                seg.layer_view(li - i0).append_chunk(
                    cfg, sals, projectors["u"][li], off, k_pre, v, len_v)
            x = _finish_block(bp, x, a, cfg)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    last = (len_v - 1 - off).clamp(0, c - 1)
    x_last = x[torch.arange(b, device=dev), last][:, None]
    return unembed_apply(params.embed, x_last, cfg)[:, 0], cache, scratch


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step(params: Transformer, projectors: Optional[dict], cache: dict,
                tokens: torch.Tensor, pos, cfg: ModelConfig,
                sals: Optional[SALSConfig], collect_selection: bool = False):
    """One decode step.  tokens: (B,) int; pos: scalar or (B,) per-row
    positions.  Updates ``cache`` in place; returns (logits (B, V) f32,
    cache).  With ``collect_selection`` (paged SALS caches only) it also
    returns {seg_name: (ls, B, max_pages) bool}: which LOGICAL pages each
    SALS layer's selection reconstructed from, the tiered scheduler's
    fetch oracle."""
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode step")
    x = embed_apply(params.embed, tokens[:, None], cfg)       # (B,1,d)
    touched: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        seg_touch = []
        for li in range(i0, i1):
            bp = params.blocks[li]
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            if mode == "sals":
                a, _, *t = sals_decode_attend(
                    bp.attn, projectors["u"][li], seg.layer_view(li - i0), h,
                    pos, cfg, sals, collect=collect_selection)
                seg_touch += t
            else:
                a, _, _ = attn.attend_decode_full(
                    bp.attn, h, cfg, seg["k"][li - i0], seg["v"][li - i0],
                    pos)
            x = _finish_block(bp, x, a, cfg)
        if seg_touch:
            touched[f"seg{si}"] = torch.stack(seg_touch)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, x, cfg)[:, 0]
    if collect_selection:
        return logits, cache, touched
    return logits, cache


def decode_window(params: Transformer, projectors: Optional[dict],
                  cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                  sals: Optional[SALSConfig]) -> Tuple[torch.Tensor, dict]:
    """Speculative verify window: Q tokens through one forward.

    tokens: (B, Q) — the pending token plus Q−1 drafts at positions
    pos..pos+Q−1 (``pos`` scalar or (B,) window base).  The SALS layers
    only read their caches (one latent selection per layer for the whole
    window, ``sals_window_attend``); the full-precision layers write the
    window's K/V in place at positions ≥ the committed length, where no
    committed read looks.  Returns (logits (B, Q, V) f32, aux) —
    ``aux["seg{i}"]`` holds each SALS segment's pre-RoPE window K/V
    ((ls, B, Q, Hkv, dh)) for :func:`commit_window`."""
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode step")
    x = embed_apply(params.embed, tokens, cfg)                # (B,Q,d)
    aux: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        ks, vs = [], []
        for li in range(i0, i1):
            bp = params.blocks[li]
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            if mode == "sals":
                a, k_pre, v = sals_window_attend(
                    bp.attn, projectors["u"][li], seg.layer_view(li - i0), h,
                    pos, cfg, sals)
                ks.append(k_pre)
                vs.append(v)
            else:
                a = attn.attend_decode_full_window(
                    bp.attn, h, cfg, seg["k"][li - i0], seg["v"][li - i0],
                    pos)
            x = _finish_block(bp, x, a, cfg)
        if mode == "sals":
            aux[f"seg{si}"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    return unembed_apply(params.embed, x, cfg), aux


def commit_window(projectors: Optional[dict], cache: dict, aux: dict, pos,
                  n_accept, cfg: ModelConfig, sals: Optional[SALSConfig]
                  ) -> dict:
    """Commit a verify window's ACCEPTED prefix into the decode cache, in
    place: window slot t of row b commits at pos + t iff t < n_accept[b]
    ((B,) counts, a device tensor or a host array).  Each SALS segment
    projects its window keys to the latent space with the (B, kv_dim) ·
    U_r product sequential decode uses, one slot and layer at a time (so
    the stored bytes are those sequential decode would store for the same
    keys), and appends them through :meth:`LatentKVCache.write_window`,
    all its layers at once.  The full-precision segments already hold the
    window's K/V (:func:`decode_window`); the advanced positions make the
    accepted prefix committed."""
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        if mode != "sals":
            continue
        seg, ax = cache[f"seg{si}"], aux[f"seg{si}"]
        k_pre, v = ax["k"], ax["v"]                  # (ls, B, Q, Hkv, dh)
        ls, b, ql = k_pre.shape[:3]
        k_flat = k_pre.reshape(ls, b, ql, cfg.kv_dim)
        k_lat = torch.stack([torch.stack(
            [k_flat[l, :, t].float() @ projectors["u"][i0 + l].float()
             for t in range(ql)], dim=1) for l in range(ls)])
        seg.write_window(sals, pos, k_lat, v.reshape(ls, b, ql, cfg.kv_dim),
                         k_pre, v, n_accept)
    return cache
