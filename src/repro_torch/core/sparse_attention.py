"""SALS decode attention (paper §4.4, Algorithm 1): port of
``repro/core/sparse_attention.py``.

One decode step per SALS layer:

  1. project the new token's pre-RoPE key to the latent space and append it
     (in place); quantize + append its value; insert (k_pre, v) into the
     recent ring (and the sink while pos < n_sink);
  2-3. score the cached latents with the truncated latent query and take the
     top-N_c (``ops.latent_topk``: the CUDA kernel on the card);
  4. gather, dequantize and reconstruct only the selected tokens, RoPE them
     at their own positions and attend (``ops.sparse_recon_attention``);
  5. exact attention over the sink + recent window, LSE-merged with step 4.

A :class:`DecodePlan` read off the cache (:func:`plan_decode`) picks the
selection layout.  ``n_groups`` 1 is the paper's global top-N_c.
``n_groups`` G > 1 is the grouped layout: G sequence slabs of S/G
positions each take their own top-⌈N_c/G⌉ through the SAME two kernels,
with the group axis folded into the kernel batch (row b·G + g is slab g of
row b, views of the arena, no copy) and a per-row ``pos_base`` = g·S/G
that keeps indices slab-local and positions global; the G partials then
LSE-merge with the sink / recent window.  Under a sharding context whose
kv_seq axes number G shards (``DecodePlan.shard_axes``), the slabs are
the shards of a sequence-sharded DTensor cache and each rank runs the
same two kernels on its own slab (``local_map``, base rank·S/G); the
partials merge by DTensor reductions over the group axis.  Under a
context whose shards do not match G (the global plan on a sharded cache)
the latents are gathered along S and the plan folds on every rank.

Both layouts of the cache run through the same code: the dense slot arena,
and the paged one, whose page table rides to both kernels (which then
read the page pools; the grouped fold splits the TABLE into (B·G, mp/G)
and leaves the pools alone).  The two-tier paged layout routes through two
tables: scoring reads the always-resident ``k_score`` pool through the
page table, reconstruction reads the payload pools through ``hot_table``
(a cold page's entry is 0, the trash slot; the scheduler fetches it and
reruns the step).  The same two kernels take either table as they are.

:func:`sals_window_attend` is the speculative verify window: Q tokens at
positions pos..pos+Q−1 through one selection and one windowed recon
kernel per slab, READ-ONLY on the cache (the caller commits the accepted
prefix); it needs the untiered cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core import selection as sel
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models.attention import out_proj, qkv_proj
from repro_torch.models.layers import apply_rope

NEG = sel.NEG


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one decode step selects: ``n_groups`` 1 = the global top-N_c;
    G > 1 = a top-⌈N_c/G⌉ per sequence slab and one LSE merge across them.
    ``shard_axes``: the mesh axes backing the group axis — non-empty means
    each rank runs its own slab (``local_map``); empty means the group
    axis folds into the kernel batch."""

    n_groups: int = 1
    shard_axes: Tuple[str, ...] = ()


def plan_decode(cache: LatentKVCache) -> DecodePlan:
    """The decode plan of ``cache``'s layout metadata and the ambient
    sharding context."""
    g = max(1, cache.n_groups)
    if g == 1 or cache.paged:
        # paged pools are never kv_seq-sharded: their slabs fold
        return DecodePlan(g)
    axes, total = shd.mesh_axes_for(cache.shard_axis)
    return DecodePlan(g, axes) if total == g else DecodePlan(g)


def _region_logits(q_r: torch.Tensor, k_pre: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RoPE + GQA QKᵀ for one region of pre-RoPE keys.  q_r: (B, H, dh)
    RoPE'd query; k_pre: (B, N, Hkv, dh); positions broadcastable to
    (B, N).  Returns (B, H, N) f32 logits (scaled, softcapped)."""
    if cfg.use_rope:
        k = apply_rope(k_pre, positions.expand(k_pre.shape[:-2]),
                       cfg.rope_theta)
    else:
        k = k_pre
    b = q_r.shape[0]
    q_g = q_r.reshape(b, cfg.n_kv_heads, cfg.group_size,
                      cfg.head_dim).float()
    logits = torch.einsum("bkrd,bnkd->bkrn", q_g, k.float())
    logits = logits.reshape(b, cfg.n_heads, k.shape[1])
    logits = logits * (cfg.head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return logits


def _region_logits_window(q_r: torch.Tensor, k_pre: torch.Tensor,
                          positions: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """Verify-window form of :func:`_region_logits`: q_r (B, Q, H, dh)
    RoPE'd queries; k_pre (B, Q, N, Hkv, dh) PER-QUERY region keys (each
    query sees the buffers its sequential step would read); positions
    broadcastable to (B, Q, N).  Returns (B, Q, H, N) f32 logits."""
    if cfg.use_rope:
        k = apply_rope(k_pre, positions.expand(k_pre.shape[:-2]),
                       cfg.rope_theta)
    else:
        k = k_pre
    b, ql = q_r.shape[:2]
    q_g = q_r.reshape(b, ql, cfg.n_kv_heads, cfg.group_size,
                      cfg.head_dim).float()
    logits = torch.einsum("bqkrd,bqnkd->bqkrn", q_g, k.float())
    logits = logits.reshape(b, ql, cfg.n_heads, k.shape[2])
    logits = logits * (cfg.head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return logits


def _partial_attend(logits: torch.Tensor, v: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-style partial softmax stats over the last axis.  logits:
    (..., H, N) f32; v: (..., N, Hkv, dh) unexpanded.  Returns (m, l, o)."""
    m = torch.max(logits, dim=-1).values
    p = torch.exp(logits - m[..., None])
    p = torch.where(logits <= NEG / 2, torch.zeros_like(p), p)
    l = torch.sum(p, dim=-1)
    lead, n = logits.shape[:-2], logits.shape[-1]
    p_g = p.reshape(*lead, cfg.n_kv_heads, cfg.group_size, n)
    o = torch.einsum("...krn,...nkd->...krd", p_g, v.float())
    return m, l, o.reshape(*lead, cfg.n_heads, cfg.head_dim)


def _touched_pages(idx: torch.Tensor, valid: torch.Tensor, page_size: int,
                   max_pages: int) -> torch.Tensor:
    """Selected logical indices (B, K) -> (B, max_pages) bool mask of the
    pages they fall in; invalid slots mark nothing.  Grouped callers fold
    ``pos_base`` in first (global logical indices)."""
    b = idx.shape[0]
    page = torch.where(valid, idx.long() // page_size,
                       torch.full_like(idx, max_pages, dtype=torch.long))
    touched = torch.zeros((b, max_pages + 1), dtype=torch.bool,
                          device=idx.device)
    # a scatter of the scalar (``touched[rows, page] = True`` would copy a
    # host-made True to the device)
    return touched.scatter_(1, page, True)[:, :max_pages]


def _per_slab(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, ...) -> (B·G, ...): row b repeated for its G slabs (row b·G+g),
    contiguous, made on the device."""
    return x.unsqueeze(1).expand(x.shape[0], g, *x.shape[1:]) \
        .reshape(-1, *x.shape[1:]).contiguous()


def _slab_base(b: int, g: int, s_loc: int, device) -> torch.Tensor:
    """(B·G,) int32 position of each folded row's first slot: g·s_loc."""
    return torch.arange(0, g * s_loc, s_loc, dtype=torch.int32,
                        device=device).repeat(b)


def _fold(a: Optional[torch.Tensor], g: int) -> Optional[torch.Tensor]:
    """(B, S, ...) -> (B·G, S/G, ...) slabs as a VIEW of ``a`` (raises
    rather than copy: the fold must not move the cache)."""
    if a is None:
        return None
    b, s = a.shape[:2]
    return a.view(b * g, s // g, *a.shape[2:])


def _slab_partials(q0, q_lat, k_lat, k_scale, v_q, v_scale, v_zero, u, pos,
                   base, cfg: ModelConfig, sals: SALSConfig, k_loc: int,
                   page_table=None, page_size: int = 0, score_k=None,
                   score_scale=None, recon_table=None):
    """Fused top-k + recon attention over rows (the global plan's batch
    rows, or the grouped plan's slabs).  ``pos`` (N,) decode positions,
    ``base`` (N,) each row's first position (None: 0).  Scoring reads
    ``score_k`` / ``score_scale`` through ``page_table`` (default: the
    latents); reconstruction reads through ``recon_table`` (default: the
    page table).  Returns (m (N, H), l, o (N, H, dh), idx, valid)."""
    sk = k_lat if score_k is None else score_k
    ss = k_scale if score_k is None else score_scale
    rt = page_table if recon_table is None else recon_table
    idx, valid = ops.latent_topk(
        q_lat, sk, ss, pos, n_critical=k_loc, n_sink=sals.n_sink,
        n_recent=sals.n_recent, pos_base=base, page_table=page_table,
        page_size=page_size)
    # ascending positions, invalid slots last: the same accumulation order
    # for both layouts, so paged and dense agree bit for bit
    idx, valid = sel.sort_selected(idx, valid)
    m, l, o = ops.sparse_recon_attention(
        q0, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, pos,
        n_kv=cfg.n_kv_heads, v_bits=sals.v_bits, v_group=sals.v_group,
        theta=cfg.rope_theta, softcap=cfg.attn_logit_softcap,
        use_rope=cfg.use_rope, pos_base=base, page_table=rt,
        page_size=page_size)
    return m, l, o, idx, valid


def _fold_operands(cache: LatentKVCache, g: int):
    """The cache operands of the kernels under a fold into G slabs, and
    the slab length S/G: dense, the per-token arrays viewed as (B·G, S/G,
    ·); paged, the pools as they are and the page table (two-tier: the
    hot table too) viewed as (B·G, mp/G).  Returns (kv, tables, s_loc)
    with kv = (k_lat, k_scale, v_q, v_scale, v_zero) and tables the
    keyword operands of :func:`_slab_partials`."""
    kv = (*cache.latent_views(), cache.v_q, cache.v_scale, cache.v_zero)
    if not cache.paged:
        return tuple(_fold(a, g) for a in kv), {}, kv[0].shape[1] // g
    if cache.tiered:
        # scores from the always-resident r* pool at physical pages,
        # reconstruction from the payload pools at hot slots
        score_k, score_scale, recon_table = \
            cache.k_score, cache.k_scale_score, cache.hot_table
    else:
        score_k, score_scale, recon_table = kv[0], kv[1], cache.page_table
    tables = dict(page_table=_fold(cache.page_table, g),
                  page_size=cache.page_size, score_k=score_k,
                  score_scale=score_scale, recon_table=_fold(recon_table, g))
    return kv, tables, cache.page_table.shape[-1] // g * cache.page_size


def _grouped_partials(q0, q_bar, u, cache: LatentKVCache, pos,
                      cfg: ModelConfig, sals: SALSConfig,
                      collect: bool = False):
    """Stages 2-4 in the cache's plan (:func:`plan_decode`): a
    top-⌈N_c/G⌉ per slab through the fused kernels, the group axis folded
    into the kernel batch (:func:`_fold_operands`); G = 1 is the paper's
    global top-N_c over the rows as they are.  Returns
    (m, l, o) with a G axis, (B, G, H[, dh]), and with ``collect`` (paged
    only) the (B, max_pages) union of the slabs' touched pages."""
    if collect and not cache.paged:
        raise ValueError("selection collection requires the paged cache")
    g = plan_decode(cache).n_groups
    b, h = q0.shape[:2]
    q_lat = sel.latent_query(q_bar, u, sals.score_rank(cfg.kv_dim))
    kv, tables, s_loc = _fold_operands(cache, g)
    if not cache.paged:
        kv = (constrain(kv[0], ("batch", "kv_seq", None)),
              kv[1] if kv[1] is None else constrain(kv[1],
                                                    ("batch", "kv_seq")),
              *kv[2:])
    base = _slab_base(b, g, s_loc, q0.device) if g > 1 else None
    m, l, o, idx, valid = _slab_partials(
        _per_slab(q0, g), _per_slab(q_lat, g), *kv, u, _per_slab(pos, g),
        base, cfg, sals, -(-sals.n_critical // g), **tables)
    out = (m.reshape(b, g, h), l.reshape(b, g, h),
           o.reshape(b, g, h, cfg.head_dim))
    if collect:
        # slab-local -> global logical indices, then one row-wise union
        if base is not None:
            idx = base[:, None] + idx
        out += (_touched_pages(idx.reshape(b, -1), valid.reshape(b, -1),
                               cache.page_size,
                               cache.page_table.shape[-1]),)
    return out


def sals_decode_attend(params, u: torch.Tensor, cache: LatentKVCache,
                       x: torch.Tensor, pos, cfg: ModelConfig,
                       sals: SALSConfig, collect: bool = False):
    """One-token SALS attention for one layer, in the selection layout
    the cache carries (:func:`plan_decode`).

    x: (B, 1, d); pos: scalar or (B,) per-row positions; ``cache`` is a
    single-layer view, updated in place.  Returns (y (B, 1, d), cache),
    plus the (B, max_pages) bool mask of the logical pages the selection
    reconstructed from when ``collect`` (paged caches only: the tiered
    fetch-and-rerun loop reads it)."""
    b = x.shape[0]
    dev = x.device
    kvd = cfg.kv_dim
    w = sals.n_recent
    pos_v = torch.as_tensor(pos, device=dev).to(torch.int32).reshape(-1) \
        .expand(b).contiguous()

    if shd.is_dtensor(x):
        if collect:
            raise ValueError("selection collection needs the paged cache, "
                             "which is never sequence-sharded")
        return _sals_decode_sharded(params, u, cache, x, pos_v, cfg, sals)
    q, k_new, v_new = qkv_proj(params, x, cfg)
    k_flat = k_new.reshape(b, kvd)
    v_flat = v_new.reshape(b, kvd)

    # ---- stage 1: append (latent of the new key in f32) -------------------
    k_lat_new = k_flat.float() @ u.float()
    cache.write(sals, pos_v, k_lat_new, v_flat, k_new[:, 0], v_new[:, 0])

    q_bar = sel.group_query(q[:, 0], cfg)
    q_r = (apply_rope(q, pos_v[:, None], cfg.rope_theta)
           if cfg.use_rope else q)[:, 0]

    # ---- sink + recent region (always attended, full precision) ----------
    m_sr, l_sr, o_sr = _window_partial(q_r, cache, pos_v, cfg, sals)

    # ---- stages 2-4: fused selected-token partials (B, G, H[, dh]) ------
    m_c, l_c, o_c, *touched = _grouped_partials(q[:, 0], q_bar, u, cache,
                                                pos_v, cfg, sals, collect)

    # ---- stage 5: LSE merge across the slabs and the window ---------------
    o = _merge(m_c, l_c, o_c, m_sr, l_sr, o_sr)
    return (out_proj(params, o[:, None].to(x.dtype), cfg), cache, *touched)


def _window_partial(q_r, cache: LatentKVCache, pos_v, cfg: ModelConfig,
                    sals: SALSConfig):
    """The sink + recent region's partial (m, l, o) for RoPE'd queries
    q_r (B, H, dh) at positions ``pos_v`` (B,)."""
    b, dev = q_r.shape[0], q_r.device
    ns = sals.n_sink
    sink_pos = torch.arange(ns, device=dev)[None, :].expand(b, ns)
    rec_pos = sel.ring_positions(pos_v.long(), sals.n_recent)
    sr_k = torch.cat([cache.sink_k, cache.recent_k], dim=1)
    sr_v = torch.cat([cache.sink_v, cache.recent_v], dim=1)
    sr_positions = torch.cat([sink_pos, rec_pos], dim=1)
    sr_valid = (sr_positions >= 0) & (sr_positions <= pos_v[:, None])
    sr_logits = _region_logits(q_r, sr_k, sr_positions, cfg)
    sr_logits = torch.where(sr_valid[:, None, :], sr_logits, NEG)
    return _partial_attend(sr_logits, sr_v, cfg)


def _merge(m_c, l_c, o_c, m_sr, l_sr, o_sr):
    """LSE merge of the G slab partials (B, G, [Q,] H[, dh]) with the
    window's (B, [Q,] H[, dh]) into the normalized output (B, [Q,] H,
    dh).  On DTensors with
    a sharded group axis the G reductions are cross-rank reductions."""
    m_all = torch.maximum(torch.amax(m_c, dim=1), m_sr)
    wc = torch.exp(m_c - m_all[:, None, :])
    wsr = torch.exp(m_sr - m_all)
    denom = torch.sum(wc * l_c, dim=1) + wsr * l_sr
    numer = torch.sum(wc[..., None] * o_c, dim=1) + wsr[..., None] * o_sr
    return numer / torch.clamp_min(denom, 1e-30)[..., None]


def shard_partials(q0, q_bar, u, k_lat, k_scale, v_q, v_scale, v_zero, pos,
                   s0: int, cfg: ModelConfig, sals: SALSConfig, g: int):
    """One rank's slab of the grouped plan: the top-⌈N_c/G⌉ and recon
    partials over slab-local operands (B, S/G, ·) whose first position is
    ``s0`` — the folded plan's row b·G + r for s0 = r·S/G.  Returns (m, l,
    o) with a group axis of 1."""
    q_lat = sel.latent_query(q_bar, u, sals.score_rank(cfg.kv_dim))
    base = torch.full((q0.shape[0],), s0, dtype=torch.int32,
                      device=q0.device)
    m, l, o, _, _ = _slab_partials(q0.contiguous(), q_lat, k_lat, k_scale,
                                   v_q, v_scale, v_zero, u, pos, base, cfg,
                                   sals, -(-sals.n_critical // g))
    return m[:, None], l[:, None], o[:, None]


def _sals_decode_sharded(params, u, cache: LatentKVCache, x, pos_v,
                         cfg: ModelConfig, sals: SALSConfig):
    """:func:`sals_decode_attend` over a DTensor cache (a sharding
    context): the write is each rank's own (:meth:`LatentKVCache.
    write_sharded`); the partials run per rank on local blocks
    (``local_map``) — shard-local slabs when the plan's shard axes split
    S, else the fold over latents gathered along S — and merge as
    DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    b, kvd = x.shape[0], cfg.kv_dim
    plan = plan_decode(cache)
    q, k_new, v_new = qkv_proj(params, x, cfg)
    u_d = u if shd.is_dtensor(u) else shd.replicate_like(u, q)
    k_lat_new = k_new.reshape(b, kvd).float() @ u_d.float()
    cache.write_sharded(sals, pos_v, k_lat_new, v_new.reshape(b, kvd),
                        k_new[:, 0], v_new[:, 0])

    k_lat = constrain(cache.k_lat, ("batch", "kv_seq", None))
    k_scale = None if cache.k_scale is None else \
        constrain(cache.k_scale, ("batch", "kv_seq"))
    seq_axes = shd.dim_axes(k_lat, 1)
    local = bool(plan.shard_axes) and seq_axes == plan.shard_axes
    per_tok = [k_lat, k_scale, cache.v_q, cache.v_scale, cache.v_zero]
    if not local:          # the global plan: gather S on every rank
        per_tok = [None if t is None else t.redistribute(
            t.device_mesh, tuple(Replicate() if p == Shard(1) else p
                                 for p in t.placements)) for t in per_tok]
    mesh = k_lat.device_mesh
    bpl = tuple(Shard(0) if p == Shard(0) else Replicate()
                for p in k_lat.placements)
    gpl = tuple(Shard(0) if p == Shard(0) else
                Shard(1) if local and p == Shard(1) else Replicate()
                for p in k_lat.placements)
    r0, nb = shd.shard_range(k_lat, 0)
    s0, _ = shd.shard_range(k_lat, 1)

    def body(q, u, pos, k_lat, k_scale, v_q, v_scale, v_zero, sink_k,
             sink_v, recent_k, recent_v):
        pos_l = pos[r0:r0 + nb].contiguous()
        q_bar = sel.group_query(q[:, 0], cfg)
        q_r = (apply_rope(q, pos_l[:, None], cfg.rope_theta)
               if cfg.use_rope else q)[:, 0]
        loc = LatentKVCache(k_lat=k_lat, k_scale=k_scale, v_q=v_q,
                            v_scale=v_scale, v_zero=v_zero, sink_k=sink_k,
                            sink_v=sink_v, recent_k=recent_k,
                            recent_v=recent_v, n_groups=plan.n_groups)
        win = _window_partial(q_r, loc, pos_l, cfg, sals)
        if local:
            part = shard_partials(q[:, 0], q_bar, u, k_lat, k_scale, v_q,
                                  v_scale, v_zero, pos_l, s0, cfg, sals,
                                  plan.n_groups)
        else:
            part = _grouped_partials(q[:, 0], q_bar, u, loc, pos_l, cfg,
                                     sals)
        return (*part, *win)

    def pl(t):
        return None if t is None else tuple(t.placements)

    ring = (cache.sink_k, cache.sink_v, cache.recent_k, cache.recent_v)
    args = (q, u_d, pos_v, *per_tok, *ring)
    m_c, l_c, o_c, m_sr, l_sr, o_sr = shd.local_map(
        body, (gpl, gpl, gpl, bpl, bpl, bpl),
        (bpl, pl(u_d), None, *(pl(t) for t in per_tok),
         *(pl(t) for t in ring)), mesh)(*args)
    o = _merge(m_c, l_c, o_c, m_sr, l_sr, o_sr)
    return out_proj(params, o[:, None].to(x.dtype), cfg), cache


# ---------------------------------------------------------------------------
# Speculative verify window: one selection, Q queries
# ---------------------------------------------------------------------------

def _slab_window_partials(q, q_lat, k_lat, k_scale, v_q, v_scale, v_zero, u,
                          pos, base, ql: int, cfg: ModelConfig,
                          sals: SALSConfig, k_loc: int, page_table=None,
                          page_size: int = 0):
    """Windowed :func:`_slab_partials`: ``pos`` (N,) is each row's window
    base and the selection masks at pos + Q − 1, so it covers every
    query's selectable range; the windowed recon kernel reconstructs each
    selected token once and gates query t to positions ≤ pos + t −
    n_recent.  Returns (m (N, Q, H), l, o (N, Q, H, dh))."""
    idx, valid = ops.latent_topk(
        q_lat, k_lat, k_scale, pos + (ql - 1), n_critical=k_loc,
        n_sink=sals.n_sink, n_recent=sals.n_recent, pos_base=base,
        page_table=page_table, page_size=page_size)
    idx, valid = sel.sort_selected(idx, valid)
    return ops.sparse_recon_attention_window(
        q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, pos,
        n_kv=cfg.n_kv_heads, n_recent=sals.n_recent, v_bits=sals.v_bits,
        v_group=sals.v_group, theta=cfg.rope_theta,
        softcap=cfg.attn_logit_softcap, use_rope=cfg.use_rope,
        pos_base=base, page_table=page_table, page_size=page_size)


def _grouped_window_partials(q, q_bar, u, cache: LatentKVCache, pos,
                             ql: int, cfg: ModelConfig, sals: SALSConfig):
    """Windowed :func:`_grouped_partials` (the untiered cache; G = 1: ONE
    global top-N_c for the window).  Returns (m, l, o) shaped (B, G, Q,
    H[, dh])."""
    g = plan_decode(cache).n_groups
    b, h = q.shape[0], q.shape[2]
    q_lat = sel.latent_query(q_bar, u, sals.score_rank(cfg.kv_dim))
    kv, tables, s_loc = _fold_operands(cache, g)
    if not cache.paged:
        kv = (constrain(kv[0], ("batch", "kv_seq", None)),
              kv[1] if kv[1] is None else constrain(kv[1],
                                                    ("batch", "kv_seq")),
              *kv[2:])
    base = _slab_base(b, g, s_loc, q.device) if g > 1 else None
    m, l, o = _slab_window_partials(
        _per_slab(q, g), _per_slab(q_lat, g), *kv, u, _per_slab(pos, g),
        base, ql, cfg, sals, -(-sals.n_critical // g),
        page_table=tables.get("page_table"),
        page_size=tables.get("page_size", 0))
    return (m.reshape(b, g, ql, h), l.reshape(b, g, ql, h),
            o.reshape(b, g, ql, h, cfg.head_dim))


def sals_window_attend(params, u: torch.Tensor, cache: LatentKVCache,
                       x: torch.Tensor, pos, cfg: ModelConfig,
                       sals: SALSConfig):
    """Verify-window SALS attention for one layer, in the selection layout
    the cache carries (:func:`plan_decode`).

    x: (B, Q, d) — the pending token plus Q−1 drafts at positions
    pos..pos+Q−1 (``pos`` scalar or (B,) per-row window base; Q ≤ n_recent
    so the widest selection mask reaches no uncommitted position).
    READ-ONLY on the cache: a rejected draft must never reach the ring,
    sink or latent writes; the caller commits the accepted prefix with
    :meth:`LatentKVCache.write_window` from the returned window K/V.

    One latent selection per slab (the first window token's grouped
    query, masked at the window's last position) serves all Q queries
    through the windowed recon kernel.  The sink / recent region is simulated per
    query: the writes sequential steps pos..pos+t would make (ring slot
    (pos+s) % W, sink while pos+s < n_sink) are replayed into per-query
    views, so query t reads the buffers its sequential step would read.

    Returns (y (B, Q, d), k_pre (B, Q, Hkv, dh), v (B, Q, Hkv, dh))."""
    b, ql, _ = x.shape
    dev = x.device
    w = sals.n_recent
    if cache.tiered:
        raise ValueError("speculative windows need the untiered cache: the "
                         "hot-set fetch contract is per committed step")
    if ql > w:
        raise ValueError(f"verify window {ql} > n_recent {w}: the widest "
                         "selection mask would cover uncommitted positions")
    pos_v = torch.as_tensor(pos, device=dev).to(torch.int32).reshape(-1) \
        .expand(b).contiguous()
    t_idx = torch.arange(ql, dtype=torch.int32, device=dev)
    qpos = pos_v[:, None] + t_idx[None, :]                       # (B, Q)

    q, k_new, v_new = qkv_proj(params, x, cfg)
    q_bar = sel.window_query(q, cfg)
    q_r = apply_rope(q, qpos, cfg.rope_theta) if cfg.use_rope else q

    # ---- per-query sink + recent ring (replayed sequential writes) -------
    # Q <= W, so ring slot j receives at most one window token, s_j =
    # (j - pos) mod W, live for query t iff s_j <= t; sink position p in
    # [pos, pos + t] holds window token p - pos
    ns = sals.n_sink
    k_win = k_new.to(cache.recent_k.dtype)
    v_win = v_new.to(cache.recent_v.dtype)
    bi = torch.arange(b, device=dev)[:, None]

    def replay(buf_k, buf_v, s_j):
        """(B, n) window-token index per buffer slot -> per-query (B, Q, n,
        Hkv, dh) views of (buf_k, buf_v)."""
        hit = ((s_j[:, None, :] >= 0)
               & (s_j[:, None, :] <= t_idx[None, :, None]))[..., None, None]
        s_c = s_j.clamp(0, ql - 1).long()
        return (torch.where(hit, k_win[bi, s_c][:, None], buf_k[:, None]),
                torch.where(hit, v_win[bi, s_c][:, None], buf_v[:, None]))

    j = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    ring_k, ring_v = replay(cache.recent_k, cache.recent_v,
                            torch.remainder(j - pos_v[:, None], w))
    sp = torch.arange(ns, dtype=torch.int32, device=dev)[None, :]
    sink_k, sink_v = replay(cache.sink_k, cache.sink_v, sp - pos_v[:, None])
    rec_pos = sel.ring_positions(qpos.long(), w)                 # (B, Q, w)
    sink_pos = sp.long()[None].expand(b, ql, ns)

    sr_k = torch.cat([sink_k, ring_k], dim=2)      # (B, Q, ns+w, Hkv, dh)
    sr_v = torch.cat([sink_v, ring_v], dim=2)
    sr_positions = torch.cat([sink_pos, rec_pos], dim=2)
    sr_valid = (sr_positions >= 0) & (sr_positions <= qpos[..., None])
    sr_logits = _region_logits_window(q_r, sr_k, sr_positions, cfg)
    sr_logits = torch.where(sr_valid[:, :, None, :], sr_logits, NEG)
    m_sr, l_sr, o_sr = _partial_attend(sr_logits, sr_v, cfg)

    # ---- selected-token partials, (B, G, Q, H[, dh]) ----------------------
    m_c, l_c, o_c = _grouped_window_partials(q, q_bar, u, cache, pos_v, ql,
                                             cfg, sals)

    # ---- LSE merge across the slabs and the window ------------------------
    o = _merge(m_c, l_c, o_c, m_sr, l_sr, o_sr)
    return out_proj(params, o.to(x.dtype), cfg), k_new, v_new
