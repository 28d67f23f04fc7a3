"""Multi-head / grouped-query attention (port of the train, prefill and
full-precision decode paths of ``repro/models/attention.py``).

  * ``attend_train``       — full attention over a block for the training
                             forward: ``ops.flash_attention``, which under
                             autograd is the flash kernel with its backward
                             (``FlashAttentionFn``).
  * ``attend_prefill``     — causal attention over the prompt through the
                             flash kernel (``ops.flash_attention``: the CUDA
                             kernel on the card at every length, the
                             materialized twin on the CPU); also returns the
                             pre-RoPE K and V for the cache builds.
  * ``attend_prefill_chunk`` — one chunk of prompt queries against the
                             cache written so far plus the chunk itself
                             (chunked prefill): two partials LSE-merged in
                             plain torch, as the reference computes them
                             outside any Pallas kernel; the chunk's K/V are
                             appended to the cache IN PLACE.
  * ``attend_decode_full`` — one-token decode against a full-precision cache
                             of post-RoPE keys (the SALS skip layers and the
                             SALS-disabled baseline).  The cache tensors are
                             updated IN PLACE (the reference returns new
                             arrays).

  * ``attend_decode_full_window`` — a speculative verify window of Q
                             tokens against the same cache.  The window's
                             K/V are written IN PLACE at positions pos..
                             pos+Q−1, at or past the committed length,
                             where no committed read looks; a later round
                             or step overwrites the rejected ones, so
                             committing the accepted prefix writes nothing
                             (the reference scatters into a transient copy
                             of the cache, B·S·kv_dim·2·2 bytes per layer
                             and round).

The SALS decode path is ``core/sparse_attention.py``; it reuses
``qkv_proj`` / ``out_proj`` from here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, constrain
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, frozen_param,
                                       truncated_normal_)

NEG_INF = -2.0 ** 30


class Attention(nn.Module):
    """wq (d, q_dim), wk/wv (d, kv_dim), wo (q_dim, d) [+ biases]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

        def e(*shape):
            return frozen_param(torch.empty(shape, dtype=dtype, device=device))

        self.wq, self.wk, self.wv, self.wo = e(d, qd), e(d, kvd), e(d, kvd), \
            e(qd, d)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = e(qd), e(kvd), e(kvd)
            for bias in (self.bq, self.bk, self.bv):
                bias.data.zero_()

    def init_(self, generator: torch.Generator) -> None:
        d, qd = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            truncated_normal_(w.data, d ** -0.5, generator)
        truncated_normal_(self.wo.data, qd ** -0.5, generator)


def attention_specs(cfg: ModelConfig) -> dict:
    specs = {
        "wq": P(None, "model"),
        "wk": P(None, "model"),
        "wv": P(None, "model"),
        "wo": P("model", None),
    }
    if cfg.qkv_bias:
        specs.update({"bq": P("model"), "bk": P("model"), "bv": P("model")})
    return specs


def qkv_proj(params: Attention, x: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,dh), k/v (B,S,Hkv,dh).  No RoPE applied.
    A DTensor ``x`` is gathered along the sequence first (as
    :func:`~repro_torch.models.layers.mlp_apply`)."""
    x = constrain(x, ("batch", "seq", "embed"))
    b, s, _ = x.shape
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    return (constrain(_heads(q, cfg.n_heads, cfg.head_dim),
                      ("batch", "seq", "heads", None)),
            constrain(_heads(k, cfg.n_kv_heads, cfg.head_dim),
                      ("batch", "seq", "kv_heads", None)),
            constrain(_heads(v, cfg.n_kv_heads, cfg.head_dim),
                      ("batch", "seq", "kv_heads", None)))


class _MergeHeads(torch.autograd.Function):
    """(B, S, H, dh) -> (B, S, H·dh), whose backward splits the gradient
    with :func:`_heads`: under tensor parallelism the gradient comes back
    split along H·dh over the ``model`` axis, which may not divide H."""

    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[-2:]
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return _heads(g, *ctx.heads)


def _even(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """DTensor ``t`` made whole along ``dim`` where that dim is split over
    more ranks than divide ``n`` heads (qwen2-1.5b's 12, hymba's 25 over a
    16-wide model axis): DTensor cannot split a view's head dim unevenly,
    where the reference's GSPMD pads.  A plain tensor as it is."""
    if shd.is_dtensor(t):
        dim %= t.ndim
        axes = shd.dim_axes(t, dim)
        if axes and n % shd.axis_size(axes, t.device_mesh):
            t = t.redistribute(t.device_mesh, tuple(
                Replicate() if p == Shard(dim) else p for p in t.placements))
    return t


def _heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n·dh) -> (B, S, n, dh), the last dim made :func:`_even`
    first."""
    return _even(t, -1, n).reshape(*t.shape[:-1], n, dh)


def out_proj(params: Attention, attn_out: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """attn_out: (B, S, H, dh) -> (B, S, d)."""
    return _MergeHeads.apply(_even(attn_out, -2, attn_out.shape[-2])) \
        @ params.wo


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, Hkv, dh) -> (B, S, Hkv*group, dh) for GQA head expansion."""
    if group == 1:
        return x
    b, s, hkv, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, hkv, group, dh) \
        .reshape(b, s, hkv * group, dh)


def attend_prefill(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor] = None,
                   prefix_len: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over a block; also returns (pre-RoPE K, V).

    Returns (y (B,S,d), k_pre (B,S,Hkv,dh), v (B,S,Hkv,dh)).  K/V go to the
    flash kernel unexpanded: the kernel reads kv head h // group, which is
    the same function as attending ``repeat_kv``'s copy."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k_pre, v = qkv_proj(params, x, cfg)
    if shd.is_dtensor(q):
        o = _flash_sharded(q, k_pre, v, positions, cfg, prefix_len)
        o = constrain(o, ("batch", "seq", "heads", None))
        return out_proj(params, o, cfg), k_pre, v
    q_r = apply_rope(q, positions, cfg.rope_theta) if cfg.use_rope else q
    k_r = apply_rope(k_pre, positions, cfg.rope_theta) if cfg.use_rope \
        else k_pre
    o = ops.flash_attention(q_r.contiguous(), k_r.contiguous(),
                            v.contiguous(),
                            causal=cfg.causal and not prefix_len,
                            softcap=cfg.attn_logit_softcap,
                            prefix_len=prefix_len)
    return out_proj(params, o, cfg), k_pre, v


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                  h0: int, h_loc: int):
    """The K/V heads query heads [h0, h0 + h_loc) read, as the flash
    kernel takes them (kv head h // group): a slice when the range covers
    whole groups or lies inside one, else the GQA-expanded slice."""
    g = cfg.group_size
    if h_loc == cfg.n_heads:
        return k, v
    if h_loc % g == 0 and h0 % g == 0:
        sl = slice(h0 // g, (h0 + h_loc) // g)
    elif g % h_loc == 0:
        sl = slice(h0 // g, h0 // g + 1)
    else:
        sl = slice(h0, h0 + h_loc)
        k, v = repeat_kv(k, g), repeat_kv(v, g)
    return k[:, :, sl], v[:, :, sl]


def _flash_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig,
                   prefix_len: int) -> torch.Tensor:
    """RoPE + the flash kernel on each rank's batch rows and query heads
    (``local_map``): K/V come replicated over the head axes and each rank
    takes the kv heads its query heads read; their gradient leaves each
    rank partial and is summed.  The backward is ``FlashAttentionFn``'s on
    the same local blocks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qpl = tuple(q.placements)
    on_heads = [i for i, p in enumerate(qpl) if p == Shard(2)]
    kvpl = tuple(Replicate() if i in on_heads else p
                 for i, p in enumerate(qpl))
    kv_grad = tuple(Partial() if i in on_heads else p
                    for i, p in enumerate(qpl))
    head_axes = tuple(mesh.mesh_dim_names[i] for i in on_heads)

    def body(q, k, v, positions):
        h_loc = q.shape[2]
        h0 = shd.axis_index(mesh, head_axes) * h_loc
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        k, v = _kv_for_heads(k, v, cfg, h0, h_loc)
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(),
                                   causal=cfg.causal and not prefix_len,
                                   softcap=cfg.attn_logit_softcap,
                                   prefix_len=prefix_len)

    return shd.local_map(body, qpl, (qpl, kvpl, kvpl, None), mesh,
                         in_grad_placements=(qpl, kv_grad, kv_grad, None))(
        q, k, v, positions)


def attend_train(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None,
                 prefix_len: int = 0) -> torch.Tensor:
    """Full attention over a block: (B, S, d) -> (B, S, d) — the prefill
    attention without its cache outputs."""
    return attend_prefill(params, x, cfg, positions, prefix_len)[0]


def _chunk_partial(logits: torch.Tensor, v: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-style partial softmax stats for a chunk of queries.  logits:
    (B, H, C, N) f32, already masked with NEG_INF; v: (B, N, Hkv, dh)
    unexpanded.  Returns (m (B,H,C), l (B,H,C), o (B,H,C,dh)); fully masked
    rows give l = 0."""
    m = torch.max(logits, dim=-1).values
    p = torch.exp(logits - m[..., None])
    p = torch.where(logits <= NEG_INF / 2, torch.zeros_like(p), p)
    l = torch.sum(p, dim=-1)
    b, h, c, n = logits.shape
    p_g = p.reshape(b, cfg.n_kv_heads, cfg.group_size, c, n)
    o = torch.einsum("bkrcn,bnkd->bkrcd", p_g, v.float())
    return m, l, o.reshape(b, h, c, cfg.head_dim)


def _chunk_logits(q_r: torch.Tensor, k: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """GQA QKᵀ of a chunk of RoPE'd queries q_r (B, C, H, dh) against
    post-RoPE keys k (B, N, Hkv, dh): (B, H, C, N) f32, scaled and
    softcapped, the query split (Hkv, group) with no repeated K copy."""
    b, c = q_r.shape[:2]
    q_g = q_r.reshape(b, c, cfg.n_kv_heads, cfg.group_size,
                      cfg.head_dim).float()
    logits = torch.einsum("bckrd,bnkd->bkrcn", q_g, k.float())
    logits = logits.reshape(b, cfg.n_heads, c, k.shape[1])
    logits = logits * (cfg.head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return logits


def attend_prefill_chunk(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                         off, k_cache: torch.Tensor, v_cache: torch.Tensor):
    """Chunk-vs-cache attention: one fixed-width chunked-prefill step.

    x: (B, C, d) hidden states of prompt positions [off, off+C) (the same
    offset for every row: a ragged batch is right-padded); ``off`` a 0-d
    integer tensor on x's device (a Python int from a direct caller);
    k_cache/v_cache: (B, S_max, Hkv, dh) post-RoPE keys / values of every
    earlier prompt position.  The cache partial (positions < off) and the
    intra-chunk causal partial are LSE-merged; then the chunk's K/V are
    written into the caches at [off, off+C), in place.  ``off`` stays on
    the device throughout, so one captured program serves every chunk.

    Returns (y (B,C,d), k_pre (B,C,Hkv,dh), v (B,C,Hkv,dh), k_cache,
    v_cache)."""
    b, c, _ = x.shape
    dev = x.device
    off = torch.as_tensor(off, device=dev)
    positions = (off + torch.arange(c, device=dev))[None, :]
    q, k_pre, v = qkv_proj(params, x, cfg)
    if cfg.use_rope:
        q_r = apply_rope(q, positions, cfg.rope_theta)
        k_r = apply_rope(k_pre, positions, cfg.rope_theta)
    else:
        q_r, k_r = q, k_pre

    # cache partial: history positions < off
    hist = torch.arange(k_cache.shape[1], device=dev) < off
    lg_h = torch.where(hist, _chunk_logits(q_r, k_cache, cfg), NEG_INF)
    m_h, l_h, o_h = _chunk_partial(lg_h, v_cache, cfg)

    # chunk partial: intra-chunk causal
    ar = torch.arange(c, device=dev)
    causal = ar[:, None] >= ar[None, :]
    lg_c = torch.where(causal, _chunk_logits(q_r, k_r, cfg), NEG_INF)
    m_c, l_c, o_c = _chunk_partial(lg_c, v, cfg)

    # LSE merge (the chunk partial always holds the self entry: denom > 0)
    m = torch.maximum(m_h, m_c)
    w_h = torch.exp(m_h - m)
    w_c = torch.exp(m_c - m)
    denom = w_h * l_h + w_c * l_c
    o = (w_h[..., None] * o_h + w_c[..., None] * o_c) \
        / torch.clamp_min(denom, 1e-30)[..., None]            # (B,H,C,dh)
    o = o.transpose(1, 2).to(x.dtype)                          # (B,C,H,dh)
    y = out_proj(params, o, cfg)
    k_cache.index_copy_(1, positions[0], k_r.to(k_cache.dtype))
    v_cache.index_copy_(1, positions[0], v.to(v_cache.dtype))
    return (y, k_pre, v, constrain(k_cache, CACHE_AXES),
            constrain(v_cache, CACHE_AXES))


def _decode_logits(q: torch.Tensor, kc: torch.Tensor, pos: torch.Tensor,
                   s0: int, cfg: ModelConfig) -> torch.Tensor:
    """Masked logits of one RoPE'd query token per row against cache rows
    s0 .. s0+n-1: q (B, 1, H, dh); kc (B, n, Hkv, dh) post-RoPE keys;
    pos (B,).  Returns (B, Hkv, G, n) f32, positions past ``pos`` at
    NEG_INF, taken in f32 over the cache's working-dtype values, as the
    reference's ``preferred_element_type=f32`` contraction."""
    b, n = kc.shape[:2]
    valid = torch.arange(s0, s0 + n, device=kc.device)[None, :] \
        <= pos[:, None]
    q_g = q[:, 0].reshape(b, cfg.n_kv_heads, cfg.group_size, cfg.head_dim)
    logits = torch.einsum("bkrd,bskd->bkrs", q_g.float(),
                          kc.to(q.dtype).float()) * cfg.head_dim ** -0.5
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    return torch.where(valid[:, None, None, :], logits, NEG_INF)


def _decode_pv(p: torch.Tensor, vc: torch.Tensor, dtype, cfg: ModelConfig
               ) -> torch.Tensor:
    """Softmax probabilities p (B, Hkv, G, n), rounded to the working
    ``dtype``, times values vc (B, n, Hkv, dh): (B, H, dh) f32."""
    o = torch.einsum("bkrs,bskd->bkrd", p.to(dtype).float(),
                     vc.to(dtype).float())
    return o.reshape(p.shape[0], cfg.n_heads, cfg.head_dim)


def attend_decode_full(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, pos
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a full-precision cache.

    x: (B, 1, d); k_cache/v_cache: (B, S_max, Hkv, dh), k_cache holding
    post-RoPE keys; pos: scalar or (B,) per-row positions.  The new token's
    K/V are written into the caches in place.  Logits and the value sum are
    taken in f32 over the cache's working-dtype values, as the reference's
    ``preferred_element_type=f32`` contractions are.
    Returns (y, k_cache, v_cache)."""
    b = x.shape[0]
    dev = x.device
    pos_v = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1) \
        .expand(b)
    if shd.is_dtensor(x):
        return _decode_full_sharded(params, x, cfg, k_cache, v_cache, pos_v)
    q, k, v = qkv_proj(params, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, pos_v[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_v[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=dev)
    k_cache[rows, pos_v] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, pos_v] = v[:, 0].to(v_cache.dtype)
    p = torch.softmax(_decode_logits(q, k_cache, pos_v, 0, cfg), dim=-1)
    o = _decode_pv(p, v_cache, q.dtype, cfg)
    o = o.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return out_proj(params, o, cfg), k_cache, v_cache


CACHE_AXES = ("batch", "kv_seq_full", "kv_heads", None)


def _decode_full_sharded(params: Attention, x, cfg: ModelConfig, k_cache,
                         v_cache, pos_v: torch.Tensor):
    """:func:`attend_decode_full` over DTensor caches: each rank writes the
    new token's K/V into the rows and positions it owns (at its
    slab-local index), then takes the logits of its own slab
    (``local_map``: RoPE'd query, positions <= pos).  The softmax runs on
    the logits as a DTensor, which makes each row whole along S first, so
    the probabilities are the plain path's bits, rounded to the working
    dtype as there; each rank's slab gives its share of P V and the shares
    sum."""
    from torch.distributed.tensor import Replicate, Shard
    q, k, v = qkv_proj(params, x, cfg)
    r0, nb = shd.shard_range(k_cache, 0)
    s0, ns = shd.shard_range(k_cache, 1)
    pos_l = pos_v[r0:r0 + nb]
    k_l = shd.rows_like(k, k_cache)
    if cfg.use_rope:
        k_l = apply_rope(k_l, pos_l[:, None], cfg.rope_theta)
    mine = ((pos_l >= s0) & (pos_l < s0 + ns))[:, None, None]
    at = (torch.arange(nb, device=x.device), (pos_l - s0).clamp(0, ns - 1))
    for cache, val in ((k_cache, k_l), (v_cache, shd.rows_like(v, k_cache))):
        loc = cache.to_local()
        loc[at] = torch.where(mine, val[:, 0].to(loc.dtype), loc[at])
    k_cache = constrain(k_cache, CACHE_AXES)
    v_cache = constrain(v_cache, CACHE_AXES)

    mesh = k_cache.device_mesh
    cpl = tuple(k_cache.placements)
    bpl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in cpl)
    # logits (B, Hkv, G, S) and the P V shares (B, S-shards, H, dh): S
    # split as the cache's
    lpl = tuple(Shard(0) if p == Shard(0) else
                Shard(3) if p == Shard(1) else Replicate() for p in cpl)
    gpl = tuple(Shard(0) if p == Shard(0) else
                Shard(1) if p == Shard(1) else Replicate() for p in cpl)

    def logits_body(q, kc, pos):
        pos_l = pos[r0:r0 + nb]
        if cfg.use_rope:
            q = apply_rope(q, pos_l[:, None], cfg.rope_theta)
        return _decode_logits(q, kc, pos_l, s0, cfg)

    logits = shd.local_map(logits_body, lpl, (bpl, cpl, None), mesh)(
        q, k_cache, pos_v)
    p = torch.softmax(logits, dim=-1)
    o = shd.local_map(lambda p, vc: _decode_pv(p, vc, q.dtype, cfg)[:, None],
                      gpl, (lpl, tuple(v_cache.placements)), mesh)(
        p, v_cache)
    # the shares sum in f32 before the cast to the working dtype
    o = torch.sum(o, dim=1).redistribute(mesh, bpl)[:, None].to(x.dtype)
    return out_proj(params, o, cfg), k_cache, v_cache


def attend_decode_full_window(params: Attention, x: torch.Tensor,
                              cfg: ModelConfig, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Verify-window decode against a full-precision cache.

    x: (B, Q, d) — the pending token plus Q−1 drafts at positions
    pos..pos+Q−1 (``pos`` scalar or (B,) window base).  Their post-RoPE K
    and V are written into the caches in place (positions past the end of
    the cache are dropped: they are never committed), and query t attends
    positions ≤ pos + t, as sequential step pos + t would.  Returns
    y (B, Q, d)."""
    b, ql, _ = x.shape
    dev = x.device
    pos_v = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1) \
        .expand(b)
    qpos = pos_v[:, None] + torch.arange(ql, device=dev)[None, :]
    q, k, v = qkv_proj(params, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
    rows = torch.arange(b, device=dev)
    s_max = k_cache.shape[1]
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))
    for t in range(ql):
        # one slot per write: a clamped position can never alias another
        # row's (or this row's kept) target within one index_put
        inside = qpos[:, t] < s_max
        at = (rows, qpos[:, t].clamp_max(s_max - 1))
        for cache, val in ((k_cache, k), (v_cache, v)):
            cache[at] = torch.where(inside[:, None, None],
                                    val[:, t].to(cache.dtype), cache[at])
    k_cache = constrain(k_cache, CACHE_AXES)
    v_cache = constrain(v_cache, CACHE_AXES)
    valid = torch.arange(s_max, device=dev)[None, None, :] \
        <= qpos[:, :, None]                                    # (B, Q, S)
    q_g = q.reshape(b, ql, cfg.n_kv_heads, cfg.group_size, cfg.head_dim)
    logits = torch.einsum("bqkrd,bskd->bqkrs", q_g.float(),
                          k_cache.to(q.dtype).float()) \
        * cfg.head_dim ** -0.5
    if cfg.attn_logit_softcap:
        logits = cfg.attn_logit_softcap * torch.tanh(
            logits / cfg.attn_logit_softcap)
    logits = torch.where(valid[:, :, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bqkrs,bskd->bqkrd", p.to(q.dtype).float(),
                     v_cache.to(q.dtype).float())
    o = o.reshape(b, ql, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return out_proj(params, o, cfg)


def init_full_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device="cuda") -> dict:
    """Cache of one full-precision layer."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
