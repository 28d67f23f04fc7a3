"""Plain PyTorch twins of the kernel contracts (port of ``repro/kernels/ref.py``).

Small, obviously-correct implementations: materialized attention, full
latent scoring + a stable two-key top-k, gather → dequant → reconstruct →
RoPE → attend.  ``kernels/ops.py`` runs them for tensors on the CPU, and the
tests and ``chip_smoke.py`` hold the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -2.0 ** 30


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: (..., seq, heads, dh); positions broadcastable to (..., seq).
    Returns x's dtype, as the reference does."""
    half = x.shape[-1] // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=x.device), ar)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_mask(sq: int, sk: int, causal: bool, prefix_len: int, device):
    """(Sq, Sk) bool visibility, or None: causal at q_off = Sk - Sq, keys
    below ``prefix_len`` visible to every query."""
    if not (causal or prefix_len):
        return None
    kp = torch.arange(sk, device=device)[None, :]
    cm = torch.arange(sq, device=device)[:, None] + (sk - sq) >= kp
    if prefix_len:
        cm = cm | (kp < prefix_len)
    return cm


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16 / f16 / f32 inputs; f64 stays f64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    return k if k.shape[2] == h else \
        torch.repeat_interleave(k, h // k.shape[2], dim=2)


def _attention(q, k, v, causal, softcap, mask, prefix_len, with_lse: bool):
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    acc = _acc_dtype(q)
    scale = dh ** -0.5
    cm = _attn_mask(sq, sk, causal, prefix_len, q.device)
    outs, lses = [], []
    for i in range(b):
        logits = torch.einsum("qhd,khd->hqk", q[i].to(acc),
                              k[i].to(acc)) * scale
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        if cm is not None:
            logits = torch.where(cm[None], logits, NEG_INF)
        if mask is not None:
            mi = mask[i] if mask.shape[0] == b else mask[0]
            logits = torch.where(mi, logits, NEG_INF)
        if with_lse:
            lses.append(torch.logsumexp(logits, dim=-1))
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("hqk,khd->qhd", p.to(v.dtype).to(acc), v[i].to(acc))
        outs.append(o.to(v.dtype))
    out = torch.stack(outs)
    return (out, torch.stack(lses)) if with_lse else out


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, softcap: float = 0.0,
                  mask: Optional[torch.Tensor] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """Materialized attention.  q: (B,Sq,H,dh); k/v: (B,Sk,Hk,dh) with
    Hk == H, or Hk dividing H (kv head ``h // (H // Hk)`` serves query head
    h — the same function as attending ``repeat_kv``'s expanded copy).
    ``prefix_len`` > 0 is prefix-LM masking, as the reference's
    ``ops._mask_logits`` and Pallas kernel: the first ``prefix_len`` keys
    are visible to every query and the rest causally, ``(kp <
    prefix_len) | (qp >= kp)``, whatever ``causal`` says.
    ``mask`` (1 or B, Sq, Sk) bool, if given, also drops logits where it
    is false.  Returns (B,Sq,H,dh) in v's dtype.  Rows are processed one
    batch row at a time to bound the (H, Sq, Sk) logits buffer."""
    return _attention(q, k, v, causal, softcap, mask, prefix_len, False)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, softcap: float = 0.0,
                      prefix_len: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref` and each row's log-sum-exp of the masked
    logits (B, H, Sq) f32, natural log (the reference's ``_flash_fwd_impl``
    saves the same for its backward)."""
    return _attention(q, k, v, causal, softcap, None, prefix_len, True)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, softcap: float = 0.0,
                      prefix_len: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`attention_lse_ref` from the saved (O, LSE):
    the reference's FlashAttention-2 rule ``ops._flash_bwd_rule`` in plain
    tensor ops, one batch row at a time.

    D = rowsum(dO·O); P = exp(S − LSE), masked entries 0; dV = Pᵀ dO;
    dS = P·(dO Vᵀ − D), times (1 − tanh²) under softcap, times the scale;
    dQ = dS K, dK = dSᵀ Q, all in f32 (f64 for f64 inputs).  P and dS are
    rounded to the input dtype before their products (``_flash_bwd_rule``
    l.199, 208; a no-op in f32).  GQA (Hk dividing H): dK and dV come back
    at Hk heads, each group's heads summed in ascending head order.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kx, vx = _expand_kv(k, h), _expand_kv(v, h)
    acc = _acc_dtype(q)
    scale = dh ** -0.5
    cm = _attn_mask(sq, sk, causal, prefix_len, q.device)
    dsum = torch.einsum("bqhd,bqhd->bhq", do.to(acc), o.to(acc))
    dqs, dks, dvs = [], [], []
    for i in range(b):
        qi, ki, vi, doi = (x[i].to(acc) for x in (q, kx, vx, do))
        s_raw = torch.einsum("qhd,khd->hqk", qi, ki) * scale
        if softcap:
            t = torch.tanh(s_raw / softcap)
            logits = softcap * t
        else:
            logits = s_raw
        p = torch.exp(logits - lse[i][..., None])
        if cm is not None:
            p = torch.where(cm[None], p, 0.0)
        p16 = p.to(do.dtype).to(acc)
        dvs.append(torch.einsum("hqk,qhd->khd", p16, doi))
        dp = torch.einsum("qhd,khd->hqk", doi, vi)
        dl = p * (dp - dsum[i][..., None])
        if softcap:
            dl = dl * (1.0 - t * t)
        dl16 = (dl * scale).to(k.dtype).to(acc)
        dqs.append(torch.einsum("hqk,khd->qhd", dl16, ki))
        dks.append(torch.einsum("hqk,qhd->khd", dl16, qi))
    dq = torch.stack(dqs)
    dk, dv = torch.stack(dks), torch.stack(dvs)
    if hk != h:
        def fold(x):
            x = x.reshape(b, sk, hk, h // hk, dh)
            tot = x[:, :, :, 0]
            for g in range(1, h // hk):
                tot = tot + x[:, :, :, g]
            return tot
        dk, dv = fold(dk), fold(dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def latent_score_ref(q_lat: torch.Tensor, k_lat: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_lat: (B, r*), k_lat: (B, S, r>=r*) -> (B, S) f32 scores;
    ``k_scale`` (B, S): per-token dequant scale for int8 latents."""
    r_star = q_lat.shape[-1]
    scores = torch.einsum("br,bsr->bs", q_lat.float(),
                          k_lat[..., :r_star].float())
    if k_scale is not None:
        scores = scores * k_scale.float()
    return scores


def row_vector(x, b: int, device) -> torch.Tensor:
    """Scalar-or-(B,) integer -> contiguous (B,) int32 on ``device``.  A
    Python int is filled on the device (no host-to-device copy: a CUDA
    graph can capture it)."""
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int32, device=device)
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(b).contiguous()


def topk_desc_stable(x: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered (value desc, index asc) — the
    order ``lax.top_k`` gives.  ``torch.topk`` promises no tie order, so
    this is a stable descending sort and a slice."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def latent_topk_ref(q_lat: torch.Tensor, k_lat: torch.Tensor,
                    k_scale: Optional[torch.Tensor], pos, *, n_critical: int,
                    n_sink: int, n_recent: int,
                    pos_base: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scoring + selection over the raw latent cache.

    Masks the sink / recent / future ranges (row b's token j is selectable
    iff ``n_sink <= pos_base[b]+j <= pos[b]-n_recent``) and takes the
    global top-N_c.  Returns (idx (B, N_c) int32, valid (B, N_c) bool).
    A cache shorter than N_c pads with (NEG_INF, index 0), as the kernel's
    merge does."""
    scores = latent_score_ref(q_lat, k_lat, k_scale)
    b, s = scores.shape
    dev = scores.device
    base = torch.zeros(b, dtype=torch.int32, device=dev) if pos_base is None \
        else row_vector(pos_base, b, dev)
    pos_b = row_vector(pos, b, dev)
    positions = torch.arange(s, device=dev)[None, :] + base[:, None]
    mask = (positions >= n_sink) & (positions <= pos_b[:, None] - n_recent)
    masked = torch.where(mask, scores, NEG_INF)
    if s < n_critical:
        masked = torch.cat([masked, torch.full((b, n_critical - s), NEG_INF,
                                               device=dev)], dim=1)
    vals, idx = topk_desc_stable(masked, n_critical)
    idx = torch.where(idx < s, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), vals > NEG_INF / 2


def paged_logical_view(pool: torch.Tensor, page_table: torch.Tensor,
                       page_size: int) -> torch.Tensor:
    """The logical (B, S, ...) view of a paged field, S = max_pages ·
    page_size.  pool: (n_pages, page_size, ...); page_table: (B, max_pages)
    int32.  Table entries are clamped into the pool, as the kernels clamp
    them (unmapped entries may hold anything; the position masks keep them
    unselectable).  The paged kernels never build this array; the twins
    and tests do."""
    b, mp = page_table.shape
    pid = page_table.long().clamp(0, pool.shape[0] - 1).reshape(-1)
    return pool[pid].reshape(b, mp * page_size, *pool.shape[2:])


def latent_topk_paged_ref(q_lat: torch.Tensor, k_lat: torch.Tensor,
                          k_scale: Optional[torch.Tensor], pos, *,
                          page_table: torch.Tensor, page_size: int,
                          n_critical: int, n_sink: int, n_recent: int,
                          pos_base: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged selection twin: gather the logical view, run the dense twin
    (same tie-breaks, so indices are logical and equal to the dense
    layout's on the same logical contents)."""
    ks = None if k_scale is None else \
        paged_logical_view(k_scale, page_table, page_size)
    return latent_topk_ref(q_lat, paged_logical_view(k_lat, page_table,
                                                     page_size),
                           ks, pos, n_critical=n_critical, n_sink=n_sink,
                           n_recent=n_recent, pos_base=pos_base)


def sparse_recon_attention_paged_ref(
        q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, q_pos, *,
        page_table: torch.Tensor, page_size: int, n_kv: int, v_bits: int = 8,
        v_group: int = 64, theta: float = 10_000.0, softcap: float = 0.0,
        use_rope: bool = True, pos_base: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged fused-attention twin: the cache operands are page pools,
    ``idx`` stays logical; gathers the logical views and delegates."""
    def view(a):
        return None if a is None else \
            paged_logical_view(a, page_table, page_size)
    return sparse_recon_attention_fused_ref(
        q, view(k_lat), view(k_scale), view(v_q), view(v_scale),
        view(v_zero), u, idx, valid, q_pos, n_kv=n_kv, v_bits=v_bits,
        v_group=v_group, theta=theta, softcap=softcap, use_rope=use_rope,
        pos_base=pos_base)


def sparse_recon_attention_window_paged_ref(
        q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, q_pos, *,
        page_table: torch.Tensor, page_size: int, n_kv: int,
        n_recent: int = 0, v_bits: int = 8, v_group: int = 64,
        theta: float = 10_000.0, softcap: float = 0.0, use_rope: bool = True,
        pos_base: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged verify-window twin: the cache operands are page pools, ``idx``
    stays logical; gathers the (clamping) logical views and delegates."""
    def view(a):
        return None if a is None else \
            paged_logical_view(a, page_table, page_size)
    return sparse_recon_attention_fused_window_ref(
        q, view(k_lat), view(k_scale), view(v_q), view(v_scale),
        view(v_zero), u, idx, valid, q_pos, n_kv=n_kv, n_recent=n_recent,
        v_bits=v_bits, v_group=v_group, theta=theta, softcap=softcap,
        use_rope=use_rope, pos_base=pos_base)


def dequantize_values_ref(code: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, v_bits: int, v_group: int
                          ) -> torch.Tensor:
    """Group dequant oracle.  code: (..., code_w) int8/uint8; scale/zero:
    (..., G).  Returns f32 (int8 codes carry a -128 offset; int4 codes are
    packed two per byte, even channel in the low nibble)."""
    if v_bits == 4:
        c = code.to(torch.int32)
        lo = (c & 0x0F).float()
        hi = ((c >> 4) & 0x0F).float()
        vals = torch.stack([lo, hi], dim=-1).reshape(
            *code.shape[:-1], code.shape[-1] * 2)
    else:
        vals = code.float() + 128.0
    vg = vals.reshape(*vals.shape[:-1], -1, v_group)
    out = vg * scale[..., None].float() + zero[..., None].float()
    return out.reshape(vals.shape)


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a: (B, S, ...) ; idx: (B, N) -> (B, N, ...)."""
    bi = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[bi, idx.long()]


def gather_dequant_ref(k_lat: torch.Tensor, k_scale: Optional[torch.Tensor],
                       v_q: torch.Tensor, v_scale: torch.Tensor,
                       v_zero: torch.Tensor, idx: torch.Tensor, *,
                       v_bits: int, v_group: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + dequant: (lat (B, N_c, r) f32, v (B, N_c, kvd) f32)."""
    lat = _take_rows(k_lat, idx).float()
    if k_scale is not None:
        lat = lat * _take_rows(k_scale.float(), idx)[..., None]
    v = dequantize_values_ref(_take_rows(v_q, idx), _take_rows(v_scale, idx),
                              _take_rows(v_zero, idx), v_bits, v_group)
    return lat, v


def sparse_recon_attention_fused_ref(
        q: torch.Tensor, k_lat: torch.Tensor, k_scale: Optional[torch.Tensor],
        v_q: torch.Tensor, v_scale: torch.Tensor, v_zero: torch.Tensor,
        u: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, q_pos, *,
        n_kv: int, v_bits: int = 8, v_group: int = 64,
        theta: float = 10_000.0, softcap: float = 0.0, use_rope: bool = True,
        pos_base: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Index-taking twin: gather-then-attend.  Selected row n of batch row b
    sits at position ``pos_base[b] + idx[b, n]``.  Indices are clamped into
    [0, S) (invalid slots may carry anything)."""
    idx_c, sel_pos = _selected_positions(idx, k_lat.shape[1], pos_base)
    lat, v = gather_dequant_ref(k_lat, k_scale, v_q, v_scale, v_zero, idx_c,
                                v_bits=v_bits, v_group=v_group)
    return sparse_recon_attention_ref(q, lat, v, u, sel_pos, valid, q_pos,
                                      n_kv=n_kv, theta=theta, softcap=softcap,
                                      use_rope=use_rope)


def _selected_positions(idx: torch.Tensor, s: int, pos_base
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamped cache rows (B, N) and their positions pos_base[b] + row."""
    idx_c = idx.long().clamp(0, s - 1)
    if pos_base is None:
        return idx_c, idx_c
    return idx_c, idx_c + row_vector(pos_base, idx.shape[0],
                                     idx.device)[:, None]


def sparse_recon_attention_fused_window_ref(
        q: torch.Tensor, k_lat: torch.Tensor, k_scale: Optional[torch.Tensor],
        v_q: torch.Tensor, v_scale: torch.Tensor, v_zero: torch.Tensor,
        u: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, q_pos, *,
        n_kv: int, n_recent: int = 0, v_bits: int = 8, v_group: int = 64,
        theta: float = 10_000.0, softcap: float = 0.0, use_rope: bool = True,
        pos_base: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Index-taking verify-window twin: gather-then-attend, as
    :func:`sparse_recon_attention_fused_ref` with q (B, Q, H, dh) — see
    :func:`sparse_recon_attention_window_ref`."""
    idx_c, sel_pos = _selected_positions(idx, k_lat.shape[1], pos_base)
    lat, v = gather_dequant_ref(k_lat, k_scale, v_q, v_scale, v_zero, idx_c,
                                v_bits=v_bits, v_group=v_group)
    return sparse_recon_attention_window_ref(
        q, lat, v, u, sel_pos, valid, q_pos, n_kv=n_kv, n_recent=n_recent,
        theta=theta, softcap=softcap, use_rope=use_rope)


def sparse_recon_attention_window_ref(
        q: torch.Tensor, lat_sel: torch.Tensor, v_sel: torch.Tensor,
        u: torch.Tensor, sel_pos: torch.Tensor, valid: torch.Tensor, q_pos,
        *, n_kv: int, n_recent: int = 0, theta: float = 10_000.0,
        softcap: float = 0.0, use_rope: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verify-window reconstruct → RoPE → partial attention.

    q: (B, Q, H, dh) pre-RoPE queries, query t at position q_pos + t
    (``q_pos`` scalar or (B,), the window base).  One selected set serves
    the whole window.  ``n_recent`` > 0 gates query t to selected positions
    ≤ q_pos + t − n_recent (the positions sequential step q_pos + t could
    select).  Query t IS :func:`sparse_recon_attention_ref` at q_pos + t on
    its gated set, so Q = 1 and the mask advance equal the single-token
    twin bit for bit.  Returns (m (B,Q,H), l (B,Q,H), o (B,Q,H,dh)) f32."""
    base = row_vector(q_pos, q.shape[0], q.device)
    parts = []
    for t in range(q.shape[1]):
        ok = valid
        if n_recent:
            ok = ok & (sel_pos <= (base + t)[:, None] - n_recent)
        parts.append(sparse_recon_attention_ref(
            q[:, t], lat_sel, v_sel, u, sel_pos, ok, base + t, n_kv=n_kv,
            theta=theta, softcap=softcap, use_rope=use_rope))
    return tuple(torch.stack(x, dim=1) for x in zip(*parts))


def sparse_recon_attention_ref(q: torch.Tensor, lat_sel: torch.Tensor,
                               v_sel: torch.Tensor, u: torch.Tensor,
                               sel_pos: torch.Tensor, valid: torch.Tensor,
                               q_pos, *, n_kv: int, theta: float = 10_000.0,
                               softcap: float = 0.0, use_rope: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Reconstruct → RoPE → partial attention (decode, one token).

    q: (B, H, dh) pre-RoPE query; lat_sel: (B, N, r); v_sel: (B, N, kvd);
    u: (kvd, r); sel_pos/valid: (B, N); q_pos: scalar or (B,).
    Returns flash-style partials (m (B,H), l (B,H), o (B,H,dh)), f32."""
    b, h, dh = q.shape
    n = lat_sel.shape[1]
    kvd = u.shape[0]
    group = h // (kvd // dh)
    k_flat = lat_sel.float() @ u.float().T                      # (B,N,kvd)
    k_pre = k_flat.reshape(b, n, n_kv, dh)
    if use_rope:
        k_r = _rope(k_pre, sel_pos.expand(b, n), theta)
        qp = row_vector(q_pos, b, q.device)[:, None]
        q_r = _rope(q[:, None], qp, theta)[:, 0]
    else:
        k_r, q_r = k_pre, q
    kk = torch.repeat_interleave(k_r, group, dim=2)             # (B,N,H,dh)
    logits = torch.einsum("bhd,bnhd->bhn", q_r.float(),
                          kk.float()) * dh ** -0.5
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    m = torch.max(logits, dim=-1).values
    p = torch.where(logits <= NEG_INF / 2, torch.zeros_like(logits),
                    torch.exp(logits - m[..., None]))
    l = torch.sum(p, dim=-1)
    vv = torch.repeat_interleave(v_sel.reshape(b, n, n_kv, dh), group, dim=2)
    o = torch.einsum("bhn,bnhd->bhd", p, vv.float())
    return m, l, o
