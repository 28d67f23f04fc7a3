"""Latent KV cache of the SALS layers (port of the dense slot arena of
``repro/core/latent_cache.py``).

Per SALS layer and cached position it stores ``k_lat`` (pre-RoPE keys
projected to the r-dim latent space, bf16 — or int8 + per-token
``k_scale``) and the group-quantized values ``v_q`` / ``v_scale`` /
``v_zero``; plus two small full-precision regions that are always attended:
``sink_k/v`` (the first n_sink tokens) and ``recent_k/v`` (a ring of the
last n_recent tokens, slot = position % n_recent), all pre-RoPE.  The batch
axis is a slot arena with per-slot ``lengths``: :meth:`prefill_into_slot`
splices a prefilled single request into a slot and :meth:`free_slot`
releases one (metadata only).

``page_size`` > 0 is the PAGED layout: the five per-token fields are
physical page pools ``([L,] n_pages, page_size, ·)`` shared by every
sequence, and ``page_table`` ``([L,] B, max_pages)`` int32 maps row b's
logical page j to its physical page (the same page id in every layer's
pool; the host allocator is ``core/pager.py``).  Token t of row b lives at
pool row ``(page_table[b, t // ps], t % ps)``.  The sink/recent windows and
``lengths`` stay per slot.  Unmapped table entries are 0, the trash page:
the kernels mask by per-row position, so its bytes are never selectable.

TWO-TIER paged layout (``hbm_pages`` > 0, ``core/tiering.py``): the five
payload pools shrink to ``hbm_pages + 1`` device SLOTS (slot 0 is the
trash slot) and three fields appear: ``k_score`` ``([L,] n_pages, ps,
r*)``, the leading r* latent columns of EVERY live page (the score kernel
reads it through ``page_table``: the same bytes as the untiered
``k_lat[..., :r*]``, so selection is bit-equal and oblivious to tiering);
``k_scale_score`` ``([L,] n_pages, ps)``, the int8 latents' scale beside
it; and ``hot_table`` ``([L,] B, max_pages)``, row b's logical page j ->
its payload slot (0 = cold or unmapped: the trash slot), which the
reconstruction kernel takes instead of ``page_table``.

``n_groups`` is the decode selection layout, metadata the decode step
reads back (``core/sparse_attention.py::plan_decode``): 1 = the paper's
global top-N_c; G > 1 = a top-⌈N_c/G⌉ in each of G sequence slabs of
``max_seq / G`` positions (paged: ``max_pages / G`` pages of the table),
so ``max_seq`` (paged: the pages per sequence) must divide by G.  The
arrays are the same in both layouts; :meth:`LatentKVCache.group_view` is
the slab view the tests hold the fold to.

Under a sharding context (``distributed/sharding.py``) the fields are
DTensors placed by ``launch.specs.cache_pspecs``: the per-token fields
split along S over the mesh axes of the logical axis ``shard_axis``
("kv_seq"), every field along B over the batch axes.  Each rank then
writes only the rows it owns, at its slab-local position
(:meth:`write_sharded`; a plain global-index write into a sequence-sharded
DTensor would land nowhere).

``ssm`` optionally carries the hybrid family's recurrent state beside the
latents, ``{"ssm": ([L,] B, H, P, N), "conv": ([L,] B, K-1, inner)}`` f32
(with the same leading axes): :meth:`layer_view`, :meth:`set_layer` and
:meth:`prefill_into_slot` take it along.

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
               "recent_k", "recent_v", "k_scale", "lengths", "page_table",
               "k_score", "k_scale_score", "hot_table")
LATENT_FIELDS = _ALL_FIELDS


def check_slabs(max_seq: int, n_groups: int, page_size: int = 0, *,
                name: str = "max_seq",
                table: str = "the page table") -> None:
    """The grouped layout's geometry, the one rule every constructor and
    the engine hold: G slabs of ``max_seq / G`` positions; paged
    (``page_size`` > 0), of ``(max_seq / page_size) / G`` pages each,
    because the fold splits the page table.  The messages are the
    reference's (``name`` and ``table`` as its caller words them)."""
    if n_groups <= 1:
        return
    if page_size:
        mp = max_seq // page_size
        if mp % n_groups:
            raise ValueError(f"pages per sequence {mp} must be divisible "
                             f"by n_groups {n_groups} (the grouped fold "
                             f"splits {table})")
    elif max_seq % n_groups:
        raise ValueError(f"{name} {max_seq} must be divisible by "
                         f"n_groups {n_groups}")


def _row_positions(pos, batch: int, device) -> torch.Tensor:
    """Scalar-or-(B,) decode position -> (B,) int64 index vector."""
    return torch.as_tensor(pos, device=device).to(torch.int64) \
        .reshape(-1).expand(batch)


def _masked_put(arr: torch.Tensor, at: tuple, val: torch.Tensor,
                keep: Optional[torch.Tensor]) -> None:
    """``arr[at] = val`` in place, except batch rows whose ``keep`` (B,) is
    False, which keep their bytes (``val`` is ([L,] B, ·))."""
    val = val.to(arr.dtype)
    if keep is not None:
        rest = val.dim() - (len(at) - 1)
        val = torch.where(keep.reshape(-1, *([1] * rest)), val, arr[at])
    arr[at] = val


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
    page_table: Optional[torch.Tensor] = None  # ([L,] B, max_pages) int32
    page_size: int = 0                     # 0 = dense arena; >0 = pools
    # two-tier layout only (see the module docstring)
    k_score: Optional[torch.Tensor] = None        # ([L,] n_pages, ps, r*)
    k_scale_score: Optional[torch.Tensor] = None  # ([L,] n_pages, ps)
    hot_table: Optional[torch.Tensor] = None      # ([L,] B, max_pages)
    n_groups: int = 1                      # decode selection layout
    ssm: Optional[dict] = None             # hybrid-family recurrent state
    shard_axis: str = "kv_seq"             # logical axis of the S dim

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def tiered(self) -> bool:
        """Two-tier layout: payload pools hold hot slots only."""
        return self.hot_table is not None

    # ------------------------------------------------------------------ init

    @classmethod
    def init(cls, cfg: ModelConfig, sals: SALSConfig, n_layers: int,
             batch: int, max_seq: int, dtype=torch.bfloat16,
             n_groups: int = 1, device="cuda") -> "LatentKVCache":
        """Zero-initialized arena with a leading layer axis."""
        check_slabs(max_seq, n_groups)
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
                   lengths=z((n_layers, batch), torch.int32),
                   n_groups=n_groups)

    @classmethod
    def init_paged(cls, cfg: ModelConfig, sals: SALSConfig, n_layers: int,
                   batch: int, max_seq: int, n_pages: int, page_size: int,
                   dtype=torch.bfloat16, n_groups: int = 1,
                   hbm_pages: int = 0, device="cuda") -> "LatentKVCache":
        """Zero-initialized PAGED cache: the per-token fields are pools of
        ``n_pages`` pages of ``page_size`` tokens; ``max_seq`` only sizes
        the per-row page table (``max_seq // page_size`` entries).
        ``hbm_pages`` > 0 builds the two-tier layout: payload pools of
        ``hbm_pages + 1`` slots (slot 0 = trash), a full-size ``k_score``
        (+ ``k_scale_score``) pool and the ``hot_table``."""
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} must be a multiple of "
                             f"page_size {page_size}")
        if n_pages * page_size < max_seq:
            raise ValueError(f"pool {n_pages}×{page_size} cannot hold one "
                             f"max_seq {max_seq} sequence")
        check_slabs(max_seq, n_groups, page_size)
        if hbm_pages and hbm_pages + 1 > n_pages:
            raise ValueError(f"hbm_pages {hbm_pages} exceeds the pool "
                             f"({n_pages} incl. trash)")
        # (L, 1, ps, ·) template -> (L, n_pages, ps, ·) pools
        one = cls.init(cfg, sals, n_layers, 1, page_size, dtype,
                       device="meta")
        payload_pages = hbm_pages + 1 if hbm_pages else n_pages
        pools = {f: None if getattr(one, f) is None else torch.zeros(
                     (n_layers, payload_pages, *getattr(one, f).shape[2:]),
                     dtype=getattr(one, f).dtype, device=device)
                 for f in _PER_TOKEN_FIELDS}
        win = (n_layers, batch, sals.n_sink, cfg.n_kv_heads, cfg.head_dim)
        ring = (n_layers, batch, sals.n_recent, cfg.n_kv_heads, cfg.head_dim)
        mp = max_seq // page_size

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        if hbm_pages:
            r_star = sals.score_rank(cfg.kv_dim)
            pools["k_score"] = z((n_layers, n_pages, page_size, r_star),
                                 one.k_lat.dtype)
            if one.k_scale is not None:
                pools["k_scale_score"] = z((n_layers, n_pages, page_size),
                                           one.k_scale.dtype)
            pools["hot_table"] = z((n_layers, batch, mp), torch.int32)
        return cls(**pools, sink_k=z(win, dtype), sink_v=z(win, dtype),
                   recent_k=z(ring, dtype), recent_v=z(ring, dtype),
                   lengths=z((n_layers, batch), torch.int32),
                   page_table=z((n_layers, batch, mp), torch.int32),
                   page_size=page_size, n_groups=n_groups)

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
        check_slabs(max_seq, n_groups)
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
                   lengths=len_v, n_groups=n_groups)

    # ----------------------------------------------------------------- views

    def layer_view(self, l: int) -> "LatentKVCache":
        """Layer ``l`` of a stacked cache, as views: writes through it land
        in the arena."""
        return dataclasses.replace(self, **{
            f: (None if getattr(self, f) is None else getattr(self, f)[l])
            for f in _ALL_FIELDS}, ssm=None if self.ssm is None else {
                k: t[l] for k, t in self.ssm.items()})

    def set_layer(self, l: int, layer: "LatentKVCache") -> None:
        """Copy a single-layer cache into layer ``l`` of this stack."""
        for f in _ALL_FIELDS:
            dst = getattr(self, f)
            if dst is not None:
                dst[l].copy_(getattr(layer, f))
        for k, t in (self.ssm or {}).items():
            t[l].copy_(layer.ssm[k])

    def group_view(self) -> "LatentKVCache":
        """The per-token fields as (B, G, S/G, ·) slab views at the
        cache's ``n_groups``: a dense-layout oracle for tests, which the
        decode path never builds (it folds the slabs into the kernel
        batch).  One layer only (take :meth:`layer_view` first)."""
        if self.paged:
            raise ValueError("group_view is a dense-layout oracle; the "
                             "paged grouped fold reshapes the page TABLE, "
                             "not the pools (see sparse_attention)")
        if self.k_lat.dim() != 3:
            raise ValueError("group_view needs a single-layer cache "
                             f"(B, S, r); got k_lat {tuple(self.k_lat.shape)}"
                             " — take layer_view(l) first")
        g = self.n_groups
        out = {}
        for f in _PER_TOKEN_FIELDS:
            a = getattr(self, f)
            if a is not None:
                b, s = a.shape[:2]
                out[f] = a.view(b, g, s // g, *a.shape[2:])
        return dataclasses.replace(self, **out)

    def latent_views(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Raw quantized latent arrays (k_lat (B, S, r), k_scale (B, S) or
        None; paged: the pools) exactly as stored, for the fused decode
        kernels."""
        return self.k_lat, self.k_scale

    def local(self) -> "LatentKVCache":
        """The rank's local blocks of a DTensor cache (views: writes land
        in the DTensors), ``lengths`` left out."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None or f == "lengths" else
            getattr(self, f).to_local() for f in _ALL_FIELDS})

    # ---------------------------------------------------------------- writes

    def write_sharded(self, sals: SALSConfig, pos: torch.Tensor,
                      k_lat: torch.Tensor, v_flat: torch.Tensor,
                      k_pre: torch.Tensor, v: torch.Tensor
                      ) -> "LatentKVCache":
        """:meth:`write` into a single-layer DTensor cache: each rank
        turns the global positions ``pos`` (B,) of its own rows into
        slab-local ones and writes the rows whose position falls in its
        slab (the others keep their bytes); the ring / sink, replicated
        along S, take every row.  ``lengths`` advances on every rank.
        The operands are DTensors split along B as the cache is."""
        from repro_torch.distributed import sharding as shd
        r0, nb = shd.shard_range(self.k_lat, 0)
        s0, ns = shd.shard_range(self.k_lat, 1)
        pos_l = pos[r0:r0 + nb].long()
        inside = (pos_l >= s0) & (pos_l < s0 + ns)
        loc = self.local()
        loc.write_latents(sals, (pos_l - s0).clamp(0, ns - 1),
                          shd.rows_like(k_lat, self.k_lat),
                          shd.rows_like(v_flat, self.k_lat), keep=inside)
        loc.write_ring(sals, pos_l, shd.rows_like(k_pre, self.sink_k),
                       shd.rows_like(v, self.sink_k))
        if self.lengths is not None:
            lens = self.lengths.to_local()
            lens.copy_(torch.maximum(lens, (pos_l + 1).to(lens.dtype)))
        return self

    def write(self, sals: SALSConfig, pos, k_lat: torch.Tensor,
              v_flat: torch.Tensor, k_pre: torch.Tensor, v: torch.Tensor
              ) -> "LatentKVCache":
        """Append one token in place: latent K + quantized V at ``pos``
        (scalar or (B,) per row) and the recent-ring / sink insert.
        k_lat: (B, r); v_flat: (B, kv_dim); k_pre/v: (B, n_kv, dh)."""
        return self.write_latents(sals, pos, k_lat, v_flat) \
                   .write_ring(sals, pos, k_pre, v)

    def write_window(self, sals: SALSConfig, pos, k_lat: torch.Tensor,
                     v_flat: torch.Tensor, k_pre: torch.Tensor,
                     v: torch.Tensor, n_accept) -> "LatentKVCache":
        """Commit the ACCEPTED prefix of a speculative verify window, in
        place.  Works on one layer or on a layer stack (every operand then
        has a leading L axis).  k_lat: ([L,] B, Q, r) pre-RoPE latent keys;
        v_flat: ([L,] B, Q, kv_dim); k_pre/v: ([L,] B, Q, n_kv, dh), the
        window K/V of the read-only windowed attend.  ``pos`` (scalar or
        (B,)) is the window base: slot t lands at pos + t iff t <
        n_accept[b] ((B,) tensor or array, kept on the device: no per-row
        host read).  Rejected and idle rows write nothing and their lengths
        stay, so the committed bytes equal sequentially appending exactly
        the accepted tokens.  Quantized once for the window, written one
        slot at a time (Q <= 8)."""
        lead = len(self._lead())
        b, q = k_lat.shape[lead:lead + 2]
        pos_v = _row_positions(pos, b, k_lat.device)
        n_acc = torch.as_tensor(n_accept, device=k_lat.device) \
            .reshape(-1).expand(b)
        vals = self._quantized(sals, k_lat, v_flat)
        for t in range(q):
            keep = t < n_acc
            self._put_token(pos_v + t, {f: a.select(lead + 1, t)
                                        for f, a in vals.items()}, keep)
            self.write_ring(sals, pos_v + t, k_pre.select(lead + 1, t),
                            v.select(lead + 1, t), keep=keep)
        return self

    def write_latents(self, sals: SALSConfig, pos, k_lat: torch.Tensor,
                      v_flat: torch.Tensor,
                      keep: Optional[torch.Tensor] = None
                      ) -> "LatentKVCache":
        """Latent K + quantized V of one token at ``pos`` (scalar or (B,)).
        Paged: the logical position resolves through the page table to
        (physical page, in-page row); the page must be mapped already (the
        scheduler maps it before the step; an idle row's table row is 0,
        the trash page).  Two-tier: the payload lands in the page's hot
        SLOT (the scheduler pins each row's write page hot) and the
        leading r* columns of the SAME stored rows (int8: the same codes
        and scale) in the score pool at the physical page, so the tiered
        score pass reads exactly the untiered bytes.  ``keep`` (B,) bool
        masks the write per row: a masked row's bytes and length stay as
        they are.  Every write is a set at a fixed position, so running a
        step again over its own writes (the tiered fetch-and-rerun) leaves
        the bytes of one clean run."""
        pos_v = _row_positions(pos, k_lat.shape[-2], k_lat.device)
        return self._put_token(pos_v, self._quantized(sals, k_lat, v_flat),
                               keep)

    def _lead(self) -> tuple:
        """Index prefix of the layer axis: (slice,) on a stack, () on one
        layer's view."""
        return (slice(None),) if self.k_lat.dim() == 4 else ()

    def _quantized(self, sals: SALSConfig, k_lat: torch.Tensor,
                   v_flat: torch.Tensor) -> dict:
        """Stored form of latent keys (..., r) and values (..., kv_dim):
        {field: tensor} for the per-token fields."""
        out = {}
        if sals.k_latent_dtype == "int8":
            out["k_lat"], out["k_scale"] = qz.quantize_latent_int8(k_lat)
        else:
            out["k_lat"] = k_lat.to(self.k_lat.dtype)
        vq = qz.quantize(v_flat, sals.v_bits, sals.v_group)
        out["v_q"], out["v_scale"], out["v_zero"] = \
            vq["q"], vq["scale"], vq["zero"]
        return out

    def _put_token(self, pos_v: torch.Tensor, vals: dict,
                   keep: Optional[torch.Tensor]) -> "LatentKVCache":
        """Write one token's stored fields ([L,] B, ·) at (B,) positions,
        rows with ``keep`` False left as they are; advance ``lengths``."""
        b = pos_v.shape[0]
        dev = pos_v.device
        rows = torch.arange(b, device=dev)
        lead = self._lead()
        if self.paged:
            ps = self.page_size
            table = self.page_table[0] if lead else self.page_table
            page = (pos_v // ps).clamp_max(table.shape[-1] - 1)
            at = lead + (table[rows, page].long(), pos_v % ps)
            if self.tiered:
                hot = self.hot_table[0] if lead else self.hot_table
                score_at, at = at, lead + (hot[rows, page].long(),
                                           pos_v % ps)
                r_star = self.k_score.shape[-1]
                _masked_put(self.k_score, score_at,
                            vals["k_lat"][..., :r_star], keep)
                if self.k_scale_score is not None:
                    _masked_put(self.k_scale_score, score_at,
                                vals["k_scale"], keep)
        else:
            at = lead + (rows, pos_v.clamp_max(self.k_lat.shape[-2] - 1))
        for f, val in vals.items():
            _masked_put(getattr(self, f), at, val, keep)
        if self.lengths is not None:
            adv = (pos_v + 1).to(torch.int32)
            if keep is not None:
                adv = torch.where(keep, adv, torch.zeros_like(adv))
            self.lengths.copy_(torch.maximum(self.lengths, adv))
        return self

    def append_chunk(self, cfg: ModelConfig, sals: SALSConfig,
                     u: torch.Tensor, off, k_pre: torch.Tensor,
                     v: torch.Tensor, lengths: torch.Tensor
                     ) -> "LatentKVCache":
        """Append one CHUNK of prompt tokens at positions [off, off+C), in
        place (single-layer dense view; the chunked-prefill write path).

        ``off``: a 0-d integer tensor on the cache's device (a Python int
        from a direct caller), never read on the host.  k_pre/v: (B, C,
        n_kv, dh) pre-RoPE keys / values; ``lengths`` (B,) each row's true
        prompt length.  Latent-K + quantized-V writes cover
        every chunk position, pads included (per-slot lengths keep pads
        unselectable); ring/sink inserts are masked to each row's real
        positions, so a pad never evicts a real token from the ring.
        Per-slot ``lengths`` advance to min(lengths, off+C).  A DTensor
        cache takes :meth:`_append_chunk_sharded`."""
        if self.paged:
            raise ValueError("append_chunk writes a DENSE single-request "
                             "prefill cache; paged admission scatters its "
                             "pages afterwards (ServeEngine.admit_paged)")
        from repro_torch.distributed import sharding as shd
        if shd.is_dtensor(self.k_lat):
            return self._append_chunk_sharded(cfg, sals, u, off, k_pre, v,
                                              lengths)
        b, c = k_pre.shape[:2]
        dev = k_pre.device
        len_v = torch.as_tensor(lengths, device=dev).to(torch.int64) \
            .reshape(-1).expand(b)
        off = torch.as_tensor(off, device=dev)
        span = off + torch.arange(c, device=dev)
        for f, val in self._chunk_codes(cfg, sals, u, k_pre, v).items():
            getattr(self, f).index_copy_(1, span, val)
        return self._chunk_ring_sink(sals, off, k_pre, v, len_v)

    def _chunk_codes(self, cfg: ModelConfig, sals: SALSConfig,
                     u: torch.Tensor, k_pre: torch.Tensor,
                     v: torch.Tensor) -> dict:
        """The stored per-token fields of a chunk's (B, C, n_kv, dh) keys
        and values, each in its field's dtype."""
        b, c = k_pre.shape[:2]
        vals = self._quantized(
            sals, to_latent(u.float(), k_pre.reshape(b, c, cfg.kv_dim)),
            v.reshape(b, c, cfg.kv_dim))
        return {f: val.to(getattr(self, f).dtype) for f, val in vals.items()}

    def _chunk_ring_sink(self, sals: SALSConfig, off: torch.Tensor,
                         k_pre: torch.Tensor, v: torch.Tensor,
                         len_v: torch.Tensor) -> "LatentKVCache":
        """The chunk's ring / sink inserts and the lengths' advance (see
        :meth:`append_chunk`)."""
        b, c = k_pre.shape[:2]
        dev = k_pre.device
        end = off + c
        # ragged ring: slot j takes the LAST real chunk position p ≡ j
        # (mod w); p outside [off, min(len, off+C)) leaves the slot alone
        w = sals.n_recent
        bi = torch.arange(b, device=dev)[:, None]
        last = torch.minimum(len_v, end)[:, None] - 1
        p = last - torch.remainder(last - torch.arange(w, device=dev), w)
        keep = ((p >= off) & (len_v[:, None] > off))[..., None, None]
        pc = (p - off).clamp(0, c - 1)
        for arr, val in ((self.recent_k, k_pre), (self.recent_v, v)):
            arr.copy_(torch.where(keep, val[bi, pc].to(arr.dtype), arr))

        # ragged sink: positions [off, off+C) ∩ [0, n_sink) ∩ [0, len)
        sidx = torch.arange(sals.n_sink, device=dev)[None, :]
        keep_s = ((sidx >= off) & (sidx < end)
                  & (sidx < len_v[:, None]))[..., None, None]
        spc = (sidx - off).clamp(0, c - 1).expand(b, -1)
        for arr, val in ((self.sink_k, k_pre), (self.sink_v, v)):
            arr.copy_(torch.where(keep_s, val[bi, spc].to(arr.dtype), arr))
        self.lengths.copy_(torch.minimum(len_v, end).to(self.lengths.dtype))
        return self

    def _append_chunk_sharded(self, cfg: ModelConfig, sals: SALSConfig,
                              u: torch.Tensor, off, k_pre: torch.Tensor,
                              v: torch.Tensor, lengths: torch.Tensor
                              ) -> "LatentKVCache":
        """:meth:`append_chunk` into a single-layer DTensor cache: each
        rank takes its rows of the chunk (plain or DTensor operands, whole
        along C), writes the chunk positions inside its slab at slab-local
        rows (``off`` read on the host: the sharded path runs eagerly) and
        makes the ring / sink / lengths updates, replicated along S, on
        its rows."""
        from repro_torch.distributed import sharding as shd
        r0, nb = shd.shard_range(self.k_lat, 0)
        s0, ns = shd.shard_range(self.k_lat, 1)
        off_i = int(off)

        def rows(t):
            return shd.rows_like(t, self.k_lat) if shd.is_dtensor(t) \
                else t[r0:r0 + nb]

        k_l, v_l = rows(k_pre), rows(v)
        dev = k_l.device
        len_v = torch.as_tensor(lengths, device=dev).to(torch.int64) \
            .reshape(-1).expand(k_pre.shape[0])[r0:r0 + nb]
        loc = self.local()
        lo, hi = max(off_i, s0), min(off_i + k_pre.shape[1], s0 + ns)
        if lo < hi:          # the chunk's positions inside this slab
            sl = slice(lo - off_i, hi - off_i)
            codes = loc._chunk_codes(cfg, sals,
                                     u.to_local() if shd.is_dtensor(u)
                                     else u, k_l[:, sl], v_l[:, sl])
            for f, val in codes.items():
                getattr(loc, f)[:, lo - s0:hi - s0].copy_(val)
        loc.lengths = self.lengths.to_local()
        loc._chunk_ring_sink(sals, torch.as_tensor(off_i, device=dev), k_l,
                             v_l, len_v)
        return self

    def write_ring(self, sals: SALSConfig, pos, k_pre: torch.Tensor,
                   v: torch.Tensor, keep: Optional[torch.Tensor] = None
                   ) -> "LatentKVCache":
        """Insert one token into the recent ring, and into the sink while
        pos < n_sink.  k_pre/v: ([L,] B, n_kv, dh); ``keep`` (B,) bool
        masks the insert per row."""
        b = k_pre.shape[-3]
        pos_v = _row_positions(pos, b, k_pre.device)
        rows = torch.arange(b, device=k_pre.device)
        lead = self._lead()
        slot = torch.remainder(pos_v, sals.n_recent)
        _masked_put(self.recent_k, lead + (rows, slot), k_pre, keep)
        _masked_put(self.recent_v, lead + (rows, slot), v, keep)
        # rows past the sink rewrite sink slot 0 with its own value (no
        # host sync on a data-dependent branch)
        in_sink = pos_v < sals.n_sink
        if keep is not None:
            in_sink = in_sink & keep
        sink_at = lead + (rows, torch.where(in_sink, pos_v,
                                            torch.zeros_like(pos_v)))
        _masked_put(self.sink_k, sink_at, k_pre, in_sink)
        _masked_put(self.sink_v, sink_at, v, in_sink)
        return self

    # ------------------------------------------------------------ slot arena

    def prefill_into_slot(self, slot: int, other: "LatentKVCache"
                          ) -> "LatentKVCache":
        """Copy ``other``'s (batch 1) arrays into batch row ``slot``, in
        place (dense arena; the paged arena admits through the page
        scatter, ``ServeEngine.admit_paged``)."""
        if self.paged:
            raise ValueError("paged caches admit through the page-scatter "
                             "path (ServeEngine.admit_paged), not slot "
                             "row splices")
        ax = 1 if self.k_lat.dim() == 4 else 0
        for f in _ALL_FIELDS:
            dst = getattr(self, f)
            if dst is not None:
                dst.select(ax, slot).copy_(getattr(other, f).select(ax, 0))
        for k, t in (self.ssm or {}).items():
            t.select(ax, slot).copy_(other.ssm[k].select(ax, 0))
        return self

    def free_slot(self, slot: int) -> "LatentKVCache":
        """Release batch row ``slot`` — METADATA ONLY: its length (and,
        paged, its page-table and hot-table rows) is reset; the payload
        bytes stay.
        Per-row positions gate every read and the next admission rewrites
        the row's windows and per-token data, so recycled bytes are never
        selectable."""
        ax = 1 if self.k_lat.dim() == 4 else 0
        self.lengths.select(ax, slot).zero_()
        for table in (self.page_table, self.hot_table):
            if table is not None:
                table.select(ax, slot).zero_()
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
