"""Latent scoring (SALS §4.3) on Hopper: the fused score → top-N_c
selection and the plain score matvec.

Replaces ``repro/kernels/latent_score.py::latent_topk_pallas``,
``::latent_topk_paged_pallas`` and ``::latent_score_pallas`` (TPU) with the
hand-written CUDA kernels in ``csrc/latent_topk.cu`` (the top-k kernel's
``PAGED`` instance serves the page pool); the plain PyTorch twins are
``kernels/ref.py::latent_topk_ref``, ``::latent_topk_paged_ref`` and
``::latent_score_ref``.

Bound on the H100: bytes.  Both kernels read the leading r* columns of every
cached latent row once (B·S·r*·b_lat, plus the int8 scale) — 17 MB at the
llama2-7b slice shapes (B=4, S=4160, r*=512, bf16), about 5 µs at 3.35 TB/s.
A warp scores a row with 16-byte coalesced loads and a shuffle reduction
(one device function, ``latent_row_score``, serves both kernels, so the
plain scores are bit for bit the scores the top-k kernel ranks).  Top-k:
grid (B, nb) with one block per 1024-token seq block; the block masks
unselectable rows and bitonic-sorts its scores in shared memory, and only
the top-min(N_c, 1024) candidates per block leave the kernel, so the final
merge (plain torch, as ``lax.top_k`` sits outside the Pallas kernel) sorts
(B, nb·kb) candidates instead of (B, S) scores.  Candidates come out in
(block asc, value desc, id asc) order, so a stable descending sort of them
breaks ties exactly as a full-sequence ``lax.top_k`` does.  The paged
instance differs only in where a row's address comes from (the page
table), so its candidates are bit-identical to the dense kernel's on the
same logical contents.  Plain scores: 64-row blocks of 8 warps over
(B, ⌈S/64⌉), writing (B, S) f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import ptr, require
from repro_torch.kernels.ref import NEG_INF, row_vector, topk_desc_stable

BLOCK_S = 1024      # tokens per thread block (one seq block)
launches = _build.LaunchCounter("latent_topk")
paged_launches = _build.LaunchCounter("latent_topk_paged")
score_launches = _build.LaunchCounter("latent_score")

_K_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def topk_candidate_shape(s: int, n_critical: int) -> Tuple[int, int]:
    """(n_blocks, candidates_per_block) the kernel emits."""
    bs = min(BLOCK_S, s)
    return -(-s // bs), min(n_critical, bs)


def _vec_ok(k_lat: torch.Tensor, r_star: int) -> int:
    """Rows and r* allow the kernels' 16-byte vector loads."""
    size = k_lat.element_size()
    return int(k_lat.data_ptr() % 16 == 0
               and (k_lat.shape[-1] * size) % 16 == 0
               and r_star % (16 // size) == 0)


def latent_score_cuda(q_lat: torch.Tensor, k_lat: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the plain score kernel.  q_lat: (B, r*) f32; k_lat: (B, S,
    r >= r*) f32 / bf16 / int8; k_scale: (B, S) bf16 per-token scale or
    None.  Returns (B, S) f32 scores, equal to :func:`ref.latent_score_ref`
    up to f32 summation order and bit for bit the scores
    :func:`latent_topk_cuda` ranks."""
    dev = q_lat.device
    require(q_lat.is_cuda and k_lat.device == dev, "tensors must share one "
            "CUDA device")
    require(q_lat.dtype == torch.float32 and q_lat.dim() == 2
            and q_lat.is_contiguous(), "q_lat must be contiguous (B, r*) f32")
    require(k_lat.dtype in _K_DTYPES and k_lat.dim() == 3
            and k_lat.is_contiguous(), "k_lat must be contiguous (B, S, r) "
            "f32/bf16/int8")
    b, r_star = q_lat.shape
    _, s, r = k_lat.shape
    require(k_lat.shape[0] == b, "q_lat/k_lat batch")
    require(0 < r_star <= r, "r* exceeds the latent rank")
    if k_scale is not None:
        require(k_scale.dtype == torch.bfloat16 and k_scale.shape == (b, s)
                and k_scale.is_contiguous() and k_scale.device == dev,
                f"k_scale must be contiguous {(b, s)} bf16")
    out = torch.empty((b, s), dtype=torch.float32, device=dev)
    if s == 0:
        return out
    err = _build.library().sals_latent_score(
        ptr(q_lat), ptr(k_lat), _K_DTYPES[k_lat.dtype], ptr(k_scale),
        ptr(out), b, s, r, r_star, _vec_ok(k_lat, r_star),
        _build.stream_handle(dev))
    _build.check(err, "latent_score")
    score_launches.add()
    return out


def latent_topk_cuda(q_lat: torch.Tensor, k_lat: torch.Tensor,
                     k_scale: Optional[torch.Tensor], pos, *,
                     n_critical: int, n_sink: int, n_recent: int,
                     pos_base=None, page_table: Optional[torch.Tensor] = None,
                     page_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  q_lat: (B, r*) f32; k_lat: (B, S, r) f32 /
    bf16 / int8 (int8 needs k_scale (B, S) bf16); pos, pos_base: scalar or
    (B,).  With ``page_table`` (B, max_pages) int32, k_lat / k_scale are
    page pools (n_pages, page_size, r) / (n_pages, page_size) and S is
    max_pages · page_size.  Returns (idx (B, N_c) int32, valid (B, N_c)
    bool), equal to :func:`ref.latent_topk_ref` (paged:
    :func:`ref.latent_topk_paged_ref`) including tie-breaks; indices are
    logical."""
    dev = q_lat.device
    require(q_lat.is_cuda and k_lat.device == dev, "tensors must share one "
            "CUDA device")
    require(q_lat.dtype == torch.float32 and q_lat.dim() == 2
            and q_lat.is_contiguous(), "q_lat must be contiguous (B, r*) f32")
    require(k_lat.dtype in _K_DTYPES and k_lat.dim() == 3
            and k_lat.is_contiguous(), "k_lat must be contiguous (B, S, r) "
            "f32/bf16/int8 (paged: (n_pages, page_size, r))")
    b, r_star = q_lat.shape
    r = k_lat.shape[2]
    paged = page_table is not None
    if paged:
        require(page_table.dtype == torch.int32 and page_table.dim() == 2
                and page_table.shape[0] == b and page_table.is_contiguous()
                and page_table.device == dev,
                "page_table must be contiguous (B, max_pages) int32")
        require(k_lat.shape[1] == page_size > 0, "k_lat pool pages must "
                "hold page_size rows")
        n_pages, mp = k_lat.shape[0], page_table.shape[1]
        s = mp * page_size
        rows = (n_pages, page_size)
    else:
        require(k_lat.shape[0] == b, "q_lat/k_lat batch")
        s = k_lat.shape[1]
        rows = (b, s)
    require(r_star <= r, "r* exceeds the latent rank")
    require((k_lat.dtype == torch.int8) == (k_scale is not None),
            "int8 latents need k_scale, others take none")
    if k_scale is not None:
        require(k_scale.dtype == torch.bfloat16 and k_scale.shape == rows
                and k_scale.is_contiguous() and k_scale.device == dev,
                f"k_scale must be contiguous {rows} bf16")
    pos_v = row_vector(pos, b, dev)
    base_v = row_vector(0 if pos_base is None else pos_base, b, dev)
    bs = min(BLOCK_S, s)
    nb, kb = topk_candidate_shape(s, n_critical)
    cand_v = torch.empty((b, nb, kb), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, nb, kb), dtype=torch.int32, device=dev)
    vec_ok = _vec_ok(k_lat, r_star)
    lib = _build.library()
    if paged:
        err = lib.sals_latent_topk_paged(
            ptr(q_lat), ptr(k_lat), _K_DTYPES[k_lat.dtype], ptr(k_scale),
            ptr(pos_v), ptr(base_v), ptr(page_table), ptr(cand_v),
            ptr(cand_i), b, s, r, r_star, bs, nb, kb, n_sink, n_recent,
            vec_ok, mp, page_size, n_pages, _build.stream_handle(dev))
        _build.check(err, "latent_topk_paged")
        paged_launches.add()
    else:
        err = lib.sals_latent_topk(
            ptr(q_lat), ptr(k_lat), _K_DTYPES[k_lat.dtype], ptr(k_scale),
            ptr(pos_v), ptr(base_v), ptr(cand_v), ptr(cand_i),
            b, s, r, r_star, bs, nb, kb, n_sink, n_recent, vec_ok,
            _build.stream_handle(dev))
        _build.check(err, "latent_topk")
        launches.add()
    return merge_candidates(cand_v.reshape(b, nb * kb),
                            cand_i.reshape(b, nb * kb), n_critical)


def merge_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor,
                     n_critical: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final top-N_c over the per-block candidates (plain torch)."""
    b, n = cand_v.shape
    if n < n_critical:                      # tiny caches: pad
        pad = n_critical - n
        cand_v = torch.cat([cand_v, torch.full((b, pad), NEG_INF,
                                               device=cand_v.device)], 1)
        cand_i = torch.cat([cand_i, torch.zeros((b, pad), dtype=torch.int32,
                                                device=cand_i.device)], 1)
    vals, top = topk_desc_stable(cand_v, n_critical)
    return torch.gather(cand_i, 1, top), vals > NEG_INF / 2
