"""Fused latent scoring + top-N_c selection (SALS §4.3) on Hopper.

Replaces ``repro/kernels/latent_score.py::latent_topk_pallas`` (TPU) with
the hand-written CUDA kernel in ``csrc/latent_topk.cu``; the plain PyTorch
twin is ``kernels/ref.py::latent_topk_ref``.

Bound on the H100: bytes.  The kernel reads the leading r* columns of every
cached latent row once (B·S·r*·b_lat, plus the int8 scale) — 17 MB at the
llama2-7b slice shapes (B=4, S=4160, r*=512, bf16), about 5 µs at 3.35 TB/s.
Design: grid (B, nb) with one block per 1024-token seq block; a warp scores
a row with 16-byte coalesced loads and a shuffle reduction, the block masks
unselectable rows and bitonic-sorts its scores in shared memory, and only
the top-min(N_c, 1024) candidates per block leave the kernel, so the final
merge (plain torch, as ``lax.top_k`` sits outside the Pallas kernel) sorts
(B, nb·kb) candidates instead of (B, S) scores.  Candidates come out in
(block asc, value desc, id asc) order, so a stable descending sort of them
breaks ties exactly as a full-sequence ``lax.top_k`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import ptr, require
from repro_torch.kernels.ref import NEG_INF, row_vector, topk_desc_stable

BLOCK_S = 1024      # tokens per thread block (one seq block)
launches = _build.LaunchCounter("latent_topk")

_K_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def topk_candidate_shape(s: int, n_critical: int) -> Tuple[int, int]:
    """(n_blocks, candidates_per_block) the kernel emits."""
    bs = min(BLOCK_S, s)
    return -(-s // bs), min(n_critical, bs)


def latent_topk_cuda(q_lat: torch.Tensor, k_lat: torch.Tensor,
                     k_scale: Optional[torch.Tensor], pos, *,
                     n_critical: int, n_sink: int, n_recent: int,
                     pos_base=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  q_lat: (B, r*) f32; k_lat: (B, S, r) f32 /
    bf16 / int8 (int8 needs k_scale (B, S) bf16); pos, pos_base: scalar or
    (B,).  Returns (idx (B, N_c) int32, valid (B, N_c) bool), equal to
    :func:`ref.latent_topk_ref` including tie-breaks."""
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
    require(k_lat.shape[0] == b and r_star <= r, "q_lat/k_lat shapes")
    require((k_lat.dtype == torch.int8) == (k_scale is not None),
            "int8 latents need k_scale, others take none")
    if k_scale is not None:
        require(k_scale.dtype == torch.bfloat16 and k_scale.shape == (b, s)
                and k_scale.is_contiguous() and k_scale.device == dev,
                "k_scale must be contiguous (B, S) bf16")
    pos_v = row_vector(pos, b, dev)
    base_v = row_vector(0 if pos_base is None else pos_base, b, dev)
    bs = min(BLOCK_S, s)
    nb, kb = topk_candidate_shape(s, n_critical)
    cand_v = torch.empty((b, nb, kb), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, nb, kb), dtype=torch.int32, device=dev)
    size = k_lat.element_size()
    epv = 16 // size
    vec_ok = int(k_lat.data_ptr() % 16 == 0 and (r * size) % 16 == 0
                 and r_star % epv == 0)
    lib = _build.library()
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
