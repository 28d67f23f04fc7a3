"""Selected-token decode attention over the raw latent cache (SALS stages
3-4: gather → dequant → reconstruct → RoPE → online softmax) on Hopper.

Replaces ``repro/kernels/sparse_recon_attention.py::
sparse_recon_attention_pallas`` (TPU) with the hand-written CUDA kernel in
``csrc/sparse_recon_attention.cu``; the plain PyTorch twin is
``kernels/ref.py::sparse_recon_attention_fused_ref``.

Bound on the H100: operations.  Reconstructing the N_c selected keys is
2·B·N_c·kv_dim·r FLOP — 14.5 GFLOP at the llama2-7b slice shapes (B=4,
N_c=432, kv_dim=4096, r=1024), about 14.7 µs on the bf16 tensor cores —
while the gathered rows plus the resident U_r are about 20 MB (≈ 6 µs).
Design: grid (B, n_kv), one block per row and kv head, so no reduction
crosses blocks and the slot order is fixed (the ascending order
``selection.sort_selected`` gives, invalid slots last — ragged rows stay
deterministic).  Selected tokens are reconstructed 32 at a time, with U_r
streamed through shared memory once per tile and the products accumulated
in f32 on the CUDA cores.  No gathered, dequantized or reconstructed buffer
reaches device memory.  The tensor-core (wgmma) tile is the later redesign.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import ptr, require
from repro_torch.kernels.ref import row_vector

launches = _build.LaunchCounter("sparse_recon_attention")

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_K_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448
_THREADS, _T, _JT = 512, 32, 32


def smem_bytes(r: int, dh: int, group: int) -> int:
    """Dynamic shared memory one block uses (mirrors the kernel's layout)."""
    floats = r * (_T + 4) + dh * (_JT + 1) + 2 * _T * dh + group * dh \
        + _T * group + _T
    return 4 * floats + 8 * _T


def rope_inv_freqs(dh: int, theta: float, device) -> torch.Tensor:
    """(dh/2,) f32 inverse frequencies, the twin's formula."""
    half = dh // 2
    ar = torch.arange(half, dtype=torch.float32, device=device) / half
    return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=device), ar)).contiguous()


def sparse_recon_attention_cuda(
        q: torch.Tensor, k_lat: torch.Tensor, k_scale: Optional[torch.Tensor],
        v_q: torch.Tensor, v_scale: torch.Tensor, v_zero: torch.Tensor,
        u: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, q_pos, *,
        n_kv: int, v_bits: int = 8, v_group: int = 64,
        theta: float = 10_000.0, softcap: float = 0.0, use_rope: bool = True,
        pos_base=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  Shapes as the twin: q (B, H, dh) bf16/f32;
    k_lat (B, S, r); k_scale (B, S) bf16 or None; v_q (B, S, code_w) int8
    (8-bit) or uint8 (packed 4-bit); v_scale/v_zero (B, S, G) bf16;
    u (kv_dim, r) bf16/f32; idx (B, N_c) int32; valid (B, N_c) bool.
    Returns f32 partials (m (B, H), l (B, H), o (B, H, dh))."""
    dev = q.device
    tensors = [q, k_lat, v_q, v_scale, v_zero, u, idx, valid]
    if k_scale is not None:
        tensors.append(k_scale)
    require(q.is_cuda and all(t.device == dev for t in tensors),
            "tensors must share one CUDA device")
    require(all(t.is_contiguous() for t in tensors),
            "all operands must be contiguous")
    require(q.dim() == 3 and q.dtype in _FLOAT_CODES, "q must be (B, H, dh) "
            "bf16/f32")
    b, h, dh = q.shape
    require(dh in (64, 128), f"head_dim {dh} not in (64, 128)")
    require(h % n_kv == 0, "n_heads must be a multiple of n_kv")
    group = h // n_kv
    require(group * dh <= 2 * _THREADS, "group·head_dim > 1024")
    kvd = n_kv * dh
    require(k_lat.dim() == 3 and k_lat.shape[0] == b
            and k_lat.dtype in _K_DTYPES, "k_lat must be (B, S, r) "
            "f32/bf16/int8")
    _, s, r = k_lat.shape
    require((k_lat.dtype == torch.int8) == (k_scale is not None),
            "int8 latents need k_scale, others take none")
    if k_scale is not None:
        require(k_scale.shape == (b, s) and k_scale.dtype == torch.bfloat16,
                "k_scale must be (B, S) bf16")
    require(v_bits in (8, 4), "v_bits must be 8 or 4")
    code_w = kvd if v_bits == 8 else kvd // 2
    code_dtype = torch.int8 if v_bits == 8 else torch.uint8
    require(v_q.shape == (b, s, code_w) and v_q.dtype == code_dtype,
            f"v_q must be (B, S, {code_w}) {code_dtype}")
    g = kvd // v_group
    require(kvd % v_group == 0 and v_scale.shape == (b, s, g)
            and v_zero.shape == (b, s, g)
            and v_scale.dtype == v_zero.dtype == torch.bfloat16,
            "v_scale/v_zero must be (B, S, G) bf16")
    require(u.shape == (kvd, r) and u.dtype in _FLOAT_CODES,
            "u must be (kv_dim, r) bf16/f32")
    require(idx.dim() == 2 and idx.shape[0] == b and idx.dtype == torch.int32
            and valid.shape == idx.shape and valid.dtype == torch.bool,
            "idx (B, N_c) int32 and valid (B, N_c) bool")
    smem = smem_bytes(r, dh, group)
    require(smem <= _SMEM_LIMIT, f"rank {r} needs {smem} B of shared memory")
    n_c = idx.shape[1]
    qpos_v = row_vector(q_pos, b, dev)
    base_v = row_vector(0 if pos_base is None else pos_base, b, dev)
    freqs = rope_inv_freqs(dh, theta, dev)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, h), dtype=torch.float32, device=dev)
    o = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.sals_sparse_recon_attention(
        ptr(q), _FLOAT_CODES[q.dtype], ptr(k_lat), _K_DTYPES[k_lat.dtype],
        ptr(k_scale), ptr(v_q), v_bits, ptr(v_scale), ptr(v_zero),
        ptr(u), _FLOAT_CODES[u.dtype], ptr(idx), ptr(valid),
        ptr(qpos_v), ptr(base_v), ptr(freqs), ptr(m), ptr(l), ptr(o),
        b, h, n_kv, dh, s, r, code_w, g, v_group, n_c, float(softcap),
        int(use_rope), _build.stream_handle(dev))
    _build.check(err, "sparse_recon_attention")
    launches.add()
    return m, l, o
