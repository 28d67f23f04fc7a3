"""Selected-token decode attention over the raw latent cache (SALS stages
3-4: gather → dequant → reconstruct → RoPE → online softmax) on Hopper.

Replaces ``repro/kernels/sparse_recon_attention.py::
sparse_recon_attention_pallas`` and ``::sparse_recon_attention_paged_pallas``
(TPU), and their speculative verify-window forms
``::sparse_recon_attention_window_pallas`` and
``::sparse_recon_attention_window_paged_pallas``, with the hand-written CUDA
kernel in ``csrc/sparse_recon_attention.cu`` (its ``PAGED`` instance for the
page pool).  The single-token entry points launch the kernel's one-query
window.  The plain PyTorch twins are ``kernels/ref.py::
sparse_recon_attention_fused_ref``, ``::sparse_recon_attention_paged_ref``,
``::sparse_recon_attention_fused_window_ref`` and
``::sparse_recon_attention_window_paged_ref``.

Bound on the H100: operations.  Reconstructing the N_c selected keys is
2·B·N_c·kv_dim·r FLOP — 14.5 GFLOP at the llama2-7b slice shapes (B=4,
N_c=432, kv_dim=4096, r=1024), about 14.7 µs on the bf16 tensor cores —
while the gathered rows plus the resident U_r are about 20 MB (≈ 6 µs).
Design: grid (B, n_kv), one block per row and kv head, so no reduction
crosses blocks and the slot order is fixed (the ascending order
``selection.sort_selected`` gives, invalid slots last — ragged rows stay
deterministic).  Where a block's Q · group (window query, head) rows do
not fit in shared memory (dh 256 with a wide window), they are split over
the fewest blocks whose shares fit (:func:`query_split`, at most
``MAX_SPLIT``), each reconstructing the same keys; a row's arithmetic does
not depend on the split, so neither do the results.  For bf16 and int8 latents the reconstruction runs on the
tensor cores: a producer warpgroup gathers 128 selected latent rows at a
time into 128-byte-swizzled shared memory (cp.async; int8 converted to
bf16 exactly) in 64-column stages of a ring, beside the matching chunk of
U_h by TMA (U_h read once per 128 slots), and two consumer warpgroups each
compute a 64 × dh key tile with wgmma (f32 accumulate), scale int8 rows by
their per-token scale, apply RoPE and score the window's queries in
registers, and update the online softmax once per 128 slots.  f32 latents
(the float32 exactness runs) keep the first version's CUDA-core body: TF32
would round the latents.  So do bf16 / int8 latents beside a u that is not
bf16 (a float32 model with int8 latents): its U_h is read as it is stored.  No gathered, dequantized or reconstructed buffer
reaches device memory.  The paged instance resolves each selected slot's
pool row through the page table once per pass and shares every arithmetic
line with the dense one.  A verify window of Q ≤ 8 queries reconstructs
each selected key once and scores it against all Q · group queries.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import ptr, require
from repro_torch.kernels.ref import row_vector

launches = _build.LaunchCounter("sparse_recon_attention")
paged_launches = _build.LaunchCounter("sparse_recon_attention_paged")
window_launches = _build.LaunchCounter("sparse_recon_attention_window")
window_paged_launches = _build.LaunchCounter(
    "sparse_recon_attention_window_paged")

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_K_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448
MAX_WINDOW = 8
HEAD_DIMS = (64, 128, 256)
MAX_SPLIT = 8     # most blocks one (row, kv head) splits its query rows over
# the tensor-core body (bf16 / int8 latents): slots per pass, latent columns
# per ring stage, deepest ring
_PASS, _KC, _MAX_STAGES = 128, 64, 6
# the CUDA-core body (f32 latents): slots per tile, U columns per chunk
_F32_T, _F32_JT = 32, 32


def _tc_fixed_bytes(dh: int, nq: int, v_bits: int, v_group: int) -> int:
    """Shared memory of the tensor-core body besides its ring (mirrors
    ``sra_tc_layout``): value codes and the (scale, zero) pairs of the
    head's groups for two passes, the RoPE'd queries, the pass's logits,
    the output cells, m / l / alpha, slot metadata of two passes, the
    barriers."""
    vrow = dh if v_bits == 8 else dh // 2
    groups = (dh - 1) // v_group + 2
    vsz = (2 * _PASS * groups * 4 + 15) // 16 * 16
    stats = (3 * nq * 4 + 15) // 16 * 16
    return 2 * _PASS * vrow + vsz + 4 * nq * dh + 4 * nq * _PASS \
        + 4 * nq * dh + stats + 2 * _PASS * 16 + 8 * (2 * _MAX_STAGES + 4)


def _stages(dh: int, nq: int, v_bits: int, v_group: int) -> int:
    """Ring depth of the tensor-core body for nq query rows a block: as
    many 64-column stages (a 128-slot latent tile + a dh x 64 U_h chunk) as
    fit beside the fixed part, at most six (mirrors ``sra_tc_layout``)."""
    stage = _PASS * 128 + dh * 128
    room = _SMEM_LIMIT - 1024 - _tc_fixed_bytes(dh, nq, v_bits, v_group)
    return max(0, min(_MAX_STAGES, room // stage))


def _f32_smem(r: int, dh: int, nq: int) -> int:
    """Shared memory of the CUDA-core body for nq query rows a block
    (mirrors ``sra_f32_smem_bytes``): the f32 latent tile, a U chunk, the
    reconstructed keys and values, the RoPE'd queries, their logits per
    slot and their dh online-softmax cells (m, l, o) each."""
    floats = r * (_F32_T + 4) + dh * (_F32_JT + 1) + 2 * _F32_T * dh \
        + nq * dh + _F32_T * nq + 3 * nq * dh + _F32_T
    return 4 * floats + 12 * _F32_T


def tensor_cores(k_dtype: torch.dtype, u_dtype: torch.dtype) -> bool:
    """Whether a launch takes the tensor-core body: bf16 / int8 latents with
    a bf16 u.  Anything else takes the CUDA-core body."""
    return k_dtype != torch.float32 and u_dtype == torch.bfloat16


def _split(nq: int, fits) -> Tuple[int, int]:
    """(blocks, rows a block) for nq query rows (mirrors
    ``sra_rows_per_block``): all in one block where ``fits(nq)``, else the
    share of the fewest blocks, at most ``MAX_SPLIT``, that fits; (0, nq)
    where none does."""
    for n in range(1, min(MAX_SPLIT, nq) + 1):
        share = -(-nq // n)
        if fits(share):
            return -(-nq // share), share
    return 0, nq


def query_split(r: int, dh: int, group: int, ql: int = 1, *,
                k_dtype: torch.dtype = torch.bfloat16,
                u_dtype: torch.dtype = torch.bfloat16, v_bits: int = 8,
                v_group: int = 64) -> Tuple[int, int]:
    """(blocks, rows a block) over which one (row, kv head)'s ql · group
    query rows are split: a share fits the tensor-core body where it
    leaves two ring stages, the CUDA-core body where its shared memory is
    within the limit."""
    if tensor_cores(k_dtype, u_dtype):
        return _split(ql * group,
                      lambda n: _stages(dh, n, v_bits, v_group) >= 2)
    return _split(ql * group, lambda n: _f32_smem(r, dh, n) <= _SMEM_LIMIT)


def ring_stages(dh: int, group: int, ql: int = 1, v_bits: int = 8,
                v_group: int = 64) -> int:
    """Ring depth of the tensor-core body at its query split: as many
    64-column stages as fit beside a block's fixed part, at most six.  The
    kernel needs two."""
    _, share = _split(ql * group,
                      lambda n: _stages(dh, n, v_bits, v_group) >= 2)
    return _stages(dh, share, v_bits, v_group)


def smem_bytes(r: int, dh: int, group: int, ql: int = 1, *,
               k_dtype: torch.dtype = torch.bfloat16,
               u_dtype: torch.dtype = torch.bfloat16, v_bits: int = 8,
               v_group: int = 64) -> int:
    """Dynamic shared memory one block uses at its query split (mirrors
    the kernel's layout).  Tensor-core body: the 1024-byte alignment slack,
    the ring and the fixed part — independent of r.  CUDA-core body:
    :func:`_f32_smem`."""
    _, share = query_split(r, dh, group, ql, k_dtype=k_dtype,
                           u_dtype=u_dtype, v_bits=v_bits, v_group=v_group)
    if not tensor_cores(k_dtype, u_dtype):
        return _f32_smem(r, dh, share)
    stage = _PASS * 128 + dh * 128
    return 1024 + _stages(dh, share, v_bits, v_group) * stage \
        + _tc_fixed_bytes(dh, share, v_bits, v_group)


_FREQS: Dict[tuple, torch.Tensor] = {}


def rope_inv_freqs(dh: int, theta: float, device) -> torch.Tensor:
    """(dh/2,) f32 inverse frequencies, the twin's formula, made once per
    (dh, theta, device): a decode step asks for them at every SALS layer,
    and making them moves a scalar from the host."""
    key = (dh, float(theta), torch.device(device))
    if key not in _FREQS:
        half = dh // 2
        ar = torch.arange(half, dtype=torch.float32, device=device) / half
        _FREQS[key] = (1.0 / torch.pow(torch.tensor(
            theta, dtype=torch.float32, device=device), ar)).contiguous()
    return _FREQS[key]


def sparse_recon_attention_cuda(
        q: torch.Tensor, k_lat: torch.Tensor, k_scale: Optional[torch.Tensor],
        v_q: torch.Tensor, v_scale: torch.Tensor, v_zero: torch.Tensor,
        u: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, q_pos, *,
        n_kv: int, v_bits: int = 8, v_group: int = 64,
        theta: float = 10_000.0, softcap: float = 0.0, use_rope: bool = True,
        pos_base=None, page_table: Optional[torch.Tensor] = None,
        page_size: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  Shapes as the twin: q (B, H, dh) bf16/f32;
    k_lat (B, S, r); k_scale (B, S) bf16 or None; v_q (B, S, code_w) int8
    (8-bit) or uint8 (packed 4-bit); v_scale/v_zero (B, S, G) bf16;
    u (kv_dim, r) bf16/f32; idx (B, N_c) int32; valid (B, N_c) bool.
    With ``page_table`` (B, max_pages) int32 every cache operand is a page
    pool with (n_pages, page_size) leading axes in place of (B, S), S is
    max_pages · page_size and ``idx`` stays logical.
    Returns f32 partials (m (B, H), l (B, H), o (B, H, dh))."""
    require(q.dim() == 3, "q must be (B, H, dh)")
    m, l, o = _launch(q[:, None], k_lat, k_scale, v_q, v_scale, v_zero, u,
                      idx, valid, q_pos, n_kv=n_kv, n_recent=0,
                      v_bits=v_bits, v_group=v_group, theta=theta,
                      softcap=softcap, use_rope=use_rope, pos_base=pos_base,
                      page_table=page_table, page_size=page_size,
                      window=False)
    return m[:, 0], l[:, 0], o[:, 0]


def sparse_recon_attention_window_cuda(
        q: torch.Tensor, k_lat: torch.Tensor, k_scale: Optional[torch.Tensor],
        v_q: torch.Tensor, v_scale: torch.Tensor, v_zero: torch.Tensor,
        u: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, q_pos, *,
        n_kv: int, n_recent: int = 0, v_bits: int = 8, v_group: int = 64,
        theta: float = 10_000.0, softcap: float = 0.0, use_rope: bool = True,
        pos_base=None, page_table: Optional[torch.Tensor] = None,
        page_size: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the verify-window kernel: as :func:`sparse_recon_attention_cuda`
    but q is (B, Q, H, dh), Q ≤ 8, ``q_pos`` the window base (query t is
    RoPE'd at q_pos + t) and, with ``n_recent`` > 0, query t sees only
    selected positions ≤ q_pos + t − n_recent.  Returns f32 partials
    (m (B, Q, H), l (B, Q, H), o (B, Q, H, dh))."""
    require(q.dim() == 4 and 1 <= q.shape[1] <= MAX_WINDOW,
            f"q must be (B, Q, H, dh) with 1 <= Q <= {MAX_WINDOW}")
    require(n_recent >= 0, "n_recent must be >= 0")
    return _launch(q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid,
                   q_pos, n_kv=n_kv, n_recent=n_recent, v_bits=v_bits,
                   v_group=v_group, theta=theta, softcap=softcap,
                   use_rope=use_rope, pos_base=pos_base,
                   page_table=page_table, page_size=page_size, window=True)


def _launch(q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, q_pos,
            *, n_kv, n_recent, v_bits, v_group, theta, softcap, use_rope,
            pos_base, page_table, page_size, window):
    """Check the operands and launch one of the four C entry points with
    q (B, Q, H, dh); returns (m (B, Q, H), l, o (B, Q, H, dh))."""
    dev = q.device
    tensors = [q, k_lat, v_q, v_scale, v_zero, u, idx, valid]
    if k_scale is not None:
        tensors.append(k_scale)
    paged = page_table is not None
    if paged:
        tensors.append(page_table)
    require(all(t.is_contiguous() for t in tensors),
            "all operands must be contiguous")
    require(q.dtype in _FLOAT_CODES, "q must be bf16/f32")
    b, ql, h, dh = q.shape
    require(dh in HEAD_DIMS, f"head_dim {dh} not in {HEAD_DIMS}")
    require(h % n_kv == 0, "n_heads must be a multiple of n_kv")
    group = h // n_kv
    kvd = n_kv * dh
    require(k_lat.dim() == 3 and k_lat.dtype in _K_DTYPES,
            "k_lat must be (B, S, r) f32/bf16/int8 (paged: (n_pages, "
            "page_size, r))")
    r = k_lat.shape[2]
    if paged:
        require(page_table.dtype == torch.int32 and page_table.dim() == 2
                and page_table.shape[0] == b,
                "page_table must be (B, max_pages) int32")
        require(k_lat.shape[1] == page_size > 0, "k_lat pool pages must "
                "hold page_size rows")
        n_pages, mp = k_lat.shape[0], page_table.shape[1]
        s = mp * page_size
        rows = (n_pages, page_size)
    else:
        require(k_lat.shape[0] == b, "k_lat batch")
        s = k_lat.shape[1]
        rows = (b, s)
    require((k_lat.dtype == torch.int8) == (k_scale is not None),
            "int8 latents need k_scale, others take none")
    if k_scale is not None:
        require(k_scale.shape == rows and k_scale.dtype == torch.bfloat16,
                f"k_scale must be {rows} bf16")
    require(v_bits in (8, 4), "v_bits must be 8 or 4")
    code_w = kvd if v_bits == 8 else kvd // 2
    code_dtype = torch.int8 if v_bits == 8 else torch.uint8
    require(v_q.shape == (*rows, code_w) and v_q.dtype == code_dtype,
            f"v_q must be ({rows}, {code_w}) {code_dtype}")
    g = kvd // v_group
    require(kvd % v_group == 0 and v_scale.shape == (*rows, g)
            and v_zero.shape == (*rows, g)
            and v_scale.dtype == v_zero.dtype == torch.bfloat16,
            "v_scale/v_zero must be (B, S, G) bf16")
    require(u.shape == (kvd, r) and u.dtype in _FLOAT_CODES,
            "u must be (kv_dim, r) bf16/f32")
    require(idx.dim() == 2 and idx.shape[0] == b and idx.dtype == torch.int32
            and valid.shape == idx.shape and valid.dtype == torch.bool,
            "idx (B, N_c) int32 and valid (B, N_c) bool")
    splits, _ = query_split(r, dh, group, ql, k_dtype=k_lat.dtype,
                            u_dtype=u.dtype, v_bits=v_bits, v_group=v_group)
    if not tensor_cores(k_lat.dtype, u.dtype):
        require(splits > 0, f"rank {r}, window {ql}, group {group} need "
                f"more than {_SMEM_LIMIT} B of shared memory a block over "
                f"{MAX_SPLIT} blocks")
    else:
        require(splits > 0, f"window {ql}, group {group}, value group "
                f"{v_group} leave no room for two ring stages in "
                f"{_SMEM_LIMIT} B of shared memory over {MAX_SPLIT} blocks")
        require(r % 8 == 0, f"rank {r} must be a multiple of 8 (16-byte "
                "latent rows)")
        require(all(t.data_ptr() % 16 == 0 for t in (k_lat, v_q, u)),
                "k_lat, v_q and u must start on 16 bytes")
    # last, so that every check above runs (and is tested) on any device
    require(q.is_cuda and all(t.device == dev for t in tensors),
            "tensors must share one CUDA device")
    n_c = idx.shape[1]
    qpos_v = row_vector(q_pos, b, dev)
    base_v = torch.zeros(b, dtype=torch.int32, device=dev) \
        if pos_base is None else row_vector(pos_base, b, dev)
    freqs = rope_inv_freqs(dh, theta, dev)
    m = torch.empty((b, ql, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, ql, h), dtype=torch.float32, device=dev)
    o = torch.empty((b, ql, h, dh), dtype=torch.float32, device=dev)
    lib = _build.library()
    head = (ptr(q), _FLOAT_CODES[q.dtype], ptr(k_lat), _K_DTYPES[k_lat.dtype],
            ptr(k_scale), ptr(v_q), v_bits, ptr(v_scale), ptr(v_zero),
            ptr(u), _FLOAT_CODES[u.dtype], ptr(idx), ptr(valid),
            ptr(qpos_v), ptr(base_v), ptr(freqs))
    outs = (ptr(m), ptr(l), ptr(o))
    pages = (ptr(page_table),) if paged else ()
    tail = (mp, page_size, n_pages) if paged else ()
    if window:
        name = "sparse_recon_attention_window" + ("_paged" if paged else "")
        dims = (b, ql, h, n_kv, dh, s, r, code_w, g, v_group, n_c, n_recent,
                float(softcap), int(use_rope))
        counter = window_paged_launches if paged else window_launches
    else:
        name = "sparse_recon_attention" + ("_paged" if paged else "")
        dims = (b, h, n_kv, dh, s, r, code_w, g, v_group, n_c,
                float(softcap), int(use_rope))
        counter = paged_launches if paged else launches
    err = getattr(lib, "sals_" + name)(*head, *pages, *outs, *dims, *tail,
                                       _build.stream_handle(dev))
    _build.check(err, name)
    counter.add()
    return m, l, o
