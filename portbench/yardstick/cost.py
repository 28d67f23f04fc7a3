"""The work of the port's kernels: operations and bytes a call needs.

A frozen copy of the port's ``kernels/cost.py`` work functions, so that a
later change to the program cannot move the yardstick its rooflines are
read against.  Each function takes the kernel's operands (tensors on any
device, ``meta`` included: only shapes and dtypes are read) and returns
``(flops, bytes)``: the operations the call does and the bytes it must
move, each input read once and each output written once.  Where the work
depends on the data, the caller passes the count it knows
(``selectable_rows``, ``valid_rows``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def attended_pairs(sq: int, sk: int, causal: bool, prefix_len: int = 0
                   ) -> int:
    """(query, key) pairs an attention call scores: all of them without a
    mask; causal, query i (at key position sk - sq + i) sees the keys up to
    its own, and at least the first ``prefix_len``."""
    if not causal:
        return sq * sk
    off = sk - sq
    pm = min(sk, prefix_len)
    a = max(0, min(sq, pm - off))
    lo, hi = off + a + 1, off + sq
    return a * pm + (hi + lo) * (hi - lo + 1) // 2


def flash_work(q, k, v, *, causal: bool = True, prefix_len: int = 0
               ) -> Tuple[float, int]:
    """Flash forward: 4·B·H·dh per attended pair (Q Kᵀ and P V); q, k, v
    read and O written."""
    b, sq, h, dh = q.shape
    pairs = attended_pairs(sq, k.shape[1], causal or prefix_len > 0,
                           prefix_len)
    return 4.0 * b * h * dh * pairs, \
        2 * _nbytes(q) + _nbytes(k) + _nbytes(v)


def latent_topk_work(q_lat, k_lat, k_scale, *, n_critical: int,
                     page_table=None, page_size: int = 0,
                     selectable_rows: Optional[int] = None
                     ) -> Tuple[float, int]:
    """Latent scores and the top-N_c: 2·r* per selectable row; the query,
    the selectable rows' leading r* latent columns (and int8 scales), the
    positions and row bases, the (B, N_c) int32 indices and bool validity,
    and the page table.  ``selectable_rows`` defaults to every row."""
    b, r_star = q_lat.shape
    s = page_table.shape[1] * page_size if page_table is not None \
        else k_lat.shape[1]
    n_sel = b * s if selectable_rows is None else selectable_rows
    nbytes = _nbytes(q_lat) + n_sel * r_star * k_lat.element_size() \
        + 2 * b * 4 + b * n_critical * 5 \
        + (n_sel * k_scale.element_size() if k_scale is not None else 0) \
        + _nbytes(page_table)
    return 2.0 * n_sel * r_star, nbytes


def recon_work(q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, *,
               n_kv: int, page_table=None,
               valid_rows: Optional[int] = None) -> Tuple[float, int]:
    """Sparse reconstruction attention (q (B, H, dh), or a verify window
    (B, Q, H, dh)): each valid selected row's key rebuilt through U_r once
    (2·kv_dim·r) and scored and summed by every query (4·Q·H·dh); the
    query, the valid rows' latents, scales, value codes and groups, U_r,
    the indices and validity, the positions, the f32 (m, l, o) partials
    and the page table.  ``valid_rows`` defaults to every selected slot."""
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    ql = q.shape[1] if q.dim() == 4 else 1
    kvd, r, n_c = n_kv * dh, u.shape[1], idx.shape[1]
    nv = b * n_c if valid_rows is None else valid_rows
    row_bytes = r * k_lat.element_size() \
        + (k_scale.element_size() if k_scale is not None else 0) \
        + v_q.shape[-1] * v_q.element_size() \
        + v_scale.shape[-1] * v_scale.element_size() \
        + v_zero.shape[-1] * v_zero.element_size()
    nbytes = _nbytes(q) + nv * row_bytes + _nbytes(u) + b * n_c * 5 \
        + b * 4 + b * ql * h * (2 + dh) * 4 + _nbytes(page_table)
    return 2.0 * nv * kvd * r + 4.0 * nv * ql * h * dh, nbytes
