"""The work of each kernel wrapper of ``kernels/ops.py``, and the counters
the wrappers report it to.

Each ``*_work`` function takes a wrapper's arguments (tensors on any
device, meta included) and returns ``(flops, bytes)``: the operations the
function does on them, and the bytes it must move, each input read once
and each output written once.  ``chip_smoke.py`` divides the same numbers
by the card's rates for a kernel's ``bound_ms``; ``analysis/hlo_cost.py``
adds them to a step's count.

Where the work depends on the data (the selectable rows a top-k scores,
the valid rows a recon gathers), the caller that knows it passes the
count (``selectable_rows=``, ``valid_rows=``); without it the functions
count every row.  A wrapper always records that form: the counts live on
the device, and reading them would synchronize a step (and break its CUDA
graph's capture).

:func:`counting` pushes a :class:`Counter` on this thread's stack;
:func:`launch` (around a wrapper's body) adds the wrapper's work to the
innermost one and marks the body's own tensor ops as the kernel's, so an
op counter (``hlo_cost.analyze_step``) does not count a twin's ops again.
With no counter active, ``launch`` calls no work function and marks
nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import torch

_state = threading.local()


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def attended_pairs(sq: int, sk: int, causal: bool, prefix_len: int = 0
                   ) -> int:
    """(query, key) pairs a flash call scores: every one without a mask;
    causal, query i (at key position sk - sq + i) sees keys up to its own,
    and at least the first ``prefix_len`` (prefix-LM)."""
    if not causal:
        return sq * sk
    off = sk - sq
    pm = min(sk, prefix_len)
    # rows whose causal reach is within the prefix see pm keys; the rest
    # off + i + 1 (the reach stops at sk on the last row)
    a = max(0, min(sq, pm - off))
    lo, hi = off + a + 1, off + sq
    return a * pm + (hi + lo) * (hi - lo + 1) // 2


def flash_work(q, k, v, *, causal: bool = True, prefix_len: int = 0,
               lse: bool = False) -> Tuple[float, int]:
    """Flash forward: 4·B·H·dh per attended pair (Q Kᵀ and P V); q, k, v
    read, O written (and the (B, H, Sq) f32 LSE with ``lse``)."""
    b, sq, h, dh = q.shape
    pairs = attended_pairs(sq, k.shape[1], causal or prefix_len > 0,
                           prefix_len)
    nbytes = 2 * _nbytes(q) + _nbytes(k) + _nbytes(v) \
        + (4 * b * h * sq if lse else 0)
    return 4.0 * b * h * dh * pairs, nbytes


def flash_bwd_work(q, k, v, o, lse, do, *, causal: bool = True,
                   prefix_len: int = 0) -> Tuple[float, int]:
    """Flash backward: 10·B·H·dh per attended pair (S and dP recomputed,
    dV, dQ, dK); q, O, dO read and dQ written, k, v read and dK, dV
    written, the LSE read."""
    b, sq, h, dh = q.shape
    pairs = attended_pairs(sq, k.shape[1], causal or prefix_len > 0,
                           prefix_len)
    nbytes = 4 * _nbytes(q) + 2 * _nbytes(k) + 2 * _nbytes(v) + _nbytes(lse)
    return 10.0 * b * h * dh * pairs, nbytes


def latent_score_work(q_lat, k_lat, k_scale=None) -> Tuple[float, int]:
    """Plain scores: 2·r* per (row, position); the query, every position's
    leading r* latent columns (and int8 scales) read, (B, S) f32 written."""
    b, r_star = q_lat.shape
    s = k_lat.shape[1]
    nbytes = _nbytes(q_lat) + b * s * r_star * k_lat.element_size() \
        + b * s * 4 + _nbytes(k_scale)
    return 2.0 * b * s * r_star, nbytes


def latent_topk_work(q_lat, k_lat, k_scale, pos, *, n_critical: int,
                     page_table=None, page_size: int = 0,
                     selectable_rows: Optional[int] = None, **_
                     ) -> Tuple[float, int]:
    """Scores and top-N_c: 2·r* per selectable row; the query, the
    selectable rows' leading r* columns (and scales), positions and row
    bases, the (B, N_c) int32 indices and bool validity, and the page
    table.  ``selectable_rows`` defaults to every logical row."""
    b, r_star = q_lat.shape
    s = page_table.shape[1] * page_size if page_table is not None \
        else k_lat.shape[1]
    n_sel = b * s if selectable_rows is None else selectable_rows
    nbytes = _nbytes(q_lat) + n_sel * r_star * k_lat.element_size() \
        + 2 * b * 4 + b * n_critical * 5 \
        + (n_sel * k_scale.element_size() if k_scale is not None else 0) \
        + _nbytes(page_table)
    return 2.0 * n_sel * r_star, nbytes


def recon_work(q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid,
               q_pos, *, n_kv: int, page_table=None,
               valid_rows: Optional[int] = None, **_) -> Tuple[float, int]:
    """Sparse reconstruction attention (q (B, H, dh), or a verify window
    (B, Q, H, dh)): each valid selected row's key rebuilt through U_r once
    (2·kv_dim·r) and scored and summed by every query (4·Q·H·dh); the
    query, the valid rows' latents, scales and value codes and groups,
    U_r, indices and validity, positions, the f32 (m, l, o) partials and
    the page table.  ``valid_rows`` defaults to every selected slot."""
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


class Counter:
    """Work the wrappers recorded while this counter was innermost:
    totals and, per kernel, [calls, flops, bytes]."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.by_kernel: Dict[str, List[float]] = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_kernel.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


def _stack() -> List[Counter]:
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = []
    return st


@contextlib.contextmanager
def counting(counter: Optional[Counter] = None):
    """Push ``counter`` (a new one by default) on this thread's stack for
    the body; yields it."""
    c = Counter() if counter is None else counter
    st = _stack()
    st.append(c)
    try:
        yield c
    finally:
        st.pop()


def record(name: str, flops: float, nbytes: float) -> None:
    """Add one call's work to the innermost counter; nothing when none is
    active."""
    st = _stack()
    if st:
        st[-1].add(name, flops, nbytes)


def in_kernel() -> bool:
    """True inside a wrapper's body (:func:`launch`) while a counter is
    active: the tensor ops there are the kernel's, already recorded."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def launch(name: str, work, *args, **kw):
    """Around a kernel wrapper's body: records ``work(*args, **kw)`` under
    ``name`` with the innermost counter and marks the body's tensor ops
    as the kernel's (:func:`in_kernel`).  With no counter active it does
    neither, and ``work`` is not called."""
    if not _stack():
        yield
        return
    record(name, *work(*args, **kw))
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1
