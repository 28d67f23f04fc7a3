"""Latent scoring (SALS §4.3) on Hopper: the top-N_c selection of the decode
path and the plain score matvec of the selection-quality path.

Replaces ``repro/kernels/latent_score.py::latent_topk_pallas``,
``::latent_topk_paged_pallas`` and ``::latent_score_pallas`` (TPU) with the
hand-written CUDA kernels in ``csrc/latent_topk.cu``; the plain PyTorch
twins are ``kernels/ref.py::latent_topk_ref``, ``::latent_topk_paged_ref``
and ``::latent_score_ref``.

Bound on the H100: bytes.  Scoring reads the leading r* columns of every
selectable cached latent row once (B·S·r*·b_lat, plus the int8 scale) — 13
MB at the llama2-7b slice shapes (B=4, S=4160, r*=512, bf16, ragged
positions), about 4 µs at 3.35 TB/s.  One score pass serves all three: each
warp loads the 16-byte chunks of 4 rows into registers before it adds any
(small blocks over every SM, loads in flight on every warp, as a gemv keeps
them), and scores every row through one fixed summation order — so the
plain scores are bit for bit the scores the top-k ranks, and the page pools
(``PAGED``, the same pass with the row address taken from the page table)
select exactly as the dense arena.  The top-k masks unselectable rows (not
read at all) to NEG_INF in a (B, S) f32 scratch, then one 1024-thread block
per row selects its top N_c in the order (value desc, index asc) with an
in-kernel radix select, a compaction in index order and a bitonic sort of
the winners, and writes ``idx`` and ``valid`` itself: a call is two
launches and no torch sort.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LaunchCounter, ptr, require
from repro_torch.kernels.ref import row_vector

# The reference's seq block (``repro/kernels/latent_score.py::
# DEFAULT_BLOCK_S``).  The selection here no longer works in seq blocks; the
# constant states the reference's page-size rule (a page must divide
# min(BLOCK_S, max_seq_len)), which ``serve/engine.py`` enforces so that the
# port refuses what the reference refuses.
BLOCK_S = 1024
# what the kernels take: r* (the f32 query sits in shared memory) and N_c
# (its power of two of (score, index) pairs sorts in shared memory)
MAX_R_STAR = 16384
MAX_CRITICAL = 16384
# the ``parts`` of a top-k call: both kernels on every serving call; one
# alone only to time it.  A graph replay of one launch alone is that half's
# time with its own launch, grid ramp and tail, and with its input read from
# device memory; per-kernel device times of a whole call (CUPTI) leave those
# out, and the selection there reads its scores hot from L2.
TOPK_SCORE, TOPK_SELECT = 1, 2

launches = LaunchCounter("latent_topk")
paged_launches = LaunchCounter("latent_topk_paged")
score_launches = LaunchCounter("latent_score")

_K_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _vec_ok(k_lat: torch.Tensor, r_star: int) -> int:
    """Rows and r* allow 16-byte loads of a row's leading r* columns."""
    size = k_lat.element_size()
    return int(k_lat.data_ptr() % 16 == 0
               and (k_lat.shape[-1] * size) % 16 == 0
               and (r_star * size) % 16 == 0)


def _check_latents(q_lat: torch.Tensor, k_lat: torch.Tensor, layout: str
                   ) -> Tuple[int, int]:
    """The operand checks both wrappers share (device and batch aside).
    Returns (B, r*)."""
    require(q_lat.dtype == torch.float32 and q_lat.dim() == 2
            and q_lat.is_contiguous(), "q_lat must be contiguous (B, r*) f32")
    require(k_lat.dtype in _K_DTYPES and k_lat.dim() == 3
            and k_lat.is_contiguous(), f"k_lat must be contiguous {layout} "
            "f32/bf16/int8")
    b, r_star = q_lat.shape
    require(0 < r_star <= k_lat.shape[2], "r* exceeds the latent rank")
    require(r_star <= MAX_R_STAR, f"r* above {MAX_R_STAR}")
    return b, r_star


def _check_scale(k_scale: Optional[torch.Tensor], rows) -> None:
    if k_scale is not None:
        require(k_scale.dtype == torch.bfloat16 and k_scale.shape == rows
                and k_scale.is_contiguous(),
                f"k_scale must be contiguous {tuple(rows)} bf16")


def _require_device(*tensors) -> torch.device:
    dev = tensors[0].device
    require(dev.type == "cuda" and all(t.device == dev for t in tensors
                                       if t is not None),
            "tensors must share one CUDA device")
    return dev


def latent_score_cuda(q_lat: torch.Tensor, k_lat: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the score pass unmasked.  q_lat: (B, r*) f32; k_lat: (B, S,
    r >= r*) f32 / bf16 / int8; k_scale: (B, S) bf16 per-token scale or
    None.  Returns
    (B, S) f32 scores, equal to :func:`ref.latent_score_ref` up to f32
    summation order and bit for bit the scores :func:`latent_topk_cuda`
    ranks."""
    b, r_star = _check_latents(q_lat, k_lat, "(B, S, r)")
    s, r = k_lat.shape[1], k_lat.shape[2]
    require(k_lat.shape[0] == b, "q_lat/k_lat batch")
    _check_scale(k_scale, (b, s))
    dev = _require_device(q_lat, k_lat, k_scale)
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


def topk_launcher(q_lat: torch.Tensor, k_lat: torch.Tensor,
                  k_scale: Optional[torch.Tensor], pos, *, n_critical: int,
                  n_sink: int, n_recent: int, pos_base=None,
                  page_table: Optional[torch.Tensor] = None,
                  page_size: int = 0
                  ) -> Tuple[Callable[[int], None], torch.Tensor,
                             torch.Tensor, LaunchCounter]:
    """Check a top-k call's operands and allocate its outputs.  Returns
    (launch, idx, valid, counter): ``launch(parts)`` runs the score pass
    (``TOPK_SCORE``) and / or the selection (``TOPK_SELECT``) on the
    current stream; ``counter`` is the launch count of this layout."""
    paged = page_table is not None
    b, r_star = _check_latents(
        q_lat, k_lat, "(n_pages, page_size, r)" if paged else "(B, S, r)")
    if paged:
        require(page_table.dtype == torch.int32 and page_table.dim() == 2
                and page_table.shape[0] == b and page_table.is_contiguous(),
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
    require((k_lat.dtype == torch.int8) == (k_scale is not None),
            "int8 latents need k_scale, others take none")
    _check_scale(k_scale, rows)
    require(0 <= n_critical <= MAX_CRITICAL,
            f"n_critical must be in [0, {MAX_CRITICAL}]")
    dev = _require_device(q_lat, k_lat, k_scale, page_table)
    pos_v = row_vector(pos, b, dev)
    base_v = row_vector(0 if pos_base is None else pos_base, b, dev)
    scores = torch.empty((b, s), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n_critical), dtype=torch.int32, device=dev)
    valid = torch.empty((b, n_critical), dtype=torch.bool, device=dev)
    lib = _build.library()
    vec = _vec_ok(k_lat, r_star)

    def launch(parts: int) -> None:
        # the pointers are taken here, so the closure keeps every tensor
        # the kernels touch alive for as long as it can launch them
        head = (ptr(q_lat), ptr(k_lat), _K_DTYPES[k_lat.dtype], ptr(k_scale),
                ptr(pos_v), ptr(base_v))
        tail = (ptr(scores), ptr(idx), ptr(valid), b, s, k_lat.shape[2],
                r_star, n_critical, n_sink, n_recent, vec, parts)
        stream = _build.stream_handle(dev)
        if paged:
            _build.check(lib.sals_latent_topk_paged(
                *head, ptr(page_table), *tail, mp, page_size, n_pages,
                stream), "latent_topk_paged")
        else:
            _build.check(lib.sals_latent_topk(*head, *tail, stream),
                         "latent_topk")

    return launch, idx, valid, paged_launches if paged else launches


def latent_topk_cuda(q_lat: torch.Tensor, k_lat: torch.Tensor,
                     k_scale: Optional[torch.Tensor], pos, *,
                     n_critical: int, n_sink: int, n_recent: int,
                     pos_base=None, page_table: Optional[torch.Tensor] = None,
                     page_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the score pass and the selection.  q_lat: (B, r*) f32; k_lat:
    (B, S, r) f32 / bf16 / int8 (int8 needs k_scale (B, S) bf16); pos,
    pos_base: scalar or (B,).  With ``page_table`` (B, max_pages) int32,
    k_lat / k_scale are page pools (n_pages, page_size, r) / (n_pages,
    page_size) and S is max_pages · page_size.  Returns (idx (B, N_c) int32,
    valid (B, N_c) bool), equal to :func:`ref.latent_topk_ref` (paged:
    :func:`ref.latent_topk_paged_ref`) including tie-breaks; indices are
    logical."""
    launch, idx, valid, counter = topk_launcher(
        q_lat, k_lat, k_scale, pos, n_critical=n_critical, n_sink=n_sink,
        n_recent=n_recent, pos_base=pos_base, page_table=page_table,
        page_size=page_size)
    launch(TOPK_SCORE | TOPK_SELECT)
    counter.add()
    return idx, valid
