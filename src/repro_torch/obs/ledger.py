"""The port's HBM byte ledger: what its own kernels move per decode step,
per SALS layer and per batch row, term by term (plain Python on ints).

This is the model :class:`~repro_torch.obs.traffic.TrafficAccountant`
reconciles the live arena against.  It counts the same terms as the
reference's ledger (``benchmarks/memory_access.py``: ``decode_stage_bytes``
with ``fused=True``, the payload term of ``tiered_capacity_model`` and the
window term of ``speculative_traffic_model``), derived from the port's
kernels (``kernels/latent_score.py``, ``csrc/latent_topk.cu``,
``csrc/sparse_recon_attention.cu``).  Notation: ``s`` a row's context
length at the step, ``S`` the rows of the score scratch (the dense arena's
``max_seq_len``; paged, ``max_pages · page_size``), ``N_c`` =
``sals.n_critical``, ``nc = min(s, N_c)``, ``b_lat`` the latent width
(1 for int8, else the cache dtype's), ``b_scale`` the int8 per-token scale
(2, bf16; 0 otherwise), ``v_tok`` the stored value record per token (code
``kvd`` or ``kvd/2`` bytes at 4 bits, plus a bf16 scale and zero per
``v_group`` channels), ``b_win`` the cache dtype's width.

score (rows 1, 4: ``latent_score_pass`` + ``topk_select_kernel``)
    ``s·(r*·b_lat + b_scale)`` — the r* stream, counted over every one of
    the ``s`` positions as the reference counts it (the pass does not read
    the rows its mask makes unselectable, the ``n_sink`` oldest and the
    ``n_recent`` newest, so this is an upper bound by that many rows);
    ``+ 8·S`` — the (B, S) f32 score scratch, written once by the pass
    (NEG_INF for unselectable rows) and read once by the selection;
    ``+ 5·N_c`` — the selection's outputs, ``idx`` (N_c) int32 and
    ``valid`` (N_c) bool, written whatever ``s``.
    The reference's score term has ``+ 2·nb·kb·8`` (f32 + int32 candidate
    pairs of its per-block top-k, ``nb = ceil(s / bs)``, ``kb = min(N_c,
    bs)``, ``bs = min(1024, s)``) in place of the last two.  So the port's
    score term minus the reference's is exactly
    ``8·S + 5·N_c − 16·nb·kb``; the stream term is the same.
selected (rows 2, 5: ``sra_kernel`` / ``sra_f32_kernel``)
    ``nc·(r·b_lat + b_scale + v_tok) + nc·8``, as the reference counts it:
    each selected row's latents, scale and value record read once by
    index, plus the index list.  The port's kernel reads ``idx`` int32 and
    ``valid`` bool (5 bytes a slot, not 8) and gathers only valid slots,
    so this too is an upper bound.  The paged kernels resolve a row's page
    through the page table, 4 bytes a page (``4/ps`` a token), which both
    packages read and neither ledger counts.
window
    ``(n_sink + n_recent)·2·kvd·b_win`` — the full-precision sink and
    recent K/V, read once.  The port attends them with plain tensor ops
    (``core/sparse_attention.py``), whose concatenation and f32 upcast
    move more than one read; the ledger counts the one read, as the
    reference's does.
U_r
    ``kvd·r·2`` — the resident bf16 projector (``calibration.U_DTYPE``).
    The recon kernel reads it through L2 once per 128-slot pass per block;
    HBM sees it once.  ``selection.latent_query``'s f32 copy of
    ``u[:, :r*]`` is a torch op outside the kernels, left out as the
    reference leaves out its own.
spec window (rows 6, 7, verify windows only)
    ``q_len·2·kvd·b_win`` — the window's in-flight K/V.
tier transfer
    ``pages·ps·bytes_per_token·n_sals_layers`` — a host mirror holds the
    five per-token payload fields of every SALS layer
    (``serve/engine.py::read_page_payload``).

Every width of the non-int8 latents and of the windows is the cache
dtype's (``cfg.dtype``), which the reference's model fixes at bf16, its
serving dtype; on every bf16 configuration the two ledgers agree on every
term but the score term.
"""
from __future__ import annotations

# bytes per element of the dtypes a cache may use (``cfg.dtype``)
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
SCALE_BYTES = 2       # bf16 per-token / per-group scales (``qz.SCALE_DTYPE``)
U_BYTES = 2           # the stored projector's dtype (``calibration.U_DTYPE``)
SCRATCH_BYTES = 4     # one f32 score in the (B, S) scratch
IDX_VALID_BYTES = 5   # one int32 index + one bool of the selection's output
SELECTED_IDX_BYTES = 8   # per selected slot, as the reference counts it


def cache_width(cfg) -> int:
    """Bytes per element of the cache dtype (windows, non-int8 latents)."""
    return ITEMSIZE[str(cfg.dtype)]


def latent_width(cfg, sals) -> int:
    return 1 if sals.k_latent_dtype == "int8" else cache_width(cfg)


def scale_width(sals) -> int:
    return SCALE_BYTES if sals.k_latent_dtype == "int8" else 0


def value_bytes_per_token(cfg, sals) -> int:
    """The stored value record: codes plus a scale and a zero per group."""
    kvd = cfg.kv_dim
    code_w = kvd // 2 if sals.v_bits == 4 else kvd
    return code_w + 2 * SCALE_BYTES * (kvd // sals.v_group)


def bytes_per_token(cfg, sals) -> int:
    """Stored payload bytes per token and SALS layer: the five per-token
    fields (``core/latent_cache.py::cache_bytes_per_token``)."""
    r = sals.rank(cfg.kv_dim)
    return (r * latent_width(cfg, sals) + scale_width(sals)
            + value_bytes_per_token(cfg, sals))


def score_rows(max_seq_len: int, page_size: int = 0) -> int:
    """Rows S of the score scratch: the dense arena's ``max_seq_len``, or
    the page table's ``max_pages · page_size``."""
    if page_size:
        return (max_seq_len // page_size) * page_size
    return max_seq_len


def n_sals_layers(cfg, sals) -> int:
    return sum(1 for m in sals.sals_layer_mask(cfg.n_layers) if m)


def decode_stage_bytes(cfg, sals, s: int, rows: int) -> dict:
    """HBM bytes of one decode step, per SALS layer, for one row at context
    length ``s`` over a score scratch of ``rows`` (:func:`score_rows`).
    The terms are the module docstring's."""
    kvd = cfg.kv_dim
    r = sals.rank(kvd)
    r_star = sals.score_rank(kvd)
    lat_b, scale_b = latent_width(cfg, sals), scale_width(sals)
    nc = min(s, sals.n_critical)
    stream = s * (r_star * lat_b + scale_b)
    scratch = 2 * SCRATCH_BYTES * rows
    outputs = IDX_VALID_BYTES * sals.n_critical
    score = stream + scratch + outputs
    selected = nc * (r * lat_b + scale_b + value_bytes_per_token(cfg, sals)) \
        + nc * SELECTED_IDX_BYTES
    window = (sals.n_sink + sals.n_recent) * 2 * kvd * cache_width(cfg)
    u_bytes = kvd * r * U_BYTES
    return {"score_bytes": score, "score_stream_bytes": stream,
            "score_scratch_bytes": scratch, "score_output_bytes": outputs,
            "selected_bytes": selected, "window_bytes": window,
            "u_bytes": u_bytes,
            "total_bytes": score + selected + window + u_bytes}


def spec_window_bytes(cfg, q_len: int) -> int:
    """The extra bytes of a verify window of ``q_len`` per row and SALS
    layer: its in-flight K/V."""
    return q_len * 2 * cfg.kv_dim * cache_width(cfg)


def tier_page_bytes(cfg, sals, page_size: int) -> int:
    """Bytes of one page's host mirror: every SALS layer's payload."""
    return page_size * bytes_per_token(cfg, sals) * n_sals_layers(cfg, sals)
