"""Public kernel entry points, dispatched by the device of the tensors.

A CUDA tensor launches the hand-written Hopper kernel (``csrc/*.cu``); a CPU
tensor runs the plain PyTorch twin in ``kernels/ref.py``.  There is no
backend switch and no fallback: on CUDA the kernel runs or the call raises.
The kernels read raw pointers, so a ``DTensor`` never reaches them: each
wrapper raises on one, and sharded callers run the wrappers on local
blocks through ``local_map`` (``models/attention.py``,
``core/sparse_attention.py``).
The signatures are the reference's (``repro/kernels/ops.py``): a
``page_table`` makes the cache operands page pools and selects the paged
kernel (or twin); ``prefix_len`` gives prefix-LM masking.

Models call these; nothing below imports from ``repro_torch.models``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import latent_score as _ls
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_recon_attention as _sra

NEG_INF = _ref.NEG_INF

COUNTERS = (_ls.launches, _sra.launches, _fa.launches,
            _ls.paged_launches, _sra.paged_launches, _sra.window_launches,
            _sra.window_paged_launches, _ls.score_launches,
            _fa.bwd_launches, _fa.dh80_launches, _fa.bwd_dh80_launches)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.reset()


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters.  A CUDA
    graph launches its kernels without entering the wrappers: its capture
    records what the wrappers counted and takes it back (nothing ran), and
    each replay adds it (``serve/step_graph.py``)."""
    for c in COUNTERS:
        c.count += counts.get(c.name, 0)


def _local_only(*ts) -> None:
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("a DTensor reached a kernel wrapper: run the kernel "
                        "on local blocks (local_map)")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or twin for device {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    prefix_len: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh); k/v: (B,Sk,Hkv,dh) with Hkv dividing H (the reference
    takes them GQA-expanded, Hkv == H; both are accepted).  ``prefix_len``
    > 0 gives prefix-LM masking (paligemma): the first ``prefix_len`` keys
    are visible to every query, the rest causally, whatever ``causal``
    says — the reference's Pallas kernel turns its causal mask on for a
    prefix.  The CUDA kernel runs at every length.

    Where autograd records (grad enabled and an input requiring grad) the
    call is :class:`FlashAttentionFn`, whose forward also keeps the LSE
    and whose backward is the flash backward; otherwise it is the plain
    forward, with no LSE written."""
    _local_only(q, k, v)
    causal = causal or prefix_len > 0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, softcap, prefix_len)
    if _on_cuda(q):
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        softcap=softcap,
                                        prefix_len=prefix_len)
    return _ref.attention_ref(q, k, v, causal=causal, softcap=softcap,
                              prefix_len=prefix_len)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient (the counterpart of the reference's
    ``jax.custom_vjp`` ``ops._flash_xla``).  The forward saves (q, k, v, O,
    LSE); the backward recomputes P from LSE and returns (dq, dk, dv), dk
    and dv at the kv heads k and v came with.  CUDA tensors run the two
    kernels, CPU tensors the twins ``attention_lse_ref`` /
    ``attention_bwd_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softcap: float,
                prefix_len: int):
        _local_only(q, k, v)
        mk = dict(causal=causal, softcap=softcap, prefix_len=prefix_len)
        if _on_cuda(q):
            o, lse = _fa.flash_attention_cuda(q, k, v, **mk, return_lse=True)
        else:
            o, lse = _ref.attention_lse_ref(q, k, v, **mk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = mk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if _on_cuda(q):
            dq, dk, dv = _fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      **ctx.mask)
        else:
            dq, dk, dv = _ref.attention_bwd_ref(q, k, v, o, lse, do,
                                                **ctx.mask)
        return dq, dk, dv, None, None, None


def latent_score(q_lat: torch.Tensor, k_lat: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_lat (B, r*), k_lat (B, S, r >= r*) raw latents (+ the int8
    per-token ``k_scale`` (B, S)) -> (B, S) f32 scores over the leading r*
    columns, read in place (no slice, pad or dequantized copy)."""
    _local_only(k_lat, k_scale)
    if _on_cuda(q_lat):
        return _ls.latent_score_cuda(q_lat, k_lat, k_scale)
    return _ref.latent_score_ref(q_lat, k_lat, k_scale)


def latent_topk(q_lat: torch.Tensor, k_lat: torch.Tensor,
                k_scale: Optional[torch.Tensor], pos, *, n_critical: int,
                n_sink: int, n_recent: int,
                pos_base: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                page_size: int = 0):
    """Fused scoring + top-N_c selection over the raw latent cache (paged:
    over page pools walked through ``page_table``; indices stay logical).
    Returns (idx (B, N_c) int32, valid (B, N_c) bool)."""
    kw = dict(n_critical=n_critical, n_sink=n_sink, n_recent=n_recent,
              pos_base=pos_base)
    _local_only(k_lat, k_scale, page_table)
    if _on_cuda(q_lat):
        return _ls.latent_topk_cuda(q_lat, k_lat, k_scale, pos, **kw,
                                    page_table=page_table,
                                    page_size=page_size)
    if page_table is not None:
        return _ref.latent_topk_paged_ref(q_lat, k_lat, k_scale, pos, **kw,
                                          page_table=page_table,
                                          page_size=page_size)
    return _ref.latent_topk_ref(q_lat, k_lat, k_scale, pos, **kw)


def sparse_recon_attention(q, k_lat, k_scale, v_q, v_scale, v_zero, u,
                           idx, valid, q_pos, *, n_kv: int, v_bits: int = 8,
                           v_group: int = 64, theta: float = 10_000.0,
                           softcap: float = 0.0, use_rope: bool = True,
                           pos_base: Optional[torch.Tensor] = None,
                           page_table: Optional[torch.Tensor] = None,
                           page_size: int = 0):
    """Selected-token decode attention over the raw cache arrays (paged:
    page pools resolved through ``page_table``, ``idx`` logical).  Returns
    f32 partials (m (B,H), l (B,H), o (B,H,dh))."""
    args = (q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, q_pos)
    _local_only(*args, page_table)
    kw = dict(n_kv=n_kv, v_bits=v_bits, v_group=v_group, theta=theta,
              softcap=softcap, use_rope=use_rope, pos_base=pos_base)
    if _on_cuda(q):
        return _sra.sparse_recon_attention_cuda(
            *args, **kw, page_table=page_table, page_size=page_size)
    if page_table is not None:
        return _ref.sparse_recon_attention_paged_ref(
            *args, **kw, page_table=page_table, page_size=page_size)
    return _ref.sparse_recon_attention_fused_ref(*args, **kw)


def sparse_recon_attention_window(q, k_lat, k_scale, v_q, v_scale, v_zero,
                                  u, idx, valid, q_pos, *, n_kv: int,
                                  n_recent: int = 0, v_bits: int = 8,
                                  v_group: int = 64, theta: float = 10_000.0,
                                  softcap: float = 0.0, use_rope: bool = True,
                                  pos_base: Optional[torch.Tensor] = None,
                                  page_table: Optional[torch.Tensor] = None,
                                  page_size: int = 0):
    """Verify-window selected-token attention (speculative decode): as
    :func:`sparse_recon_attention` with q (B, Q, H, dh) and ``q_pos`` the
    window base — query t is RoPE'd at q_pos + t and, with ``n_recent`` >
    0, sees only selected positions ≤ q_pos + t − n_recent.  One selected
    set serves the window; each selected token is reconstructed once.
    Returns f32 partials (m (B,Q,H), l (B,Q,H), o (B,Q,H,dh)); Q = 1
    equals :func:`sparse_recon_attention` bit for bit."""
    args = (q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, q_pos)
    _local_only(*args, page_table)
    kw = dict(n_kv=n_kv, n_recent=n_recent, v_bits=v_bits, v_group=v_group,
              theta=theta, softcap=softcap, use_rope=use_rope,
              pos_base=pos_base)
    if _on_cuda(q):
        return _sra.sparse_recon_attention_window_cuda(
            *args, **kw, page_table=page_table, page_size=page_size)
    if page_table is not None:
        return _ref.sparse_recon_attention_window_paged_ref(
            *args, **kw, page_table=page_table, page_size=page_size)
    return _ref.sparse_recon_attention_fused_window_ref(*args, **kw)
