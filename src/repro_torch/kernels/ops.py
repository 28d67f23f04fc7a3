"""Public kernel entry points, dispatched by the device of the tensors.

A CUDA tensor launches the hand-written Hopper kernel (``csrc/*.cu``); a CPU
tensor runs the plain PyTorch twin in ``kernels/ref.py``.  There is no
backend switch and no fallback: on CUDA the kernel runs or the call raises.
The signatures are the reference's (``repro/kernels/ops.py``); the paged
layout and prefix-LM masking belong to later slices and raise here.

Models call these; nothing below imports from ``repro_torch.models``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import latent_score as _ls
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_recon_attention as _sra

NEG_INF = _ref.NEG_INF

COUNTERS = (_ls.launches, _sra.launches, _fa.launches)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.reset()


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or twin for device {t.device}")


def _no_pages(page_table) -> None:
    if page_table is not None:
        raise NotImplementedError("the paged latent cache is ported in the "
                                  "serving-substrate slice (slice 2)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    prefix_len: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh); k/v: (B,Sk,Hkv,dh) with Hkv dividing H (the reference
    takes them GQA-expanded, Hkv == H; both are accepted).  The CUDA kernel
    runs at every length."""
    if prefix_len:
        raise NotImplementedError("prefix-LM masking (vlm family) is ported "
                                  "with the vlm family's slice")
    if _on_cuda(q):
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        softcap=softcap)
    return _ref.attention_ref(q, k, v, causal=causal, softcap=softcap)


def latent_topk(q_lat: torch.Tensor, k_lat: torch.Tensor,
                k_scale: Optional[torch.Tensor], pos, *, n_critical: int,
                n_sink: int, n_recent: int,
                pos_base: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                page_size: int = 0):
    """Fused scoring + top-N_c selection over the raw latent cache.
    Returns (idx (B, N_c) int32, valid (B, N_c) bool)."""
    _no_pages(page_table)
    if _on_cuda(q_lat):
        return _ls.latent_topk_cuda(q_lat, k_lat, k_scale, pos,
                                    n_critical=n_critical, n_sink=n_sink,
                                    n_recent=n_recent, pos_base=pos_base)
    return _ref.latent_topk_ref(q_lat, k_lat, k_scale, pos,
                                n_critical=n_critical, n_sink=n_sink,
                                n_recent=n_recent, pos_base=pos_base)


def sparse_recon_attention(q, k_lat, k_scale, v_q, v_scale, v_zero, u,
                           idx, valid, q_pos, *, n_kv: int, v_bits: int = 8,
                           v_group: int = 64, theta: float = 10_000.0,
                           softcap: float = 0.0, use_rope: bool = True,
                           pos_base: Optional[torch.Tensor] = None,
                           page_table: Optional[torch.Tensor] = None,
                           page_size: int = 0):
    """Selected-token decode attention over the raw cache arrays.  Returns
    f32 partials (m (B,H), l (B,H), o (B,H,dh))."""
    _no_pages(page_table)
    fn = _sra.sparse_recon_attention_cuda if _on_cuda(q) \
        else _ref.sparse_recon_attention_fused_ref
    return fn(q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid, q_pos,
              n_kv=n_kv, v_bits=v_bits, v_group=v_group, theta=theta,
              softcap=softcap, use_rope=use_rope, pos_base=pos_base)
