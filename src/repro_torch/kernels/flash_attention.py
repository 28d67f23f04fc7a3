"""Flash attention on Hopper: the forward (prefill and the training
forward) and, for training, its backward.

The forward replaces ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (TPU) with the hand-written CUDA kernel in
``csrc/flash_attention.cu``; the plain PyTorch twin is
``kernels/ref.py::attention_ref`` (``attention_lse_ref`` with the LSE).
The backward replaces the reference's custom VJP
``repro/kernels/ops.py::_flash_bwd_rule`` with ``csrc/flash_attention_bwd.cu``
(its twin ``kernels/ref.py::attention_bwd_ref``; design and bound in the
source).  ``kernels/ops.py::FlashAttentionFn`` joins the two.

Bound on the H100: operations.  4·B·H·Sq·Sk·dh FLOP, halved by causality —
at the llama2-7b slice shapes (B=4, S=4096, H=32, dh=128) 550 GFLOP per
layer after the causal skip, about 0.56 ms on the bf16 tensor cores.
Design (warp-specialised TMA + wgmma): grid (B·H, ⌈Sq/128⌉), the query
tiles launched longest rows first; a producer warpgroup loads the 128-row
Q tile once and streams BN-key K/V tiles (BN 128 at dh 64 and 128, 64 at
dh 256, so that two stages fit beside the 64 KB Q tile) by TMA through a
two-stage ring under mbarriers (4-D tensor maps over (dh, heads, S, B),
128-byte swizzle), never loading a tile wholly above the causal diagonal
(q_off = Sk − Sq) and outside the prefix; two consumer warpgroups of 64
rows run S = QKᵀ and O += PV as wgmma chains (P from registers, rounded to
bf16), with the softcap, mask and online softmax in f32 on the accumulator
registers and O, the row max and sum in registers for the whole KV loop.
K/V are read at kv head h // group, so GQA needs no expanded copy.
Prefix-LM (``prefix_len`` > 0, with ``causal``): keys below ``prefix_len``
are visible to every query, the rest causally — the Pallas kernel's mask
``(qp >= kp) | (kp < prefix_len)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import ptr, require

launches = _build.LaunchCounter("flash_attention")
bwd_launches = _build.LaunchCounter("flash_attention_bwd")

HEAD_DIMS = (64, 128, 256)


def block_keys(dh: int) -> int:
    """Keys per K/V tile (mirrors ``fa_bn`` in the kernel)."""
    return 64 if dh > 128 else 128


def smem_bytes(dh: int) -> int:
    """Dynamic shared memory of one block (mirrors ``FaSmem``): the
    1024-byte alignment slack, the 128-row Q tile, two stages of K and V
    tiles and the barriers."""
    return 1024 + 128 * dh * 2 + 2 * 2 * block_keys(dh) * dh * 2 + 8 * 9


def _check_operands(q, k, v, causal: bool, prefix_len: int) -> None:
    """What both kernels refuse, checked before the device."""
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.dim() == 4
                for t in (q, k, v)), "q/k/v must be contiguous 4-D bf16")
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == dh,
            "k/v shapes")
    require(h % hkv == 0, "n_heads must be a multiple of the kv heads")
    require(dh in HEAD_DIMS, f"head_dim {dh} not in {HEAD_DIMS}")
    require(not causal or sq <= sk, "causal attention needs Sq <= Sk")
    require(prefix_len >= 0 and (causal or not prefix_len),
            "prefix-LM masking (prefix_len > 0) needs causal")
    require(sq >= 1 and sk >= 1, "empty sequence")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "q/k/v must start on 16 bytes (TMA)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, softcap: float = 0.0,
                         prefix_len: int = 0, return_lse: bool = False):
    """q: (B, Sq, H, dh) bf16; k/v: (B, Sk, Hkv, dh) bf16 with Hkv | H.
    ``prefix_len`` > 0 (prefix-LM) needs ``causal``.  Returns (B, Sq, H,
    dh) bf16, and with ``return_lse`` also the rows' log-sum-exp (B, H,
    Sq) f32 (natural log), which the backward takes."""
    _check_operands(q, k, v, causal, prefix_len)
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    require(q.is_cuda and k.device == dev and v.device == dev,
            "tensors must share one CUDA device")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) \
        if return_lse else None
    lib = _build.library()
    err = lib.sals_flash_attention(ptr(q), ptr(k), ptr(v), ptr(out),
                                   ptr(lse), b, sq, sk, h, hkv, dh,
                                   int(causal), int(prefix_len),
                                   float(softcap), _build.stream_handle(dev))
    _build.check(err, "flash_attention")
    launches.add()
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, softcap: float = 0.0,
                             prefix_len: int = 0):
    """The backward of :func:`flash_attention_cuda`: q, o, do (B, Sq, H, dh)
    and k / v (B, Sk, Hkv, dh) bf16, ``lse`` (B, H, Sq) f32 from the
    forward.  Returns (dq, dk, dv) bf16 in the shapes of q, k, v (GQA: each
    group's heads summed into its kv head).  Three kernels on the current
    stream (the D pass, dK/dV, dQ), counted as one launch."""
    _check_operands(q, k, v, causal, prefix_len)
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous()
                and t.shape == q.shape for t in (o, do)),
            "o/do must be contiguous bf16 in q's shape")
    require(lse.dtype == torch.float32 and lse.is_contiguous()
            and lse.shape == (b, h, sq), "lse must be contiguous (B, H, Sq) "
            "f32")
    dev = q.device
    require(all(t.is_cuda and t.device == dev for t in (q, k, v, o, lse, do)),
            "tensors must share one CUDA device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.sals_flash_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(do), ptr(dq), ptr(dk),
        ptr(dv), ptr(dsum), b, sq, sk, h, hkv, dh, int(causal),
        int(prefix_len), float(softcap), _build.stream_handle(dev))
    _build.check(err, "flash_attention_bwd")
    bwd_launches.add()
    return dq, dk, dv
