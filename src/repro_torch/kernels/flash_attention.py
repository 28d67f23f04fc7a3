"""Forward flash attention for prefill on Hopper.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` (TPU)
with the hand-written CUDA kernel in ``csrc/flash_attention.cu``; the plain
PyTorch twin is ``kernels/ref.py::attention_ref``.

Bound on the H100: operations.  4·B·H·Sq·Sk·dh FLOP, halved by causality —
at the llama2-7b slice shapes (B=4, S=4096, H=32, dh=128) 550 GFLOP per
layer after the causal skip, about 0.56 ms on the bf16 tensor cores.
Design (warp-specialised TMA + wgmma): grid (B·H, ⌈Sq/128⌉), the query
tiles launched longest rows first; a producer warpgroup loads the 128-row
Q tile once and streams 128-key K/V tiles by TMA through a two-stage ring
under mbarriers (4-D tensor maps over (dh, heads, S, B), 128-byte
swizzle), never loading a tile wholly above the causal diagonal
(q_off = Sk − Sq); two consumer warpgroups of 64 rows run S = QKᵀ and
O += PV as wgmma chains (P from registers, rounded to bf16), with the
softcap, mask and online softmax in f32 on the accumulator registers and
O, the row max and sum in registers for the whole KV loop.  K/V are read at
kv head h // group, so GQA needs no expanded copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import ptr, require

launches = _build.LaunchCounter("flash_attention")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, softcap: float = 0.0
                         ) -> torch.Tensor:
    """q: (B, Sq, H, dh) bf16; k/v: (B, Sk, Hkv, dh) bf16 with Hkv | H.
    Returns (B, Sq, H, dh) bf16."""
    require(all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.dim() == 4
                for t in (q, k, v)), "q/k/v must be contiguous 4-D bf16")
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == dh,
            "k/v shapes")
    require(h % hkv == 0, "n_heads must be a multiple of the kv heads")
    require(dh in (64, 128), f"head_dim {dh} not in (64, 128)")
    require(not causal or sq <= sk, "causal attention needs Sq <= Sk")
    require(sq >= 1 and sk >= 1, "empty sequence")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "q/k/v must start on 16 bytes (TMA)")
    dev = q.device
    require(q.is_cuda and k.device == dev and v.device == dev,
            "tensors must share one CUDA device")
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.sals_flash_attention(ptr(q), ptr(k), ptr(v), ptr(out), b,
                                   sq, sk, h, hkv, dh, int(causal),
                                   float(softcap), _build.stream_handle(dev))
    _build.check(err, "flash_attention")
    launches.add()
    return out
