// Backward flash attention (FlashAttention-2), Hopper port of the custom
// VJP of the reference's training attention,
// repro/kernels/ops.py::_flash_bwd_rule (the backward of ops._flash_xla;
// XLA, not Pallas).  Given q, k, v, the forward's O and LSE (B, H, Sq) f32
// (natural log) and dO, it returns dq, dk, dv in the inputs' bf16:
//
//   D  = rowsum(dO * O)                                  (f32)
//   P  = exp(logits - LSE), masked entries 0             (f32)
//   dV = P^T dO             with P rounded to bf16
//   dS = P * (dO V^T - D) [* (1 - tanh^2) under softcap] * scale
//   dQ = dS K,  dK = dS^T Q with dS rounded to bf16
//
// the rounding points of _flash_bwd_rule (:199, :208).  Masks are the
// forward's: causal with q_off = Sk - Sq, prefix-LM (keys below
// prefix_len visible to every query), softcap; GQA reads kv head
// h / (H / Hkv) and sums each group's heads into dK / dV, K and V
// unexpanded.
//
// Bound: operations.  Five GEMMs of 2*Sq*Sk*dh per head (the S recompute,
// dV, dP, dQ, dK): 10*B*H*Sq*Sk*dh FLOP, about halved by causality, on the
// bf16 tensor cores (989 TFLOP/s): 0.52 ms at qwen2-1.5b's training shape
// (B 4, S 4096, 12 over 2 heads, dh 128).  This first design is simple and
// deterministic, not yet fast (wgmma and TMA are later work):
//
// * Three kernels, no atomics, so two runs give the same bits.
//   fb_dot_kernel: D, one warp per (b, q, h) row.
//   fb_dkdv_kernel: grid (B*Hkv, ceil(Sk/64), dh/NC); a block of four warps
//   owns a 64-key tile of one kv head (16 keys a warp) and NC of its dh
//   columns (NC = min(dh, 128): dh 256 takes two column blocks, each
//   recomputing S and dP over the full dh, so that the dK / dV
//   accumulators fit in registers).  It walks the group's query heads in
//   ascending order and, for each, the 32-row query tiles that can see the
//   keys (under causality from the diagonal on, every tile where the keys
//   lie in the prefix), computing S^T = K Q^T and dP^T = V dO^T, then P^T
//   and dS^T in registers, and dV += P^T dO, dK += dS^T Q in f32
//   registers; dK and dV are written once.
//   fb_dq_kernel: grid (B*H, ceil(Sq/64)), longest query tiles first; a
//   block owns 64 query rows (16 a warp) and walks the visible BN-key
//   tiles (64 keys, 32 at dh 256), dQ += dS K in f32 registers.
// * Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   Tiles are staged in shared memory by 16-byte loads, rows padded by 16
//   bytes so that ldmatrix reads them without bank conflicts; ldmatrix
//   (.trans for the operands whose contraction runs down the rows: dO and
//   Q in dV / dK, K in dQ) feeds the fragments, and the accumulator
//   fragments of S and dP are reused in place as the A fragments of the
//   next products.
//
// The kernels are in flash_attention_bwd.cuh; this source holds the entry
// and the dh 128 instance, and the dh 64 and 256 instances compile in
// their own sources, so that the build runs the three at once.
#include "flash_attention_bwd.cuh"

// the dh 64 and 256 instances live in their own sources
extern template int launch_fb<64>(const void*, const void*, const void*,
                                  const void*, const float*, const void*,
                                  void*, void*, void*, float*, int, int, int,
                                  int, int, int, int, float, cudaStream_t);
extern template int launch_fb<256>(const void*, const void*, const void*,
                                   const void*, const float*, const void*,
                                   void*, void*, void*, float*, int, int, int,
                                   int, int, int, int, float, cudaStream_t);

// q (B, Sq, H, dh), k / v (B, Sk, Hkv, dh), o / dout (B, Sq, H, dh) bf16;
// lse (B, H, Sq) f32 from the forward; dsum a (B, H, Sq) f32 scratch.
// Writes dq (B, Sq, H, dh), dk / dv (B, Sk, Hkv, dh) bf16.  prefix_len > 0
// (prefix-LM) needs causal.
extern "C" int sals_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int Sq, int Sk, int H, int Hkv, int dh, int causal,
    int prefix_len, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || (causal && Sq > Sk) || Hkv < 1 ||
      H % Hkv || prefix_len < 0 || (prefix_len && !causal))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dh == 128)
    return launch_fb<128>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                          Hkv, causal, prefix_len, softcap, st);
  if (dh == 64)
    return launch_fb<64>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                         Hkv, causal, prefix_len, softcap, st);
  if (dh == 256)
    return launch_fb<256>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                          Hkv, causal, prefix_len, softcap, st);
  return (int)cudaErrorInvalidValue;
}
