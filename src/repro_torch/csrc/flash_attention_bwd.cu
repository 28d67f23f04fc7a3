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
// (B 4, S 4096, 12 over 2 heads, dh 128).  The design keeps the tensor
// cores fed the way the forward (flash_attention.cu) does, and keeps a
// fixed summation order, so that two runs give the same bits:
//
// * Three kernels, no atomics.  FlashAttention-3 computes dQ inside the
//   dK/dV kernel by f32 atomicAdd, whose order changes from run to run;
//   here dQ has its own kernel, which recomputes S and dP: seven products
//   against the bound's five, which caps the pair near 71% of the bound.
// * fb_dot_kernel: D, one warp a row, written with the row's LSE * log2(e)
//   into a (B*H, Sq rounded up to 128, 2) f32 scratch, so that a tile's
//   {LSE, D} is one 16-byte-aligned bulk copy whatever Sq is (padding rows
//   {0, 0}).
// * Registers decide the block shape.  Three warpgroups (a producer beside
//   two consumers) put three warps on an SM sub-partition, which caps a
//   thread at 168 registers, and setmaxnreg did not reliably lift the
//   consumers (nvcc 12.9 spilled and serialized the wgmmas).  So a block
//   is 256 threads, two consumer warpgroups at up to 255 registers, and
//   thread 0 issues the copies: the ring's next tile goes out once both
//   warpgroups have released its stage.
// * fb_dkdv_kernel: grid (B*Hkv, ceil(Sk/BN)), key tile 0 (the longest
//   under causality) first.  TMA loads the block's K and V once and
//   streams 64-row Q and dO tiles with their {LSE, D} through a ring of
//   ST stages, over the forward's 4-D tensor maps (dh, heads, S, B) with
//   the 128-byte swizzle.  The walk takes the group's query heads in
//   ascending order and, for each, only the tiles that can see the keys
//   (under causality from the diagonal on, every tile where the keys lie
//   in the prefix).  Per tile: S^T = K Q^T and dP^T = V dO^T as two wgmma
//   groups from shared memory (both K-major); P^T in f32 on the
//   accumulator registers while dP^T runs, packed in place to bf16 A
//   fragments; dV += P^T dO (A from registers, dO read MN-major) while
//   dS^T is formed; then dK += dS^T Q.  dK and dV stay in f32 registers
//   for the whole walk and are written once, as bf16.
//   - dh 64 and 128 (pair): BN = 128 keys, each warpgroup owning 64 with
//     both accumulators, ST 3.  Registers a thread: dK + dV 2 * dh/2 and
//     S^T, P^T, dP^T 2 * 32 + 16: 160 at dh 64, 224 at dh 128 (ptxas:
//     184 and 246).  Shared memory 84,536 / 166,456 bytes.
//   - dh 256 (split): dK + dV of 64 keys are 256 floats a thread, which do
//     not fit.  BN = 64, ST 2; warpgroup 0 computes S^T, P^T and dV +=
//     P^T dO, warpgroup 1 dP^T, dS^T and dK += dS^T Q, each with one
//     128-float accumulator; warpgroup 0 hands P^T (1 - t^2) in f32 to
//     warpgroup 1 through a 16 KB buffer under two named barriers (full,
//     empty).  No product is computed twice.  Shared memory: K, V (64 KB),
//     two stages of Q and dO (128 KB), the buffer and {LSE, D}: 215,080
//     bytes of 232,448.
// * fb_dq_kernel: grid (B*H, ceil(Sq/BM)), the longest query tiles first,
//   the forward's structure: TMA loads the block's Q and dO once and
//   streams BN-key K and V tiles through a two-stage ring, never loading
//   a tile wholly above the diagonal and outside the prefix.  Per tile:
//   S = Q K^T and dP = dO V^T (wgmma from shared memory), P while dP runs,
//   dS (each row's LSE and D in registers for the whole walk), then dQ +=
//   dS K with K read MN-major (the forward's P V form), left running into
//   the next tile's S and dP.  dh 64 and 128: two consumer warpgroups of
//   64 rows (BM 128), BN 128; registers dQ dh/2 + S, dP 2 * 64 + dS 32:
//   192 at dh 64, 224 at dh 128 (ptxas: 231 and 252); shared memory
//   99,368 / 197,672 bytes.  dh 256: one consumer warpgroup (BM 64) beside
//   a producer warpgroup, BN 64; registers 128 + 2 * 32 + 16 (ptxas 243);
//   shared memory 197,672 bytes.
// * A consumer warpgroup skips a tile wholly past its diagonal (the ring
//   still turns), and masks only the tiles that cross the diagonal, Sq or
//   Sk.  TMA zero-fills rows past Sq and Sk.  Softcap is a template
//   argument (SC): its dS needs 1 - tanh^2 from the S pass, so that
//   instance forms P and dS once both products are done.
//
// * dh 80 (hubert-xlarge) is the dh 128 body over dh 128's shared-memory
//   layout: tensor maps of the true 80 columns (160-byte rows), so TMA
//   reads 80 columns and zero-fills 80-127; S^T, dP^T, S and dP stop
//   after 5 k-steps of 16, dV, dK and dQ are m64n80k16 chains (40 floats
//   a thread each), the D pass and the stores touch 80 columns, and the
//   scale is 80^-0.5.  Shared memory is dh 128's.
//
// The kernels are in flash_attention_bwd.cuh; this source holds the entry
// and the dh 128 instance, and the dh 64, 80 and 256 instances compile in
// their own sources, so that the build runs the four at once.
#include "flash_attention_bwd.cuh"

// the dh 64, 80 and 256 instances live in their own sources
extern template int launch_fb<64>(const void*, const void*, const void*,
                                  const void*, const float*, const void*,
                                  void*, void*, void*, float*, int, int, int,
                                  int, int, int, int, float, cudaStream_t);
extern template int launch_fb<80>(const void*, const void*, const void*,
                                  const void*, const float*, const void*,
                                  void*, void*, void*, float*, int, int, int,
                                  int, int, int, int, float, cudaStream_t);
extern template int launch_fb<256>(const void*, const void*, const void*,
                                   const void*, const float*, const void*,
                                   void*, void*, void*, float*, int, int, int,
                                   int, int, int, int, float, cudaStream_t);

// q (B, Sq, H, dh), k / v (B, Sk, Hkv, dh), o / dout (B, Sq, H, dh) bf16;
// lse (B, H, Sq) f32 from the forward; ld a (B, H, fb_rows(Sq), 2) f32
// scratch for each row's {LSE, D}.
// Writes dq (B, Sq, H, dh), dk / dv (B, Sk, Hkv, dh) bf16.  prefix_len > 0
// (prefix-LM) needs causal.
extern "C" int sals_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* ld, int B, int Sq, int Sk, int H, int Hkv, int dh, int causal,
    int prefix_len, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || (causal && Sq > Sk) || Hkv < 1 ||
      H % Hkv || prefix_len < 0 || (prefix_len && !causal))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(ld);
  if (dh == 128)
    return launch_fb<128>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                          Hkv, causal, prefix_len, softcap, st);
  if (dh == 64)
    return launch_fb<64>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                         Hkv, causal, prefix_len, softcap, st);
  if (dh == 256)
    return launch_fb<256>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                          Hkv, causal, prefix_len, softcap, st);
  if (dh == 80)
    return launch_fb<80>(q, k, v, o, l, dout, dq, dk, dv, ds, B, Sq, Sk, H,
                         Hkv, causal, prefix_len, softcap, st);
  return (int)cudaErrorInvalidValue;
}
