// Forward flash attention (prefill), Hopper port of
// repro/kernels/flash_attention.py::flash_attention_pallas.
//
// Bound: 4*B*H*Sq*Sk*dh FLOP (about halved by causality) on the bf16 tensor
// cores: 550 GFLOP, 0.556 ms at B 4, S 4096, H 32, dh 128.  The kernel is
// built to keep those tensor cores fed:
//
// * Grid (B*H, ceil(Sq/128)), 384 threads: one producer warpgroup (one
//   thread issues every load; setmaxnreg gives its registers away) and two
//   consumer warpgroups, each owning 64 of the block's 128 query rows.
//   Query tiles run in reverse order (blockIdx.y = 0 is the last tile), so
//   under causality the longest rows start first and the last wave is short.
// * TMA brings the Q tile once and BN-key K and V tiles through a ring of
//   two stages under full/empty mbarriers, over 4-D tensor maps (dh, heads,
//   S, B) with the 128-byte swizzle (a dh-128 tile is two 64-column
//   boxes).  BN is 128 at dh 64 and 128, and 64 at dh 256, where the
//   128-row Q tile (64 KB) and two stages of 128-key K and V (256 KB)
//   would not fit in shared memory; 64-key tiles take 197 KB.  Query head
//   h reads kv head h / (H / Hkv): GQA needs no copy.
//   TMA zero-fills rows past Sk; the kernel masks kp >= Sk and the causal
//   diagonal (q_off = Sk - Sq) itself, on the tiles that cross them only.
//   Tiles wholly above the diagonal are never loaded.
// * Prefix-LM (prefix_len > 0, causal; the PREFIX instance): keys kp <
//   prefix_len are visible to every query, so the mask keeps (qp >= kp) |
//   (kp < prefix_len) and the live tiles run to max(diagonal, prefix_len);
//   a tile wholly inside the prefix needs no mask.  The other instance
//   carries no prefix term: with it, the causal dh-64 kernel ran 20%
//   slower on an H100.
// * S = Q K^T is one wgmma m64n{BN}k16 chain per consumer from swizzled
//   shared memory (both K-major).  The scale, softcap (f32 tanh), mask and
//   online softmax run on the accumulator registers (exp2, row max and sum
//   across the four threads of a row); P is rounded to bf16 in place, the
//   accumulator fragment being wgmma's A-register fragment, and O += P V
//   is a wgmma m64n{dh}k16 chain (two m64n128k16 halves at dh 256) with A
//   from registers and V read through the transposed (MN-major)
//   descriptor.  O, the row max and the row sum stay in registers for the
//   whole KV loop: no S, P or O tile goes through shared memory.
// * The epilogue divides by the row sum and writes bf16, rows >= Sq masked.
//   Given a non-null lse (the training forward), it also writes each row's
//   log-sum-exp (B, H, Sq) f32, natural log: m ln 2 + ln l from the
//   log2-unit row max m and row sum l.  A null lse (serving) writes O
//   only, as before.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

constexpr int FA_BM = 128;       // query rows per block
constexpr int FA_STAGES = 2;     // K/V ring depth
constexpr int FA_THREADS = 384;  // producer + two consumer warpgroups

// keys per K/V tile
template <int DH>
constexpr int fa_bn() { return DH > 128 ? 64 : 128; }

template <int DH>
struct FaSmem {
  static constexpr int BN = fa_bn<DH>();
  static constexpr size_t Q = (size_t)FA_BM * DH * 2;
  static constexpr size_t KV = (size_t)BN * DH * 2;
  static constexpr size_t BARS = 8 * (1 + 4 * FA_STAGES);
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr size_t BYTES = 1024 + Q + 2 * FA_STAGES * KV + BARS;
};

__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t fa_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH, bool PREFIX>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int causal,
    int prefix_len, float softcap, float scale) {
  using L = FaSmem<DH>;
  constexpr int FA_BN = L::BN;
  constexpr int NB = DH / 64;  // 64-column boxes per row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + L::Q;
  unsigned char* v_s = k_s + FA_STAGES * L::KV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + FA_STAGES * L::KV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + FA_STAGES;
  uint64_t* v_full = k_empty + FA_STAGES;
  uint64_t* v_empty = v_full + FA_STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * FA_BM;
  const int q_off = Sk - Sq;
  // causal: keys up to the block's last row, and the whole prefix
  const int kv_end =
      causal ? min(Sk, PREFIX ? max(q_off + q0 + FA_BM, prefix_len)
                              : q_off + q0 + FA_BM)
             : Sk;
  const int n_tiles = (kv_end + FA_BN - 1) / FA_BN;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2);  // one arrive per consumer warpgroup
      mbar_init(v_empty + s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, (uint32_t)L::Q);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(q_s + nb * FA_BM * 128, &tm_q, q_full, nb * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FA_STAGES;
        const uint32_t ph = (t / FA_STAGES) & 1;
        mbar_wait(k_empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, (uint32_t)L::KV);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(k_s + s * L::KV + nb * FA_BN * 128, &tm_k, k_full + s,
                      nb * 64, hk, t * FA_BN, b);
        mbar_wait(v_empty + s, ph ^ 1);
        mbar_expect_tx(v_full + s, (uint32_t)L::KV);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(v_s + s * L::KV + nb * FA_BN * 128, &tm_v, v_full + s,
                      nb * 64, hk, t * FA_BN, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  // this thread's rows (accumulator rows lane/4 and lane/4 + 8 of its warp)
  const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;
  const int wg_qp_lo = q_off + q0 + cw * 64;  // smallest position of the WG
  const float LOG2E = 1.4426950408889634f;
  const float scale_log2 = scale * LOG2E;

  float acc_o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_o[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums

  const uint32_t q_addr = sals_smem(q_s) + cw * 64 * 128;
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % FA_STAGES;
    const uint32_t ph = (t / FA_STAGES) & 1;
    const int k0 = t * FA_BN;

    // S = Q K^T
    float sc[FA_BN / 2];
#pragma unroll
    for (int i = 0; i < FA_BN / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full + s, ph);
    const uint32_t k_addr = sals_smem(k_s + s * L::KV);
    wgmma_hold<FA_BN / 2>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
      const uint64_t da =
          gmma_desc(q_addr + (kk / 4) * FA_BM * 128 + off, 16, 1024);
      const uint64_t db =
          gmma_desc(k_addr + (kk / 4) * FA_BN * 128 + off, 16, 1024);
      wgmma_ss<FA_BN>(sc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold<FA_BN / 2>(sc);
    if (tid == 0) mbar_arrive(k_empty + s);

    // logits in log2 units, masked where the tile crosses Sk or the
    // diagonal outside the prefix
    const bool need_mask =
        k0 + FA_BN > Sk ||
        (causal && k0 + FA_BN - 1 > wg_qp_lo &&
         (!PREFIX || k0 + FA_BN > prefix_len));
#pragma unroll
    for (int j = 0; j < FA_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if (softcap != 0.f)
          x = softcap * tanhf(x * scale / softcap) * LOG2E;
        else
          x *= scale_log2;
        if (need_mask) {
          const int kp = k0 + 8 * j + 2 * quad + (e & 1);
          const int qp = q_off + row0 + 8 * (e >> 1);
          if (kp >= Sk ||
              (causal && kp > qp && (!PREFIX || kp >= prefix_len)))
            x = -INFINITY;
        }
        sc[4 * j + e] = x;
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < FA_BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx);
      // a row with nothing unmasked yet keeps m = -inf: subtract 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = fa_exp2(m_i[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < FA_BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = fa_exp2(sc[4 * j + 2 * i + c] - m_use);
          sc[4 * j + 2 * i + c] = p;
          sum += p;
        }
      }
      l_i[i] = l_i[i] * alpha[i] + sum;
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc_o[4 * j + 0] *= alpha[0];
      acc_o[4 * j + 1] *= alpha[0];
      acc_o[4 * j + 2] *= alpha[1];
      acc_o[4 * j + 3] *= alpha[1];
    }
    // P in bf16, in place: keys 16kk..16kk+15 of the S fragment are the A
    // fragment of k-step kk
    uint32_t pa[FA_BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = fa_pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }

    // O += P V
    mbar_wait(v_full + s, ph);
    const uint32_t v_addr = sals_smem(v_s + s * L::KV);
    wgmma_hold<DH / 2>(acc_o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk) {
      const uint32_t va = v_addr + kk * 16 * 128;
      if constexpr (DH <= 128) {
        wgmma_rs<DH>(acc_o, pa[kk], gmma_desc(va, FA_BN * 128, 1024), 1);
      } else {
        // columns 128 and up start two 64-column boxes further on
#pragma unroll
        for (int n = 0; n < DH / 128; ++n)
          wgmma_rs<128>(acc_o + 64 * n, pa[kk],
                        gmma_desc(va + n * 2 * FA_BN * 128, FA_BN * 128, 1024),
                        1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold<DH / 2>(acc_o);
    if (tid == 0) mbar_arrive(v_empty + s);
  }

  // epilogue: O / l in bf16
  const size_t q_row = (size_t)H * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * i;
    if (lse != nullptr && quad == 0 && row < Sq)
      lse[((size_t)b * H + h) * Sq + row] =
          m_i[i] * 0.6931471805599453f + logf(l);
    if (row < Sq) {
      __nv_bfloat16* orow =
          o + ((size_t)b * Sq + row) * q_row + (size_t)h * DH + 2 * quad;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2 * i] * inv,
                                  acc_o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

template <int DH, bool PREFIX>
static int launch_fa(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int Hkv,
                     int causal, int prefix_len, float softcap,
                     cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int err = sals_tmap_bshd(&tq, q, B, Sq, H, DH, FA_BM);
  if (!err) err = sals_tmap_bshd(&tk, k, B, Sk, Hkv, DH, FaSmem<DH>::BN);
  if (!err) err = sals_tmap_bshd(&tv, v, B, Sk, Hkv, DH, FaSmem<DH>::BN);
  if (err) return err;
  const size_t smem = FaSmem<DH>::BYTES;
  cudaFuncSetAttribute(flash_fwd_kernel<DH, PREFIX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(B * H, (Sq + FA_BM - 1) / FA_BM);
  flash_fwd_kernel<DH, PREFIX><<<grid, FA_THREADS, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, Hkv, causal,
      prefix_len, softcap, (float)(1.0 / sqrt((double)DH)));
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_fa(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int Hkv,
                     int causal, int prefix_len, float softcap,
                     cudaStream_t st) {
  return prefix_len ? launch_fa<DH, true>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                          causal, prefix_len, softcap, st)
                    : launch_fa<DH, false>(q, k, v, o, lse, B, Sq, Sk, H,
                                           Hkv, causal, 0, softcap, st);
}

// prefix_len > 0 (prefix-LM) needs causal: the first prefix_len keys are
// visible to every query, the rest causally.  lse: NULL, or a (B, H, Sq)
// f32 output for the rows' log-sum-exp (the training forward).
extern "C" int sals_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int B, int Sq, int Sk, int H, int Hkv,
                                    int dh, int causal, int prefix_len,
                                    float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Sk < 1 || (causal && Sq > Sk) || Hkv < 1 || H % Hkv ||
      prefix_len < 0 || (prefix_len && !causal))
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  if (dh == 128)
    return launch_fa<128>(q, k, v, o, l, B, Sq, Sk, H, Hkv, causal,
                          prefix_len, softcap, st);
  if (dh == 64)
    return launch_fa<64>(q, k, v, o, l, B, Sq, Sk, H, Hkv, causal,
                         prefix_len, softcap, st);
  if (dh == 256)
    return launch_fa<256>(q, k, v, o, l, B, Sq, Sk, H, Hkv, causal,
                          prefix_len, softcap, st);
  return (int)cudaErrorInvalidValue;
}
