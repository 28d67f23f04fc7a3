// Forward flash attention (prefill), Hopper port of
// repro/kernels/flash_attention.py::flash_attention_pallas.
//
// Grid (B*H, ceil(Sq/64)), 128 threads (4 warps).  A block keeps a 64-row
// Q tile in shared memory and streams 64-row K/V tiles through it; tiles
// wholly above the causal diagonal (offset q_off = Sk - Sq) are never
// loaded.  S = Q K^T and O += P V run on the tensor cores through WMMA
// (bf16 operands, f32 accumulation); the scale, softcap, mask and the
// online softmax run in f32 (P is rounded to bf16 for the PV product, as
// the reference's chunked path does), and the output is written in bf16.
// K/V of kv head h / (H / Hkv) serve query head h, so GQA needs no
// repeat_kv copy.  Each warp owns 16 query rows end to end, so within a
// tile only warp-level synchronisation separates the three phases.
//
// Bound: 4*B*H*Sq*Sk*dh FLOP (halved by causality) on the bf16 tensor
// cores.  WMMA without a TMA/wgmma pipeline leaves much of that on the
// table; this is the simple version.
#include "common.cuh"

#include <math.h>
#include <mma.h>

using namespace nvcuda;

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 128;

template <int DH>
struct FaSmem {
  static constexpr int LDQ = DH + 8;     // bf16 pitch of Q/K/V tiles
  static constexpr int LDS = FA_BK + 4;  // f32 pitch of S
  static constexpr int LDP = FA_BK + 8;  // bf16 pitch of P
  static constexpr int LDO = DH + 4;     // f32 pitch of O
  static constexpr size_t Q = (size_t)FA_BQ * LDQ * 2;
  static constexpr size_t KV = (size_t)FA_BK * LDQ * 2;
  static constexpr size_t S = (size_t)FA_BQ * LDS * 4;
  static constexpr size_t P = (size_t)FA_BQ * LDP * 2;
  static constexpr size_t O = (size_t)FA_BQ * LDO * 4;
  static constexpr size_t BYTES = Q + 2 * KV + S + P + O;
};

template <int DH>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int H, int Hkv, int causal, float softcap, float scale) {
  using L = FaSmem<DH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q);
  __nv_bfloat16* Vs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q + L::KV);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::Q + 2 * L::KV);
  __nv_bfloat16* Ps =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q + 2 * L::KV + L::S);
  float* Os = reinterpret_cast<float*>(smem_raw + L::Q + 2 * L::KV + L::S +
                                       L::P);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int q_off = Sk - Sq;
  const size_t q_row = (size_t)H * DH, kv_row = (size_t)Hkv * DH;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_row + (size_t)h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)hk * DH;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)hk * DH;
  constexpr int VPR = DH / 8;  // 16-byte vectors per row

  for (int e = tid; e < FA_BQ * VPR; e += FA_THREADS) {
    const int rr = e / VPR, c = (e % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + rr < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + rr) * q_row + c);
    *reinterpret_cast<uint4*>(Qs + rr * L::LDQ + c) = val;
  }
  for (int e = tid; e < FA_BQ * L::LDO; e += FA_THREADS) Os[e] = 0.f;

  // softmax ownership: thread pair (2 row, 2 row + 1) owns row `row`,
  // halves of its columns; row lies in this warp's 16-row slab
  const int row = tid >> 1, hf = tid & 1;
  const int qp = q_off + q0 + row;
  float m_i = SALS_NEG_INF, l_i = 0.f;
  const int kv_end = causal ? min(Sk, q_off + q0 + FA_BQ) : Sk;
  const int n_tiles = (kv_end + FA_BK - 1) / FA_BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // previous tile's K/V consumed (and Q/O initialised)
    for (int e = tid; e < FA_BK * VPR; e += FA_THREADS) {
      const int rr = e / VPR, c = (e % VPR) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + rr < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + rr) * kv_row + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + rr) * kv_row + c);
      }
      *reinterpret_cast<uint4*>(Ks + rr * L::LDQ + c) = kv;
      *reinterpret_cast<uint4*>(Vs + rr * L::LDQ + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[FA_BK / 16];
#pragma unroll
      for (int n = 0; n < FA_BK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int n = 0; n < FA_BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(bf, Ks + n * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(sacc[n], a, bf, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < FA_BK / 16; ++n)
        wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + n * 16, sacc[n],
                                L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's half of the tile
    float* srow = Ss + row * L::LDS;
    float mx = SALS_NEG_INF;
    for (int c = hf * (FA_BK / 2); c < (hf + 1) * (FA_BK / 2); ++c) {
      float x = srow[c] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      const int kp = k0 + c;
      if (kp >= Sk || (causal && kp > qp)) x = SALS_NEG_INF;
      srow[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
    for (int c = hf * (FA_BK / 2); c < (hf + 1) * (FA_BK / 2); ++c) {
      const float x = srow[c];
      const float p = x <= SALS_NEG_INF * 0.5f ? 0.f : expf(x - m_new);
      Ps[row * L::LDP + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    for (int c = hf * (DH / 2); c < (hf + 1) * (DH / 2); ++c)
      Os[row * L::LDO + c] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + warp * 16 * L::LDO + n * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FA_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk, L::LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Vs + kk * L::LDQ + n * 16, L::LDQ);
        wmma::mma_sync(oacc, a, bf, oacc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * L::LDO + n * 16, oacc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q0 + row < Sq) {
    const float den = fmaxf(l_i, 1e-30f);
    __nv_bfloat16* orow = o + (size_t)b * Sq * q_row + (size_t)(q0 + row) * q_row +
                          (size_t)h * DH;
    for (int c = hf * (DH / 2); c < (hf + 1) * (DH / 2); ++c)
      orow[c] = __float2bfloat16(Os[row * L::LDO + c] / den);
  }
}

template <int DH>
static int launch_fa(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int Hkv, int causal,
                     float softcap, cudaStream_t st) {
  const size_t smem = FaSmem<DH>::BYTES;
  cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(B * H, (Sq + FA_BQ - 1) / FA_BQ);
  flash_fwd_kernel<DH><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, H, Hkv, causal, softcap, (float)(1.0 / sqrt((double)DH)));
  return (int)cudaGetLastError();
}

extern "C" int sals_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Sk, int H, int Hkv, int dh,
                                    int causal, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128)
    return launch_fa<128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, softcap, st);
  if (dh == 64)
    return launch_fa<64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, softcap, st);
  return (int)cudaErrorInvalidValue;
}
