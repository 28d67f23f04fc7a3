// Kernels of the flash backward (see flash_attention_bwd.cu for the
// design and bound).  Each head_dim instance of launch_fb is compiled in
// its own source (flash_attention_bwd.cu: 128, flash_attention_bwd_dh64.cu,
// flash_attention_bwd_dh256.cu), so the three build in parallel.
#pragma once

#include "common.cuh"

#include <math.h>

constexpr int FB_THREADS = 128;  // four warps
constexpr int FB_BN = 64;        // keys per dK/dV block (16 a warp)
constexpr int FB_BM = 32;        // query rows per dK/dV step
constexpr int FB_QM = 64;        // query rows per dQ block (16 a warp)

template <int DH>
__host__ __device__ constexpr int fb_nc() { return DH > 128 ? 128 : DH; }
template <int DH>
__host__ __device__ constexpr int fb_qbn() { return DH > 128 ? 32 : 64; }

// padded row stride (elements) of a shared tile
template <int DH>
__host__ __device__ constexpr int fb_ld() { return DH + 8; }

template <int DH>
constexpr size_t fb_dkdv_smem() {
  return (size_t)(2 * FB_BN + 2 * FB_BM) * fb_ld<DH>() * 2 +
         2 * FB_BM * sizeof(float);
}
template <int DH>
constexpr size_t fb_dq_smem() {
  return (size_t)(2 * FB_QM + 2 * fb_qbn<DH>()) * fb_ld<DH>() * 2;
}

__device__ __forceinline__ uint32_t fb_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fb_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void fb_ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void fb_ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t fb_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of head `head` of a (B, S, heads, DH) bf16 tensor
// into a padded shared tile; rows at or past S are zero.
template <int DH, int ROWS>
__device__ __forceinline__ void fb_load(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int b,
                                        int r0, int S, int heads, int head) {
  constexpr int CH = DH / 8;  // 16-byte chunks a row
  constexpr int LD = fb_ld<DH>();
  const size_t row_stride = (size_t)heads * DH;
  const __nv_bfloat16* base = src + ((size_t)b * S) * row_stride +
                              (size_t)head * DH;
  for (int i = threadIdx.x; i < ROWS * CH; i += FB_THREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) *
                                                       row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// A fragment (16 x 16, rows m0.., columns k0..) of a row-major tile
__device__ __forceinline__ uint32_t fb_a_addr(const __nv_bfloat16* t, int ld,
                                              int m0, int k0) {
  const int lane = threadIdx.x % 32;
  return fb_smem(t + (m0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}
// B fragments of two n8 tiles (n0.., n0+8..; k0..k0+15) from a tile
// stored [n][k] (contraction along the row): plain ldmatrix
__device__ __forceinline__ uint32_t fb_bn_addr(const __nv_bfloat16* t, int ld,
                                               int n0, int k0) {
  const int lane = threadIdx.x % 32;
  return fb_smem(t + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 +
                 ((lane / 8) % 2) * 8);
}
// B fragments of two n8 tiles from a tile stored [k][n] (contraction down
// the rows): ldmatrix .trans
__device__ __forceinline__ uint32_t fb_bk_addr(const __nv_bfloat16* t, int ld,
                                               int k0, int n0) {
  const int lane = threadIdx.x % 32;
  return fb_smem(t + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 +
                 (lane / 16) * 8);
}

// D = rowsum(dO * O) in f32, written (B, H, Sq); one warp a row
template <int DH>
__global__ void __launch_bounds__(256) fb_dot_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ dsum, int B, int Sq, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t r = (size_t)blockIdx.x * 8 + warp;  // (b, s, h) row
  if (r >= (size_t)B * Sq * H) return;
  const __nv_bfloat16* orow = o + r * DH;
  const __nv_bfloat16* drow = dout + r * DH;
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < DH; i += 32)
    acc += __bfloat162float(orow[i]) * __bfloat162float(drow[i]);
  acc = sals_warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(r % H);
    const size_t bs = r / H;
    const int s = (int)(bs % Sq), b = (int)(bs / Sq);
    dsum[((size_t)b * H + h) * Sq + s] = acc;
  }
}

template <int DH>
__global__ void __launch_bounds__(FB_THREADS) fb_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ dsum,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
    int Sk, int H, int Hkv, int causal, int prefix_len, float softcap,
    float scale) {
  constexpr int LD = fb_ld<DH>();
  constexpr int NC = fb_nc<DH>();
  extern __shared__ __align__(16) unsigned char fb_smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(fb_smem_raw);
  __nv_bfloat16* v_s = k_s + FB_BN * LD;
  __nv_bfloat16* q_s = v_s + FB_BN * LD;
  __nv_bfloat16* do_s = q_s + FB_BM * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + FB_BM * LD);
  float* d_s = lse_s + FB_BM;

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * FB_BN;
  const int c0 = blockIdx.z * NC;
  const int group = H / Hkv;
  const int q_off = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;

  fb_load<DH, FB_BN>(k_s, k, b, k0, Sk, Hkv, hk);
  fb_load<DH, FB_BN>(v_s, v, b, k0, Sk, Hkv, hk);

  // the first query that can see key k0: its position q_off + qi >= k0,
  // unless the tile starts inside the prefix
  int qi_first = 0;
  if (causal && k0 >= prefix_len) qi_first = max(0, k0 - q_off);
  const int qt_first = qi_first / FB_BM;

  float acc_dk[NC / 8][4], acc_dv[NC / 8][4];
#pragma unroll
  for (int i = 0; i < NC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

  const int m0 = warp * 16;  // this warp's keys within the tile
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = qt_first; qt * FB_BM < Sq; ++qt) {
      const int q0 = qt * FB_BM;
      __syncthreads();  // the previous step is done with q_s / do_s
      fb_load<DH, FB_BM>(q_s, q, b, q0, Sq, H, h);
      fb_load<DH, FB_BM>(do_s, dout, b, q0, Sq, H, h);
      for (int i = threadIdx.x; i < FB_BM; i += FB_THREADS) {
        const bool in = q0 + i < Sq;
        const size_t idx = ((size_t)b * H + h) * Sq + q0 + i;
        lse_s[i] = in ? lse[idx] : 0.f;
        d_s[i] = in ? dsum[idx] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x BM queries a warp
      float st[FB_BM / 8][4], dpt[FB_BM / 8][4];
#pragma unroll
      for (int j = 0; j < FB_BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4], bb[4];
        fb_ldsm(a, fb_a_addr(k_s, LD, m0, kk * 16));
#pragma unroll
        for (int j = 0; j < FB_BM / 16; ++j) {
          fb_ldsm(bb, fb_bn_addr(q_s, LD, j * 16, kk * 16));
          fb_mma(st[2 * j], a, bb[0], bb[1]);
          fb_mma(st[2 * j + 1], a, bb[2], bb[3]);
        }
        fb_ldsm(a, fb_a_addr(v_s, LD, m0, kk * 16));
#pragma unroll
        for (int j = 0; j < FB_BM / 16; ++j) {
          fb_ldsm(bb, fb_bn_addr(do_s, LD, j * 16, kk * 16));
          fb_mma(dpt[2 * j], a, bb[0], bb[1]);
          fb_mma(dpt[2 * j + 1], a, bb[2], bb[3]);
        }
      }

      // P^T and dS^T in place
#pragma unroll
      for (int j = 0; j < FB_BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + m0 + lane / 4 + (e >> 1) * 8;
          const int qc = j * 8 + 2 * quad + (e & 1);
          const int qi = q0 + qc;
          const float x = st[j][e] * scale;
          float t = 0.f, logit = x;
          if (softcap != 0.f) {
            t = tanhf(x / softcap);
            logit = softcap * t;
          }
          const bool vis = kp < Sk && qi < Sq &&
                           (!causal || kp <= q_off + qi || kp < prefix_len);
          const float p = vis ? __expf(logit - lse_s[qc]) : 0.f;
          float ds = p * (dpt[j][e] - d_s[qc]);
          if (softcap != 0.f) ds *= 1.f - t * t;
          st[j][e] = p;
          dpt[j][e] = ds * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over this warp's NC columns
#pragma unroll
      for (int kk = 0; kk < FB_BM / 16; ++kk) {
        const uint32_t pa[4] = {fb_pack(st[2 * kk][0], st[2 * kk][1]),
                                fb_pack(st[2 * kk][2], st[2 * kk][3]),
                                fb_pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                fb_pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t sa[4] = {
            fb_pack(dpt[2 * kk][0], dpt[2 * kk][1]),
            fb_pack(dpt[2 * kk][2], dpt[2 * kk][3]),
            fb_pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            fb_pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NC / 16; ++np) {
          uint32_t bb[4];
          fb_ldsm_t(bb, fb_bk_addr(do_s, LD, kk * 16, c0 + np * 16));
          fb_mma(acc_dv[2 * np], pa, bb[0], bb[1]);
          fb_mma(acc_dv[2 * np + 1], pa, bb[2], bb[3]);
          fb_ldsm_t(bb, fb_bk_addr(q_s, LD, kk * 16, c0 + np * 16));
          fb_mma(acc_dk[2 * np], sa, bb[0], bb[1]);
          fb_mma(acc_dk[2 * np + 1], sa, bb[2], bb[3]);
        }
      }
    }
  }

  // write dK, dV (bf16) for this warp's keys and the block's columns
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = k0 + m0 + lane / 4 + half * 8;
    if (kp >= Sk) continue;
    const size_t row = (((size_t)b * Sk + kp) * Hkv + hk) * DH + c0;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      const int col = nt * 8 + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
          __floats2bfloat162_rn(acc_dk[nt][2 * half],
                                acc_dk[nt][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
          __floats2bfloat162_rn(acc_dv[nt][2 * half],
                                acc_dv[nt][2 * half + 1]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(FB_THREADS) fb_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ dsum,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
    int causal, int prefix_len, float softcap, float scale) {
  constexpr int LD = fb_ld<DH>();
  constexpr int BN = fb_qbn<DH>();
  extern __shared__ __align__(16) unsigned char fb_smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fb_smem_raw);
  __nv_bfloat16* do_s = q_s + FB_QM * LD;
  __nv_bfloat16* k_s = do_s + FB_QM * LD;
  __nv_bfloat16* v_s = k_s + BN * LD;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * FB_QM;
  const int q_off = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int m0 = warp * 16;

  fb_load<DH, FB_QM>(q_s, q, b, q0, Sq, H, h);
  fb_load<DH, FB_QM>(do_s, dout, b, q0, Sq, H, h);
  float lse_r[2], d_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + m0 + lane / 4 + half * 8;
    const size_t idx = ((size_t)b * H + h) * Sq + qi;
    lse_r[half] = qi < Sq ? lse[idx] : 0.f;
    d_r[half] = qi < Sq ? dsum[idx] : 0.f;
  }
  const int kv_end =
      causal ? min(Sk, max(q_off + q0 + FB_QM, prefix_len)) : Sk;

  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kk0 = 0; kk0 < kv_end; kk0 += BN) {
    __syncthreads();  // the previous tile is done with k_s / v_s
    fb_load<DH, BN>(k_s, k, b, kk0, Sk, Hkv, hk);
    fb_load<DH, BN>(v_s, v, b, kk0, Sk, Hkv, hk);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4], bb[4];
      fb_ldsm(a, fb_a_addr(q_s, LD, m0, kk * 16));
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        fb_ldsm(bb, fb_bn_addr(k_s, LD, j * 16, kk * 16));
        fb_mma(s[2 * j], a, bb[0], bb[1]);
        fb_mma(s[2 * j + 1], a, bb[2], bb[3]);
      }
      fb_ldsm(a, fb_a_addr(do_s, LD, m0, kk * 16));
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        fb_ldsm(bb, fb_bn_addr(v_s, LD, j * 16, kk * 16));
        fb_mma(dp[2 * j], a, bb[0], bb[1]);
        fb_mma(dp[2 * j + 1], a, bb[2], bb[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qi = q0 + m0 + lane / 4 + half * 8;
        const int kp = kk0 + j * 8 + 2 * quad + (e & 1);
        const float x = s[j][e] * scale;
        float t = 0.f, logit = x;
        if (softcap != 0.f) {
          t = tanhf(x / softcap);
          logit = softcap * t;
        }
        const bool vis = kp < Sk && qi < Sq &&
                         (!causal || kp <= q_off + qi || kp < prefix_len);
        const float p = vis ? __expf(logit - lse_r[half]) : 0.f;
        float ds = p * (dp[j][e] - d_r[half]);
        if (softcap != 0.f) ds *= 1.f - t * t;
        s[j][e] = ds * scale;
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t sa[4] = {fb_pack(s[2 * kk][0], s[2 * kk][1]),
                              fb_pack(s[2 * kk][2], s[2 * kk][3]),
                              fb_pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              fb_pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bb[4];
        fb_ldsm_t(bb, fb_bk_addr(k_s, LD, kk * 16, np * 16));
        fb_mma(acc[2 * np], sa, bb[0], bb[1]);
        fb_mma(acc[2 * np + 1], sa, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + m0 + lane / 4 + half * 8;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (((size_t)b * Sq + qi) * H + h) * DH;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + 2 * quad) =
          __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

template <int DH>
int launch_fb(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* dsum, int B, int Sq, int Sk, int H, int Hkv,
              int causal, int prefix_len, float softcap, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const float scale = (float)(1.0 / sqrt((double)DH));
  const size_t rows = (size_t)B * Sq * H;
  fb_dot_kernel<DH><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), dsum, B, Sq,
      H);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_kv = fb_dkdv_smem<DH>();
  cudaFuncSetAttribute(fb_dkdv_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_kv);
  dim3 grid_kv(B * Hkv, (Sk + FB_BN - 1) / FB_BN, DH / fb_nc<DH>());
  fb_dkdv_kernel<DH><<<grid_kv, FB_THREADS, smem_kv, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), lse, static_cast<const bf*>(dout), dsum,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, H, Hkv, causal,
      prefix_len, softcap, scale);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_q = fb_dq_smem<DH>();
  cudaFuncSetAttribute(fb_dq_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_q);
  dim3 grid_q(B * H, (Sq + FB_QM - 1) / FB_QM);
  fb_dq_kernel<DH><<<grid_q, FB_THREADS, smem_q, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), lse, static_cast<const bf*>(dout), dsum,
      static_cast<bf*>(dq), Sq, Sk, H, Hkv, causal, prefix_len, softcap,
      scale);
  return (int)cudaGetLastError();
}
