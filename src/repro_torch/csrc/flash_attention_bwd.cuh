// Kernels of the flash backward (design, bound and the register and
// shared-memory arithmetic in flash_attention_bwd.cu).  Each head_dim
// instance of launch_fb is compiled in its own source
// (flash_attention_bwd.cu: 128, flash_attention_bwd_dh64.cu,
// flash_attention_bwd_dh80.cu, flash_attention_bwd_dh256.cu), so the four
// build in parallel.  DH is the true head_dim; the tiles in shared memory
// are sals_tile_dh(DH) columns wide (dh 80 takes dh 128's layout, the
// columns past 80 zero-filled by TMA), the products over dh take DH / 16
// k-steps and those whose N is dh run at N = DH.
#pragma once

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

constexpr int FB_ROW_PAD = 128;  // rows of the {LSE, D} scratch: Sq rounded up
constexpr int FB_BAR_FULL = 1;   // named barriers of the split dK/dV body
constexpr int FB_BAR_EMPTY = 2;
constexpr size_t FB_SMEM_MAX = 232448;  // what one block may use

__host__ __device__ constexpr int fb_rows(int sq) {
  return (sq + FB_ROW_PAD - 1) / FB_ROW_PAD * FB_ROW_PAD;
}

// dK/dV kernel: a block owns BN keys of one kv head and streams BM-row
// Q / dO tiles with their {LSE, D} rows through a ring of ST stages.
// SPLIT (dh 256): both consumer warpgroups share the block's 64 keys,
// warpgroup 0 accumulating dV and warpgroup 1 dK; otherwise each owns 64
// keys with both.  Two warpgroups and no producer: thread 0 issues the
// copies, so that a thread may hold 255 registers.
template <int DH>
struct FbKV {
  static constexpr bool SPLIT = DH > 128;
  static constexpr int BN = SPLIT ? 64 : 128;
  static constexpr int BM = 64;
  static constexpr int ST = SPLIT ? 2 : 3;
  static constexpr int THREADS = 256;
  static constexpr int TDH = sals_tile_dh(DH);  // columns of a tile
  static constexpr size_t KV = (size_t)BN * TDH * 2;  // the K tile (and V)
  static constexpr size_t QT = (size_t)BM * TDH * 2;  // a Q tile (and dO)
  static constexpr size_t LD = (size_t)BM * 8;       // {LSE, D} of a tile
  static constexpr size_t X = SPLIT ? 64 * BM * 4 : 0;  // P^T (1 - t^2)
  static constexpr size_t BARS = 8 * (1 + 2 * ST);
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr size_t BYTES = 1024 + 2 * KV + ST * (2 * QT + LD) + X + BARS;
  static_assert(BYTES <= FB_SMEM_MAX, "dK/dV shared memory");
};

// dQ kernel: a block owns BM query rows of one head (64 a consumer
// warpgroup) and streams BN-key K / V tiles through a ring of ST stages.
// dh 64 / 128: two consumer warpgroups, thread 0 issuing the copies; dh
// 256: one, beside a producer warpgroup (issuing from the lone consumer
// cost 7% at paligemma-3b's shape on an H100).
template <int DH>
struct FbQ {
  static constexpr int NWG = DH > 128 ? 1 : 2;
  static constexpr bool PRODUCER = NWG == 1;
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = DH > 128 ? 64 : 128;
  static constexpr int ST = 2;
  static constexpr int THREADS = 128 * (NWG + PRODUCER);
  static constexpr int TDH = sals_tile_dh(DH);  // columns of a tile
  static constexpr size_t QT = (size_t)BM * TDH * 2;  // the Q tile (and dO)
  static constexpr size_t KV = (size_t)BN * TDH * 2;  // a K tile (and V)
  static constexpr size_t BARS = 8 * (1 + 2 * ST);
  static constexpr size_t BYTES = 1024 + 2 * QT + 2 * ST * KV + BARS;
  static_assert(BYTES <= FB_SMEM_MAX, "dQ shared memory");
};

__device__ __forceinline__ float fb_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t fb_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned char* fb_align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// acc (64 x N) += A B^T over K = DH (DH / 16 k-steps: dh 80 stops at the
// second box's first 16 columns): A the 64 rows at a_addr of a K-major
// tile of a_rows rows, B a K-major tile of N rows at b_addr.
template <int DH, int N>
__device__ __forceinline__ void fb_ss(float* acc, uint32_t a_addr,
                                      int a_rows, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
    wgmma_ss<N>(acc,
                gmma_desc(a_addr + (kk / 4) * a_rows * 128 + off, 16, 1024),
                gmma_desc(b_addr + (kk / 4) * N * 128 + off, 16, 1024), 1);
  }
}

// acc (64 x DH) += A B over K = KD: A in bf16 fragments a[KD / 16][4] (an
// accumulator's layout), B the KD x DH tile at b_addr read MN-major (its
// rows are K; columns 64c.. lie in box c, KD * 128 bytes on; dh 80 is one
// m64n80k16 chain).
template <int DH, int KD>
__device__ __forceinline__ void fb_rs(float* acc, const uint32_t (*a)[4],
                                      uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t ba = b_addr + kk * 16 * 128;
    if constexpr (DH <= 128) {
      wgmma_rs<DH>(acc, a[kk], gmma_desc(ba, KD * 128, 1024), 1);
    } else {
#pragma unroll
      for (int n = 0; n < DH / 128; ++n)
        wgmma_rs<128>(acc + 64 * n, a[kk],
                      gmma_desc(ba + n * 2 * KD * 128, KD * 128, 1024), 1);
    }
  }
}

// Constants of one launch: P = 2^(logit * log2(e) - LSE2), LSE2 = LSE
// * log2(e) as the D pass stores it.
struct FbScale {
  float scale;  // dh^-0.5
  float s2;     // scale * log2(e): a raw score to a log2-unit logit
  float tc;     // scale / softcap: tanh's argument (SC)
  float cap2;   // softcap * log2(e) (SC)
};

// P of one raw score (q.k); under softcap (SC) also dt = 1 - tanh^2.
template <bool SC>
__device__ __forceinline__ float fb_prob(float s, float lse2,
                                         const FbScale& k, float& dt) {
  if constexpr (SC) {
    const float t = tanhf(s * k.tc);
    dt = 1.f - t * t;
    return fb_exp2(fmaf(t, k.cap2, -lse2));
  } else {
    dt = 1.f;
    return fb_exp2(fmaf(s, k.s2, -lse2));
  }
}

// {LSE * log2(e), D} of every query row into the (B*H, fb_rows(Sq), 2) f32
// scratch that the other two kernels read, D = rowsum(dO * O) in f32; the
// padding rows get {0, 0}.  One warp a row.
template <int DH>
__global__ void __launch_bounds__(256) fb_dot_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float2* __restrict__ ld, int B, int Sq,
    int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = fb_rows(Sq);
  const size_t r = (size_t)blockIdx.x * 8 + warp;  // (b, h, s) scratch row
  if (r >= (size_t)B * H * rows) return;
  const int s = (int)(r % rows);
  const size_t bh = r / rows;
  float acc = 0.f, l = 0.f;
  if (s < Sq) {
    const int h = (int)(bh % H), b = (int)(bh / H);
    const size_t off = (((size_t)b * Sq + s) * H + h) * DH;
#pragma unroll
    for (int i = lane; i < DH; i += 32)
      acc += __bfloat162float(o[off + i]) * __bfloat162float(dout[off + i]);
    acc = sals_warp_sum(acc);
    l = lse[bh * Sq + s] * 1.4426950408889634f;
  }
  if (lane == 0) ld[r] = make_float2(l, acc);
}

// Whether key kp is visible to query qi (the forward's mask).
__device__ __forceinline__ bool fb_visible(int kp, int qi, int Sq, int Sk,
                                           int q_off, int causal,
                                           int prefix_len) {
  return kp < Sk && qi < Sq &&
         (!causal || kp <= q_off + qi || kp < prefix_len);
}

template <int DH, bool SC>
__global__ void __launch_bounds__(FbKV<DH>::THREADS, 1) fb_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ ld,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
    int Sk, int H, int Hkv, int causal, int prefix_len, FbScale ks) {
  using L = FbKV<DH>;
  constexpr int BN = L::BN, BM = L::BM, NB = L::TDH / 64, ST = L::ST;
  constexpr bool SPLIT = L::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = fb_align1024(smem_raw);
  unsigned char* v_s = k_s + L::KV;
  unsigned char* q_s = v_s + L::KV;  // ST tiles each
  unsigned char* do_s = q_s + ST * L::QT;
  float* ld_s = reinterpret_cast<float*>(do_s + ST * L::QT);
  float* x_s = ld_s + ST * BM * 2;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(x_s) + L::X);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  // kv heads run fastest: every head's key tile 0, under causality the
  // longest, goes first
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BN;
  const int group = H / Hkv, q_off = Sk - Sq;
  // the query tiles that can see the block's keys: under causality from
  // the one holding key k0's diagonal on, unless k0 lies in the prefix
  int qi_first = 0;
  if (causal && k0 >= prefix_len) qi_first = max(0, k0 - q_off);
  const int qt_first = qi_first / BM;
  const int n_qt = (Sq + BM - 1) / BM - qt_first;  // tiles a query head
  const int n_items = group * n_qt;  // the group's heads in ascending order
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;

  // tile n of the walk into stage n % ST, once both warpgroups are done
  // with tile n - ST (thread 0)
  const CUtensorMap* map_q = &tm_q;
  const CUtensorMap* map_do = &tm_do;
  auto issue = [&](int n) {
    const int s = n % ST;
    const int h = hk * group + n / n_qt;
    const int q0 = (qt_first + n % n_qt) * BM;
    mbar_wait(empty + s, ((n / ST) & 1) ^ 1);
    mbar_expect_tx(full + s, (uint32_t)(2 * L::QT + L::LD));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(q_s + s * L::QT + nb * BM * 128, map_q, full + s, nb * 64,
                  h, q0, b);
      tma_load_4d(do_s + s * L::QT + nb * BM * 128, map_do, full + s,
                  nb * 64, h, q0, b);
    }
    bulk_load(ld_s + s * BM * 2,
              ld + (((size_t)b * H + h) * fb_rows(Sq) + q0) * 2,
              (uint32_t)L::LD, full + s);
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrive per consumer warpgroup
    }
    mbar_fence_init();
    // K and V once, and the first ST - 1 tiles
    mbar_expect_tx(kv_full, (uint32_t)(2 * L::KV));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(k_s + nb * BN * 128, &tm_k, kv_full, nb * 64, hk, k0, b);
      tma_load_4d(v_s + nb * BN * 128, &tm_v, kv_full, nb * 64, hk, k0, b);
    }
    for (int n = 0; n < min(ST - 1, n_items); ++n) issue(n);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int kw0 = SPLIT ? k0 : k0 + cw * 64;  // this warpgroup's 64 keys
  const int key_row = kw0 + warp * 16 + lane / 4;  // and + 8
  const uint32_t kv_off = SPLIT ? 0 : cw * 64 * 128;
  const uint32_t k_addr = sals_smem(k_s) + kv_off;
  const uint32_t v_addr = sals_smem(v_s) + kv_off;
  // keys that every query sees (all in the prefix), keys that only the
  // diagonal limits (all past it)
  const bool in_prefix = kw0 + 64 <= prefix_len;
  const bool past_prefix = kw0 >= prefix_len;

  // pair: acc0 = dV, acc1 = dK; split: acc0 = dV (warpgroup 0) or dK (1)
  float acc0[DH / 2], acc1[SPLIT ? 1 : DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? 1 : DH / 2); ++i) acc1[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % ST;
    const int q0 = (qt_first + it % n_qt) * BM;
    const uint32_t q_addr = sals_smem(q_s + s * L::QT);
    const uint32_t do_addr = sals_smem(do_s + s * L::QT);
    const float* lds = ld_s + s * BM * 2;
    // a tile wholly past this warpgroup's keys' diagonal (pair only: the
    // split body's first tile holds key k0's diagonal)
    const bool dead =
        !SPLIT && causal && past_prefix && kw0 > q_off + q0 + BM - 1;
    const bool need_mask = q0 + BM > Sq || kw0 + 64 > Sk ||
                           (causal && !in_prefix && kw0 + 63 > q_off + q0);
    mbar_wait(full + s, (it / ST) & 1);
    if (!dead) {
      if constexpr (!SPLIT) {
        // S^T = K Q^T and dP^T = V dO^T (64 keys x BM queries), two groups
        float st[BM / 2], dpt[BM / 2];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
        wgmma_hold<BM / 2>(st);
        wgmma_hold<BM / 2>(dpt);
        wgmma_fence();
        fb_ss<DH, BM>(st, k_addr, BN, q_addr);
        wgmma_commit();
        fb_ss<DH, BM>(dpt, v_addr, BN, do_addr);
        wgmma_commit();
        if (threadIdx.x == 0 && it + ST - 1 < n_items) issue(it + ST - 1);
        __syncwarp();
        // P^T while dP^T runs (under softcap, with dS^T once both are done)
        if constexpr (SC) {
          wgmma_wait<0>();
          wgmma_hold<BM / 2>(dpt);
        } else {
          wgmma_wait<1>();
        }
        wgmma_hold<BM / 2>(st);
        uint32_t pa[BM / 16][4], sa[BM / 16][4];
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            // {LSE2, D} of queries 8j + 2quad and + 1
            const float4 c =
                *reinterpret_cast<const float4*>(lds + 2 * (8 * j + 2 * quad));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float dt;
              float p = fb_prob<SC>(st[4 * j + e], (e & 1) ? c.z : c.x, ks,
                                    dt);
              if (need_mask &&
                  !fb_visible(key_row + 8 * (e >> 1),
                              q0 + 8 * j + 2 * quad + (e & 1), Sq, Sk, q_off,
                              causal, prefix_len))
                p = 0.f;
              if constexpr (SC)
                dpt[4 * j + e] =
                    p * (dpt[4 * j + e] - ((e & 1) ? c.w : c.y)) * dt *
                    ks.scale;
              st[4 * j + e] = p;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = fb_pack(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
        }
        // dV += P^T dO (dO read MN-major), while dS^T is formed
        wgmma_hold<DH / 2>(acc0);
        wgmma_fence();
        fb_rs<DH, BM>(acc0, pa, do_addr);
        wgmma_commit();
        if constexpr (!SC) {
          wgmma_wait<1>();
          wgmma_hold<BM / 2>(dpt);
#pragma unroll
          for (int j = 0; j < BM / 8; ++j) {
            const float4 c =
                *reinterpret_cast<const float4*>(lds + 2 * (8 * j + 2 * quad));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e] *
                               (dpt[4 * j + e] - ((e & 1) ? c.w : c.y)) *
                               ks.scale;
          }
        }
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sa[kk][e] = fb_pack(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        // dK += dS^T Q (Q read MN-major)
        wgmma_hold<DH / 2>(acc1);
        wgmma_fence();
        fb_rs<DH, BM>(acc1, sa, q_addr);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold<DH / 2>(acc0);
        wgmma_hold<DH / 2>(acc1);
      } else {
        // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (one call
        // site: wgmmas issued on a branch are serialized by ptxas, C7520)
        float sc[BM / 2];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) sc[i] = 0.f;
        wgmma_hold<BM / 2>(sc);
        wgmma_fence();
        fb_ss<DH, BM>(sc, cw == 0 ? k_addr : v_addr, BN,
                      cw == 0 ? q_addr : do_addr);
        wgmma_commit();
        if (threadIdx.x == 0 && it + ST - 1 < n_items) issue(it + ST - 1);
        __syncwarp();
        wgmma_wait<0>();
        wgmma_hold<BM / 2>(sc);
        uint32_t fr[BM / 16][4];
        if (cw == 0) {
          // P^T: its bf16 fragments stay here for dV; P^T (1 - t^2) goes
          // to warpgroup 1 through x_s, once it has read the last one
          if (it > 0) named_bar_sync(FB_BAR_EMPTY, 256);
#pragma unroll
          for (int j = 0; j < BM / 8; ++j) {
            const float4 c =
                *reinterpret_cast<const float4*>(lds + 2 * (8 * j + 2 * quad));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float dt;
              float p = fb_prob<SC>(sc[4 * j + e], (e & 1) ? c.z : c.x, ks,
                                    dt);
              if (need_mask &&
                  !fb_visible(key_row + 8 * (e >> 1),
                              q0 + 8 * j + 2 * quad + (e & 1), Sq, Sk, q_off,
                              causal, prefix_len))
                p = 0.f;
              x_s[(4 * j + e) * 128 + tid] = p * dt;
              sc[4 * j + e] = p;
            }
          }
          named_bar_arrive(FB_BAR_FULL, 256);
        } else {
          named_bar_sync(FB_BAR_FULL, 256);
#pragma unroll
          for (int j = 0; j < BM / 8; ++j) {
            const float4 c =
                *reinterpret_cast<const float4*>(lds + 2 * (8 * j + 2 * quad));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = x_s[(4 * j + e) * 128 + tid] *
                              (sc[4 * j + e] - ((e & 1) ? c.w : c.y)) *
                              ks.scale;
          }
          if (it + 1 < n_items) named_bar_arrive(FB_BAR_EMPTY, 256);
        }
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fr[kk][e] = fb_pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
        wgmma_hold<DH / 2>(acc0);
        wgmma_fence();
        fb_rs<DH, BM>(acc0, fr, cw == 0 ? do_addr : q_addr);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold<DH / 2>(acc0);
      }
    }
    else if (threadIdx.x == 0 && it + ST - 1 < n_items)
      issue(it + ST - 1);
    __syncwarp();
    if (tid == 0) mbar_arrive(empty + s);
  }

  // dK and dV in bf16, rows past Sk dropped
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = key_row + 8 * half;
    if (kp >= Sk) continue;
    const size_t row = (((size_t)b * Sk + kp) * Hkv + hk) * DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          acc0[4 * j + 2 * half], acc0[4 * j + 2 * half + 1]);
      if constexpr (SPLIT) {
        *reinterpret_cast<__nv_bfloat162*>((cw == 0 ? dv : dk) + row +
                                           8 * j) = x;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j) = x;
        *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j) =
            __floats2bfloat162_rn(acc1[4 * j + 2 * half],
                                  acc1[4 * j + 2 * half + 1]);
      }
    }
  }
}

template <int DH, bool SC>
__global__ void __launch_bounds__(FbQ<DH>::THREADS, 1) fb_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ ld,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
    int causal, int prefix_len, FbScale ks) {
  using L = FbQ<DH>;
  constexpr int BM = L::BM, BN = L::BN, NB = L::TDH / 64, NWG = L::NWG;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = fb_align1024(smem_raw);
  unsigned char* do_s = q_s + L::QT;
  unsigned char* k_s = do_s + L::QT;  // ST tiles each
  unsigned char* v_s = k_s + ST * L::KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + ST * L::KV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BM;
  const int q_off = Sk - Sq;
  // causal: keys up to the block's last row, and the whole prefix
  const int kv_end =
      causal ? min(Sk, max(q_off + q0 + BM, prefix_len)) : Sk;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;

  // K / V tile n into stage n % ST, once every consumer warpgroup is done
  // with tile n - ST (the producer, or else thread 0)
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto issue = [&](int n) {
    const int s = n % ST;
    mbar_wait(empty + s, ((n / ST) & 1) ^ 1);
    mbar_expect_tx(full + s, (uint32_t)(2 * L::KV));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(k_s + s * L::KV + nb * BN * 128, map_k, full + s, nb * 64,
                  hk, n * BN, b);
      tma_load_4d(v_s + s * L::KV + nb * BN * 128, map_v, full + s, nb * 64,
                  hk, n * BN, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG);
    }
    mbar_fence_init();
    // Q and dO once
    mbar_expect_tx(q_full, (uint32_t)(2 * L::QT));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(q_s + nb * BM * 128, &tm_q, q_full, nb * 64, h, q0, b);
      tma_load_4d(do_s + nb * BM * 128, &tm_do, q_full, nb * 64, h, q0, b);
    }
    if constexpr (!L::PRODUCER)
      for (int n = 0; n < min(ST - 1, n_tiles); ++n) issue(n);
  }
  __syncthreads();

  if constexpr (L::PRODUCER) {
    if (cw == NWG) {
      // ---- producer warpgroup: the K / V ring ----
      if (tid == 0)
        for (int n = 0; n < n_tiles; ++n) issue(n);
      return;
    }
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;  // and + 8
  const int wg_qp_lo = q_off + q0 + cw * 64;  // the warpgroup's positions
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 c = reinterpret_cast<const float2*>(
        ld)[(size_t)bh * fb_rows(Sq) + row0 + 8 * i];
    lse2[i] = c.x;
    dd[i] = c.y;
  }
  const uint32_t q_addr = sals_smem(q_s) + cw * 64 * 128;
  const uint32_t do_addr = sals_smem(do_s) + cw * 64 * 128;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  uint32_t fr[BN / 16][4];
  // the stage whose K the last dQ chain still reads: released once that
  // chain is done, while the next tile's S and dP run
  int pending = -1;
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST;
    const int k0 = t * BN;
    const uint32_t k_addr = sals_smem(k_s + s * L::KV);
    const uint32_t v_addr = sals_smem(v_s + s * L::KV);
    // a tile wholly past this warpgroup's diagonal and outside the prefix
    const bool dead = causal && k0 >= prefix_len && k0 > wg_qp_lo + 63;
    const bool need_mask =
        k0 + BN > Sk || q0 + cw * 64 + 64 > Sq ||
        (causal && k0 + BN - 1 > wg_qp_lo && k0 + BN > prefix_len);
    mbar_wait(full + s, (t / ST) & 1);
    float sc[BN / 2], dp[BN / 2];
    if (!dead) {
      // S = Q K^T and dP = dO V^T (64 queries x BN keys), two groups
      // behind the last tile's dQ chain
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_hold<BN / 2>(sc);
      wgmma_hold<BN / 2>(dp);
      wgmma_fence();
      fb_ss<DH, BN>(sc, q_addr, BM, k_addr);
      wgmma_commit();
      fb_ss<DH, BN>(dp, do_addr, BM, v_addr);
      wgmma_commit();
      if constexpr (SC) {
        wgmma_wait<0>();
        wgmma_hold<BN / 2>(dp);
      } else {
        wgmma_wait<1>();
      }
      wgmma_hold<BN / 2>(sc);
    } else {
      wgmma_wait<0>();
    }
    // the last dQ chain is done: release its stage (and a dead tile's),
    // then refill the stage of tile t - 1 with tile t + ST - 1
    if (tid == 0) {
      if (pending >= 0) mbar_arrive(empty + pending);
      if (dead) mbar_arrive(empty + s);
    }
    pending = -1;
    if constexpr (!L::PRODUCER) {
      if (threadIdx.x == 0 && t + ST - 1 < n_tiles) issue(t + ST - 1);
      __syncwarp();
    }
    if (dead) continue;
    // P while dP runs, then dS, packed to bf16 A fragments
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float dt;
        float p = fb_prob<SC>(sc[4 * j + e], lse2[i], ks, dt);
        if (need_mask && !fb_visible(k0 + 8 * j + 2 * quad + (e & 1),
                                     row0 + 8 * i, Sq, Sk, q_off, causal,
                                     prefix_len))
          p = 0.f;
        if constexpr (SC)
          sc[4 * j + e] = p * (dp[4 * j + e] - dd[i]) * dt * ks.scale;
        else
          sc[4 * j + e] = p;
      }
    }
    if constexpr (!SC) {
      wgmma_wait<0>();
      wgmma_hold<BN / 2>(dp);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dd[e >> 1]) *
                          ks.scale;
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fr[kk][e] = fb_pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    // dQ += dS K (K read MN-major), left running into the next tile
    wgmma_hold<DH / 2>(acc);
    wgmma_fence();
    fb_rs<DH, BN>(acc, fr, k_addr);
    wgmma_commit();
    pending = s;
  }
  wgmma_wait<0>();
  wgmma_hold<DH / 2>(acc);
  if (pending >= 0 && tid == 0) mbar_arrive(empty + pending);

  // dQ in bf16, rows past Sq dropped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + (((size_t)b * Sq + row) * H + h) * DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int DH, bool SC>
static int launch_fb_sc(const CUtensorMap* maps, const void* o,
                        const float* lse, const void* dout, void* dq,
                        void* dk, void* dv, float* ld, int B, int Sq, int Sk,
                        int H, int Hkv, int causal, int prefix_len,
                        FbScale ks, cudaStream_t st) {
  using bf = __nv_bfloat16;
  using KV = FbKV<DH>;
  using Q = FbQ<DH>;
  const size_t n_rows = (size_t)B * H * fb_rows(Sq);
  fb_dot_kernel<DH><<<(unsigned)((n_rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse,
      reinterpret_cast<float2*>(ld), B, Sq, H);
  int err = (int)cudaGetLastError();
  if (err) return err;

  cudaFuncSetAttribute(fb_dkdv_kernel<DH, SC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)KV::BYTES);
  dim3 grid_kv(B * Hkv, (Sk + KV::BN - 1) / KV::BN);
  fb_dkdv_kernel<DH, SC><<<grid_kv, KV::THREADS, KV::BYTES, st>>>(
      maps[0], maps[1], maps[2], maps[3], ld, static_cast<bf*>(dk),
      static_cast<bf*>(dv), Sq, Sk, H, Hkv, causal, prefix_len, ks);
  err = (int)cudaGetLastError();
  if (err) return err;

  cudaFuncSetAttribute(fb_dq_kernel<DH, SC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Q::BYTES);
  dim3 grid_q(B * H, (Sq + Q::BM - 1) / Q::BM);
  fb_dq_kernel<DH, SC><<<grid_q, Q::THREADS, Q::BYTES, st>>>(
      maps[4], maps[5], maps[6], maps[7], ld, static_cast<bf*>(dq), Sq, Sk,
      H, Hkv, causal, prefix_len, ks);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_fb(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* ld, int B, int Sq, int Sk, int H, int Hkv,
              int causal, int prefix_len, float softcap, cudaStream_t st) {
  using KV = FbKV<DH>;
  using Q = FbQ<DH>;
  // tensor maps: the dK/dV kernel's (q, k, v, do) with boxes of BM query
  // and BN key rows, then the dQ kernel's with its own
  CUtensorMap maps[8];
  const void* src[8] = {q, k, v, dout, q, k, v, dout};
  const int rows[8] = {KV::BM, KV::BN, KV::BN, KV::BM,
                       Q::BM,  Q::BN,  Q::BN,  Q::BM};
  for (int i = 0; i < 8; ++i) {
    const bool kv = i % 4 == 1 || i % 4 == 2;
    const int err = sals_tmap_bshd(&maps[i], src[i], B, kv ? Sk : Sq,
                                   kv ? Hkv : H, DH, rows[i]);
    if (err) return err;
  }
  const float scale = (float)(1.0 / sqrt((double)DH));
  const float LOG2E = 1.4426950408889634f;
  FbScale ks{scale, scale * LOG2E, 0.f, 0.f};
  if (softcap != 0.f) {
    ks.tc = scale / softcap;
    ks.cap2 = softcap * LOG2E;
    return launch_fb_sc<DH, true>(maps, o, lse, dout, dq, dk, dv, ld, B, Sq,
                                  Sk, H, Hkv, causal, prefix_len, ks, st);
  }
  return launch_fb_sc<DH, false>(maps, o, lse, dout, dq, dk, dv, ld, B, Sq,
                                 Sk, H, Hkv, causal, prefix_len, ks, st);
}
