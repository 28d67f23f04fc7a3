// Selected-token decode attention over the raw latent cache (SALS stages
// 3-4), Hopper port of
// repro/kernels/sparse_recon_attention.py::sparse_recon_attention_pallas
// and (PAGED = true) ::sparse_recon_attention_paged_pallas, and of their
// speculative verify-window forms ::sparse_recon_attention_window_pallas and
// ::sparse_recon_attention_window_paged_pallas.
//
// Grid (B, n_kv): one block per (batch row, kv head), so no reduction
// crosses blocks.  The block walks the N_c selected slots in the order it
// is given (ascending positions, invalid slots last), T = 32 slots at a
// time:
//   1. gather each slot's latent row (x the int8 per-token scale) into
//      shared memory (indices clamped into [0, S)), one slot per lane with
//      32-byte loads so a warp keeps many rows in flight;
//   2. reconstruct the head's dh key channels k[d] = sum_j lat[j] U[h*dh+d, j]
//      for the whole tile at once: U is streamed through shared memory in
//      32-column chunks (the next chunk prefetched into registers) and
//      every thread keeps SPT slot accumulators in registers, so U is read
//      once per tile instead of once per slot;
//   3. RoPE at pos_base + idx, pairs (d, d + dh/2) exchanged through shared
//      memory;
//   4. score the `group` query heads of each of the `ql` window queries
//      (query t RoPE'd once at q_pos + t), scale by dh^-1/2, softcap,
//      NEG_INF where `valid` is false or, with n_recent > 0, where the
//      slot's position exceeds q_pos + t - n_recent (the per-query mask
//      advance of a verify window);
//   5. dequantize the head's value channels (int8 +128, or int4 byte c/2
//      with the low nibble for even c; group c / v_group);
//   6. update ql * group * dh f32 online-softmax cells (kept in shared
//      memory, each owned by one thread) slot by slot, in the given order.
// Outputs the unnormalized partials m, l (B, ql, H) and o (B, ql, H, dh),
// f32.  Each selected key is reconstructed once for the whole window.
//
// One body serves both: the single-token entry points are its ql = 1,
// n_recent = 0 launch, so a one-query window equals the single-token
// kernel bit for bit, and query t of a window equals the single-token
// kernel at q_pos + t on the gated set (a gated slot is an exact no-op of
// the online softmax: p = 0, alpha = expf(0) = 1).
//
// Paged layout: every cache operand is a pool (n_pages, ps, ·) and the
// selected logical position p (clamped into [0, S), S = mp * ps) lives at
// pool row pt[b, p / ps] * ps + p % ps, the page id clamped into the pool.
// Each slot's physical row is resolved once, when the tile is loaded; the
// gather, the scale and the value reads use it and RoPE uses the logical
// position, so dense and paged share every arithmetic line and agree bit
// for bit on the same logical contents.  Sorted indices keep a tile's rows
// on few pages.
//
// Bound: the reconstruction is 2*B*N_c*kv_dim*r FLOP (14.5 GFLOP at the
// llama2-7b slice shapes) whatever the window length, plus ql times the
// scoring; it bounds the kernel on the tensor cores.  This first version
// runs it on the CUDA cores in f32 (a wgmma tile of selected tokens is the
// later redesign).
#include "common.cuh"

#include <math.h>

constexpr int SRA_THREADS = 512;
constexpr int SRA_T = 32;   // selected slots per tile
constexpr int SRA_JT = 32;  // U columns per shared-memory chunk
constexpr int SRA_LAT_LD = SRA_T + 4;  // lat_s row pitch (floats)
constexpr int SRA_MAX_QL = 8;          // longest verify window

// Where row b's logical cache position p lives (pages: see the header).
struct SraLayout {
  const int* page_table;  // (B, mp) int32, or null for the dense arena
  int mp, ps, n_pages;
};

template <bool PAGED>
__device__ __forceinline__ int sra_row(const SraLayout& lay, int b, int S,
                                       int p) {
  if (!PAGED) return b * S + p;
  const int pg = min(max(lay.page_table[(size_t)b * lay.mp + p / lay.ps], 0),
                     lay.n_pages - 1);
  return pg * lay.ps + p % lay.ps;
}

template <typename TK, int VBITS, int DH, bool PAGED>
__global__ void __launch_bounds__(SRA_THREADS) sra_kernel(
    const void* __restrict__ q, int q_dtype, const TK* __restrict__ k_lat,
    const __nv_bfloat16* __restrict__ k_scale,
    const uint8_t* __restrict__ v_q, const __nv_bfloat16* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ v_zero, const void* __restrict__ u,
    int u_dtype, const int* __restrict__ idx,
    const uint8_t* __restrict__ valid, const int* __restrict__ q_pos,
    const int* __restrict__ pos_base, const float* __restrict__ freqs,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ o_out, int ql, int H, int n_kv, int S, int r,
    int code_w, int G, int v_group, int n_c, int n_recent, float softcap,
    int use_rope, int lat_vec, int u_vec, SraLayout lay) {
  constexpr int N_SG = SRA_THREADS / DH;  // slot groups
  constexpr int SPT = SRA_T / N_SG;       // slots per thread
  constexpr int HALF = DH / 2;
  static_assert(SRA_THREADS % DH == 0 && SRA_T % N_SG == 0 && SPT % 4 == 0,
                "tile shape");
  static_assert(SRA_T == 32, "the gather maps one slot to each lane");
  const int group = H / n_kv;
  const int nq = ql * group;  // (window query, head) pairs of this block
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = SRA_THREADS / 32;
  const float scale = (float)(1.0 / sqrt((double)DH));

  extern __shared__ __align__(16) float smem[];
  float* lat_s = smem;                               // r x LAT_LD
  float* u_s = lat_s + (size_t)r * SRA_LAT_LD;       // DH x (JT+1)
  float* k_s = u_s + DH * (SRA_JT + 1);              // T x DH
  float* v_s = k_s + SRA_T * DH;                     // T x DH
  float* q_s = v_s + SRA_T * DH;                     // nq x DH
  float* lg_s = q_s + nq * DH;                       // T x nq
  float* m_s = lg_s + SRA_T * nq;                    // nq*DH softmax cells
  float* l_s = m_s + nq * DH;
  float* o_s = l_s + nq * DH;
  int* row_s = reinterpret_cast<int*>(o_s + nq * DH);  // T
  int* ok_s = row_s + SRA_T;                                    // T
  float* sc_s = reinterpret_cast<float*>(ok_s + SRA_T);         // T
  int* prow_s = reinterpret_cast<int*>(sc_s + SRA_T);  // T physical rows

  // RoPE'd query heads of this kv group for every window query t (row
  // qg = t * group + gi), once (rounded to q's dtype as the reference's
  // oracle does)
  for (int e = tid; e < nq * DH; e += SRA_THREADS) {
    const int qg = e / DH, d = e % DH;
    const int t = qg / group, gi = qg % group;
    q_s[e] = sals_load(q, q_dtype,
                       (((size_t)b * ql + t) * H + h * group + gi) * DH + d);
  }
  __syncthreads();
  if (use_rope) {
    for (int e = tid; e < nq * HALF; e += SRA_THREADS) {
      const int qg = e / HALF, d = e % HALF;
      const float qp = (float)(q_pos[b] + qg / group);
      const float ang = qp * freqs[d];
      const float c = cosf(ang), s = sinf(ang);
      const float x1 = q_s[qg * DH + d], x2 = q_s[qg * DH + d + HALF];
      float y1 = x1 * c - x2 * s, y2 = x2 * c + x1 * s;
      if (q_dtype == SALS_BF16) {
        y1 = __bfloat162float(__float2bfloat16(y1));
        y2 = __bfloat162float(__float2bfloat16(y2));
      }
      q_s[qg * DH + d] = y1;
      q_s[qg * DH + d + HALF] = y2;
    }
  }

  // online-softmax state: cell (qg, d) belongs to thread cell % THREADS
  // alone, so no barrier guards it
  const int n_cells = nq * DH;
  for (int cell = tid; cell < n_cells; cell += SRA_THREADS) {
    m_s[cell] = SALS_NEG_INF;
    l_s[cell] = 0.f;
    o_s[cell] = 0.f;
  }
  const int base = pos_base[b];
  const int qpos = q_pos[b];
  const int d_own = tid % DH, sg = tid / DH;

  for (int t0 = 0; t0 < n_c; t0 += SRA_T) {
    const int count = min(SRA_T, n_c - t0);
    __syncthreads();  // previous tile fully consumed
    if (tid < SRA_T) {
      int row = 0, ok = 0;
      float sc = 0.f;
      if (tid < count) {
        row = idx[(size_t)b * n_c + t0 + tid];
        row = min(max(row, 0), S - 1);
        ok = valid[(size_t)b * n_c + t0 + tid] != 0;
      }
      const int prow = sra_row<PAGED>(lay, b, S, row);
      if (tid < count)
        sc = k_scale != nullptr ? __bfloat162float(k_scale[prow]) : 1.f;
      row_s[tid] = row;
      ok_s[tid] = ok;
      sc_s[tid] = sc;  // 0 for tail slots: their latent row is zero
      prow_s[tid] = prow;
    }
    __syncthreads();

    // 1. gather latents into lat_s[j][t]: lane = slot t, so the stores are
    //    conflict-free; each lane moves 32-byte chunks of its own row and a
    //    warp keeps several chunks in flight (x scale, 1, or 0 for tail
    //    slots)
    {
      constexpr int CH = 32 / sizeof(TK);
      const int t = lane;
      const TK* rowp = k_lat + (size_t)prow_s[t] * r;
      const float sc = sc_s[t];
      const int n_ch = lat_vec ? r / CH : 0;
#pragma unroll 4
      for (int c = warp; c < n_ch; c += nwarps) {
        const uint4 a0 = *reinterpret_cast<const uint4*>(rowp + c * CH);
        const uint4 a1 =
            *reinterpret_cast<const uint4*>(rowp + c * CH + CH / 2);
        const TK* e0 = reinterpret_cast<const TK*>(&a0);
        const TK* e1 = reinterpret_cast<const TK*>(&a1);
#pragma unroll
        for (int k = 0; k < CH / 2; ++k) {
          lat_s[(size_t)(c * CH + k) * SRA_LAT_LD + t] = sals_to_f(e0[k]) * sc;
          lat_s[(size_t)(c * CH + CH / 2 + k) * SRA_LAT_LD + t] =
              sals_to_f(e1[k]) * sc;
        }
      }
      for (int j = n_ch * CH + warp; j < r; j += nwarps)
        lat_s[(size_t)j * SRA_LAT_LD + t] = sals_to_f(rowp[j]) * sc;
    }

    // 2. reconstruct the tile: acc[i] = k[slot sg*SPT+i][d_own]
    float acc[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) acc[i] = 0.f;
    // U chunks of 32 columns: with bf16 U each thread holds one 16-byte
    // vector of the next chunk in registers while the current one is used
    constexpr int VPR_U = SRA_JT / 8;                 // vectors per U row
    constexpr int UPT = (DH * VPR_U + SRA_THREADS - 1) / SRA_THREADS;
    const __nv_bfloat16* ub = static_cast<const __nv_bfloat16*>(u);
    uint4 ureg[UPT];
    auto fetch_u = [&](int j0) {
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const int e = tid + i * SRA_THREADS;
        if (e < DH * VPR_U)
          ureg[i] = *reinterpret_cast<const uint4*>(
              ub + (size_t)(h * DH + e / VPR_U) * r + j0 + (e % VPR_U) * 8);
      }
    };
    if (u_vec) fetch_u(0);
    for (int j0 = 0; j0 < r; j0 += SRA_JT) {
      const int jn = min(SRA_JT, r - j0);
      __syncthreads();  // lat_s written / previous u_s chunk consumed
      if (u_vec) {
#pragma unroll
        for (int i = 0; i < UPT; ++i) {
          const int e = tid + i * SRA_THREADS;
          if (e < DH * VPR_U) {
            const __nv_bfloat16* v8 =
                reinterpret_cast<const __nv_bfloat16*>(&ureg[i]);
            float* dst = u_s + (e / VPR_U) * (SRA_JT + 1) + (e % VPR_U) * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) dst[k] = __bfloat162float(v8[k]);
          }
        }
        if (j0 + SRA_JT < r) fetch_u(j0 + SRA_JT);
      } else {
        for (int e = tid; e < DH * SRA_JT; e += SRA_THREADS) {
          const int d = e / SRA_JT, jj = e % SRA_JT;
          u_s[d * (SRA_JT + 1) + jj] =
              jj < jn ? sals_load(u, u_dtype,
                                  (size_t)(h * DH + d) * r + j0 + jj)
                      : 0.f;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        const float uv = u_s[d_own * (SRA_JT + 1) + jj];
        const float4* lp = reinterpret_cast<const float4*>(
            lat_s + (size_t)(j0 + jj) * SRA_LAT_LD + sg * SPT);
#pragma unroll
        for (int i4 = 0; i4 < SPT / 4; ++i4) {
          const float4 a = lp[i4];
          acc[4 * i4 + 0] += uv * a.x;
          acc[4 * i4 + 1] += uv * a.y;
          acc[4 * i4 + 2] += uv * a.z;
          acc[4 * i4 + 3] += uv * a.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i) k_s[(sg * SPT + i) * DH + d_own] = acc[i];
    __syncthreads();

    // 3. RoPE at the selected positions
    if (use_rope) {
      for (int e = tid; e < SRA_T * HALF; e += SRA_THREADS) {
        const int t = e / HALF, d = e % HALF;
        const float ang = (float)(base + row_s[t]) * freqs[d];
        const float c = cosf(ang), s = sinf(ang);
        const float x1 = k_s[t * DH + d], x2 = k_s[t * DH + d + HALF];
        k_s[t * DH + d] = x1 * c - x2 * s;
        k_s[t * DH + d + HALF] = x2 * c + x1 * s;
      }
    }
    // 5. dequantize this head's value channels
    for (int e = tid; e < SRA_T * DH; e += SRA_THREADS) {
      const int t = e / DH, c = e % DH;
      const int cg = h * DH + c;
      const size_t rowo = (size_t)prow_s[t];
      float code;
      if (VBITS == 4) {
        const uint8_t byte = v_q[rowo * code_w + (cg >> 1)];
        code = (float)((cg & 1) ? (byte >> 4) : (byte & 0x0F));
      } else {
        code = (float)(int8_t)v_q[rowo * code_w + cg] + 128.f;
      }
      const int g = cg / v_group;
      const float sv = __bfloat162float(v_scale[rowo * G + g]);
      const float zv = __bfloat162float(v_zero[rowo * G + g]);
      v_s[e] = __fadd_rn(__fmul_rn(code, sv), zv);
    }
    __syncthreads();

    // 4. logits of every (window query, head), one warp per (slot, query,
    //    head); query t sees the slot only if its position is at most
    //    q_pos + t - n_recent (n_recent = 0: no gate)
    for (int p = warp; p < count * nq; p += nwarps) {
      const int t = p / nq, qg = p % nq;
      float a = 0.f;
      for (int d = lane; d < DH; d += 32) a += q_s[qg * DH + d] * k_s[t * DH + d];
      a = sals_warp_sum(a);
      if (lane == 0) {
        float x = a * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const bool seen = n_recent == 0 ||
                          base + row_s[t] <= qpos + qg / group - n_recent;
        lg_s[t * nq + qg] = ok_s[t] && seen ? x : SALS_NEG_INF;
      }
    }
    __syncthreads();

    // 6. online softmax, slot by slot in the given order
    for (int cell = tid; cell < n_cells; cell += SRA_THREADS) {
      const int qg = cell / DH, d = cell % DH;
      float m = m_s[cell], l = l_s[cell], o = o_s[cell];
      for (int t = 0; t < count; ++t) {
        const float x = lg_s[t * nq + qg];
        const float m_new = fmaxf(m, x);
        const float p = x <= SALS_NEG_INF * 0.5f ? 0.f : expf(x - m_new);
        const float alpha = expf(m - m_new);
        l = l * alpha + p;
        o = o * alpha + p * v_s[t * DH + d];
        m = m_new;
      }
      m_s[cell] = m;
      l_s[cell] = l;
      o_s[cell] = o;
    }
  }

  for (int cell = tid; cell < n_cells; cell += SRA_THREADS) {
    const int qg = cell / DH, d = cell % DH;
    const int t = qg / group, gi = qg % group;
    const size_t hq = ((size_t)b * ql + t) * H + h * group + gi;
    o_out[hq * DH + d] = o_s[cell];
    if (d == 0) {
      m_out[hq] = m_s[cell];
      l_out[hq] = l_s[cell];
    }
  }
}

size_t sra_smem_bytes(int r, int dh, int group, int ql) {
  const size_t nq = (size_t)ql * group;
  return sizeof(float) * ((size_t)r * SRA_LAT_LD + dh * (SRA_JT + 1) +
                          2 * SRA_T * dh + nq * dh + SRA_T * nq +
                          3 * nq * dh + SRA_T) +
         3 * sizeof(int) * SRA_T;
}

// Everything one launch needs, as the C entry points receive it.
struct SraCall {
  const void *q, *k_lat, *k_scale, *v_q, *v_scale, *v_zero, *u, *idx,
      *valid, *q_pos, *pos_base, *freqs;
  void *m, *l, *o;
  int q_dtype, u_dtype, B, ql, H, n_kv, S, r, code_w, G, v_group, n_c,
      n_recent, use_rope;
  float softcap;
  SraLayout lay;
};

template <typename TK, int VBITS, int DH, bool PAGED>
static int launch_sra(const SraCall& c, cudaStream_t stream) {
  const size_t smem = sra_smem_bytes(c.r, DH, c.H / c.n_kv, c.ql);
  // 16-byte vector paths need aligned rows (and whole U chunks)
  const int lat_vec = (reinterpret_cast<uintptr_t>(c.k_lat) % 16 == 0) &&
                      ((size_t)c.r * sizeof(TK)) % 16 == 0;
  const int u_vec = c.u_dtype == SALS_BF16 &&
                    reinterpret_cast<uintptr_t>(c.u) % 16 == 0 &&
                    c.r % SRA_JT == 0;
  cudaFuncSetAttribute(sra_kernel<TK, VBITS, DH, PAGED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(c.B, c.n_kv);
  sra_kernel<TK, VBITS, DH, PAGED><<<grid, SRA_THREADS, smem, stream>>>(
      c.q, c.q_dtype, static_cast<const TK*>(c.k_lat),
      static_cast<const __nv_bfloat16*>(c.k_scale),
      static_cast<const uint8_t*>(c.v_q),
      static_cast<const __nv_bfloat16*>(c.v_scale),
      static_cast<const __nv_bfloat16*>(c.v_zero), c.u, c.u_dtype,
      static_cast<const int*>(c.idx), static_cast<const uint8_t*>(c.valid),
      static_cast<const int*>(c.q_pos), static_cast<const int*>(c.pos_base),
      static_cast<const float*>(c.freqs), static_cast<float*>(c.m),
      static_cast<float*>(c.l), static_cast<float*>(c.o), c.ql, c.H, c.n_kv,
      c.S, c.r, c.code_w, c.G, c.v_group, c.n_c, c.n_recent, c.softcap,
      c.use_rope, lat_vec, u_vec, c.lay);
  return (int)cudaGetLastError();
}

template <typename TK, int VBITS, bool PAGED>
static int dispatch_dh(int dh, const SraCall& c, cudaStream_t st) {
  if (dh == 128) return launch_sra<TK, VBITS, 128, PAGED>(c, st);
  if (dh == 64) return launch_sra<TK, VBITS, 64, PAGED>(c, st);
  return (int)cudaErrorInvalidValue;
}

template <bool PAGED>
static int dispatch_sra(const SraCall& c, int k_dtype, int v_bits, int dh,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_bits != 8 && v_bits != 4) return (int)cudaErrorInvalidValue;
  if (c.ql < 1 || c.ql > SRA_MAX_QL || c.n_recent < 0)
    return (int)cudaErrorInvalidValue;
  const bool v4 = v_bits == 4;
  switch (k_dtype) {
    case SALS_F32:
      return v4 ? dispatch_dh<float, 4, PAGED>(dh, c, st)
                : dispatch_dh<float, 8, PAGED>(dh, c, st);
    case SALS_BF16:
      return v4 ? dispatch_dh<__nv_bfloat16, 4, PAGED>(dh, c, st)
                : dispatch_dh<__nv_bfloat16, 8, PAGED>(dh, c, st);
    case SALS_I8:
      return v4 ? dispatch_dh<int8_t, 4, PAGED>(dh, c, st)
                : dispatch_dh<int8_t, 8, PAGED>(dh, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

static SraLayout paged_layout(const void* page_table, int S, int mp, int ps,
                              int n_pages, bool* ok) {
  *ok = mp >= 1 && ps >= 1 && n_pages >= 1 && S == mp * ps;
  return SraLayout{static_cast<const int*>(page_table), mp, ps, n_pages};
}

// Single-token decode: q (B, H, dh); m, l (B, H), o (B, H, dh).  The
// ql = 1, n_recent = 0 launch of the window body.
extern "C" int sals_sparse_recon_attention(
    const void* q, int q_dtype, const void* k_lat, int k_dtype,
    const void* k_scale, const void* v_q, int v_bits, const void* v_scale,
    const void* v_zero, const void* u, int u_dtype, const void* idx,
    const void* valid, const void* q_pos, const void* pos_base,
    const void* freqs, void* m, void* l, void* o, int B, int H, int n_kv,
    int dh, int S, int r, int code_w, int G, int v_group, int n_c,
    float softcap, int use_rope, void* stream) {
  const SraCall c{q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid,
                  q_pos, pos_base, freqs, m, l, o, q_dtype, u_dtype, B, 1,
                  H, n_kv, S, r, code_w, G, v_group, n_c, 0, use_rope,
                  softcap, SraLayout{nullptr, 0, 0, 0}};
  return dispatch_sra<false>(c, k_dtype, v_bits, dh, stream);
}

// Paged: k_lat (n_pages, ps, r), k_scale (n_pages, ps), v_q (n_pages, ps,
// code_w), v_scale / v_zero (n_pages, ps, G) pools, page_table (B, mp)
// int32; S = mp * ps is the logical extent and idx stays logical.
extern "C" int sals_sparse_recon_attention_paged(
    const void* q, int q_dtype, const void* k_lat, int k_dtype,
    const void* k_scale, const void* v_q, int v_bits, const void* v_scale,
    const void* v_zero, const void* u, int u_dtype, const void* idx,
    const void* valid, const void* q_pos, const void* pos_base,
    const void* freqs, const void* page_table, void* m, void* l, void* o,
    int B, int H, int n_kv, int dh, int S, int r, int code_w, int G,
    int v_group, int n_c, float softcap, int use_rope, int mp, int ps,
    int n_pages, void* stream) {
  bool ok;
  const SraLayout lay = paged_layout(page_table, S, mp, ps, n_pages, &ok);
  if (!ok) return (int)cudaErrorInvalidValue;
  const SraCall c{q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid,
                  q_pos, pos_base, freqs, m, l, o, q_dtype, u_dtype, B, 1,
                  H, n_kv, S, r, code_w, G, v_group, n_c, 0, use_rope,
                  softcap, lay};
  return dispatch_sra<true>(c, k_dtype, v_bits, dh, stream);
}

// Verify window: q (B, ql, H, dh), query t RoPE'd at q_pos + t and (with
// n_recent > 0) gated to positions <= q_pos + t - n_recent; m, l (B, ql,
// H), o (B, ql, H, dh).  1 <= ql <= 8.
extern "C" int sals_sparse_recon_attention_window(
    const void* q, int q_dtype, const void* k_lat, int k_dtype,
    const void* k_scale, const void* v_q, int v_bits, const void* v_scale,
    const void* v_zero, const void* u, int u_dtype, const void* idx,
    const void* valid, const void* q_pos, const void* pos_base,
    const void* freqs, void* m, void* l, void* o, int B, int ql, int H,
    int n_kv, int dh, int S, int r, int code_w, int G, int v_group, int n_c,
    int n_recent, float softcap, int use_rope, void* stream) {
  const SraCall c{q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid,
                  q_pos, pos_base, freqs, m, l, o, q_dtype, u_dtype, B, ql,
                  H, n_kv, S, r, code_w, G, v_group, n_c, n_recent, use_rope,
                  softcap, SraLayout{nullptr, 0, 0, 0}};
  return dispatch_sra<false>(c, k_dtype, v_bits, dh, stream);
}

// Paged verify window: the window over page pools, as the paged entry.
extern "C" int sals_sparse_recon_attention_window_paged(
    const void* q, int q_dtype, const void* k_lat, int k_dtype,
    const void* k_scale, const void* v_q, int v_bits, const void* v_scale,
    const void* v_zero, const void* u, int u_dtype, const void* idx,
    const void* valid, const void* q_pos, const void* pos_base,
    const void* freqs, const void* page_table, void* m, void* l, void* o,
    int B, int ql, int H, int n_kv, int dh, int S, int r, int code_w, int G,
    int v_group, int n_c, int n_recent, float softcap, int use_rope, int mp,
    int ps, int n_pages, void* stream) {
  bool ok;
  const SraLayout lay = paged_layout(page_table, S, mp, ps, n_pages, &ok);
  if (!ok) return (int)cudaErrorInvalidValue;
  const SraCall c{q, k_lat, k_scale, v_q, v_scale, v_zero, u, idx, valid,
                  q_pos, pos_base, freqs, m, l, o, q_dtype, u_dtype, B, ql,
                  H, n_kv, S, r, code_w, G, v_group, n_c, n_recent, use_rope,
                  softcap, lay};
  return dispatch_sra<true>(c, k_dtype, v_bits, dh, stream);
}
