// Selected-token decode attention over the raw latent cache (SALS stages
// 3-4), Hopper port of
// repro/kernels/sparse_recon_attention.py::sparse_recon_attention_pallas
// and (PAGED = true) ::sparse_recon_attention_paged_pallas, and of their
// speculative verify-window forms ::sparse_recon_attention_window_pallas and
// ::sparse_recon_attention_window_paged_pallas.
//
// Bound: reconstructing the N_c selected keys is 2*B*N_c*kv_dim*r FLOP
// (14.5 GFLOP, 0.0147 ms on the bf16 tensor cores at the llama2-7b slice
// shapes) whatever the window length, plus ql times the scoring; the bytes
// (the gathered rows once, U_r once) are below that.
//
// Grid (B, n_kv): one block per (batch row, kv head), so no reduction
// crosses blocks.  The block walks the N_c selected slots in the order it
// is given (ascending positions, invalid slots last), 128 at a time (a
// pass), and outputs the unnormalized partials m, l (B, ql, H) and o (B,
// ql, H, dh), f32.  Each selected key is reconstructed once for the whole
// window.
//
// bf16 and int8 latents with a bf16 u (sra_kernel): the reconstruction
// runs on the tensor cores.  384 threads: a producer warpgroup and two consumer
// warpgroups of 64 slots each.
//   * The producer gathers each pass's latent rows (thread i = slot i) into
//     a ring of 64-column stages in the 128-byte-swizzled layout wgmma
//     reads: bf16 rows by cp.async (sm_90 TMA has no gather; slots past
//     N_c are zero-filled), int8 rows by plain loads converted to bf16
//     (exact, |code| <= 128).  Beside each latent stage it streams the
//     head's U_h chunk (dh x 64 of the plain (kv_dim, r) matrix) by TMA, so
//     U_h is read once per 128 slots (4 times for N_c = 432, against 14 in
//     the CUDA-core design).  It also resolves each slot's row (clamped
//     index; paged: through the page table) once, and gathers the head's
//     value codes of the pass by cp.async, double-buffered.
//   * Each consumer computes its 64 x dh key tile K = lat . U_h^T with
//     wgmma m64n{dh}k16 (f32 accumulate; bf16 products are exact in f32),
//     multiplies the int8 per-token scale into the accumulator rows, and
//     applies RoPE at pos_base + idx in registers (the pairs (d, d + dh/2)
//     sit in one thread).  It scores the ql * group window queries (query t
//     RoPE'd once at q_pos + t), scale dh^-1/2, softcap, NEG_INF where
//     `valid` is false or, with n_recent > 0, where the slot's position
//     exceeds q_pos + t - n_recent (the per-query mask advance of a verify
//     window).
//   * The two consumers then update one online softmax per (window query,
//     head) with the pass's 128 logits (max, exp and sum per query, one
//     warp each, in a fixed shuffle order) and the ql * group * dh output
//     cells (one thread per channel, o * alpha + sum_s p_s v_s in slot
//     order), dequantizing each value as it is used (int8 + 128, or int4
//     byte c/2 with the low nibble for even c; group c / v_group).
// f32 latents (sra_f32_kernel, the float32 exactness runs): the CUDA-core
// body of the first version, kept as it was: TF32 would round the latents
// to 10 bits and break those runs.  It reconstructs 32 slots at a time in
// f32 and updates the softmax slot by slot.  bf16 and int8 latents beside
// an f32 u (a float32 model with int8 latents) take the same body, as they
// did before the tensor-core one existed: it reads u as it is stored.
//
// One body serves the single token and the window: the single-token entry
// points are its ql = 1, n_recent = 0 launch, so a one-query window equals
// the single-token kernel bit for bit, and query t of a window equals the
// single-token kernel at q_pos + t on the gated set (a gated slot is an
// exact no-op: logit NEG_INF, p = 0, and a pass's max over the others).
//
// Paged layout: every cache operand is a pool (n_pages, ps, ·) and the
// selected logical position p (clamped into [0, S), S = mp * ps) lives at
// pool row pt[b, p / ps] * ps + p % ps, the page id clamped into the pool.
// Each slot's physical row is resolved once, when its pass is loaded; the
// gather, the scale and the value reads use it and RoPE uses the logical
// position, so dense and paged share every arithmetic line and agree bit
// for bit on the same logical contents.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

constexpr int SRA_MAX_QL = 8;  // longest verify window
constexpr int SRA_SMEM_LIMIT = 232448;

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

// ---------------------------------------------------------------------------
// bf16 / int8 latents: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int SRA_THREADS = 384;  // producer + two consumer warpgroups
constexpr int SRA_PASS = 128;     // selected slots per pass (64 a consumer)
constexpr int SRA_KC = 64;        // latent columns per ring stage
constexpr int SRA_MAX_STAGES = 6;

struct SraMeta {
  int row;   // clamped logical index
  int prow;  // cache row (paged: pool row)
  int ok;    // valid
  float sc;  // int8 per-token scale (1 for bf16, 0 past N_c)
};

// Value groups a run of dh channels can touch (scale / zero pairs staged
// per slot).
__host__ __device__ inline int sra_head_groups(int dh, int v_group) {
  return (dh - 1) / v_group + 2;
}

// Shared memory of one block (kernels/sparse_recon_attention.py mirrors
// it): as many 64-column ring stages (latent tile + U_h chunk) as fit, at
// most six, after the fixed part — value codes and their scale / zero
// pairs (two passes), the RoPE'd queries, the pass's logits / p, the
// output cells, m / l / alpha, slot metadata (two passes), the barriers.
struct SraTcLayout {
  int stages;
  size_t lat, u, stage, vcodes, vsz, q, p, o, stats, meta, bars, fixed,
      total;
};

__host__ __device__ inline SraTcLayout sra_tc_layout(int dh, int nq,
                                                     int v_bits,
                                                     int v_group) {
  SraTcLayout L;
  L.lat = (size_t)SRA_PASS * 128;
  L.u = (size_t)dh * 128;
  L.stage = L.lat + L.u;
  L.vcodes = (size_t)2 * SRA_PASS * (v_bits == 8 ? dh : dh / 2);
  L.vsz = ((size_t)2 * SRA_PASS * sra_head_groups(dh, v_group) * 4 + 15) /
          16 * 16;
  L.q = (size_t)nq * dh * 4;
  L.p = (size_t)nq * SRA_PASS * 4;
  L.o = (size_t)nq * dh * 4;
  L.stats = ((size_t)3 * nq * 4 + 15) / 16 * 16;
  L.meta = (size_t)2 * SRA_PASS * sizeof(SraMeta);
  L.bars = 8 * (2 * SRA_MAX_STAGES + 4);
  L.fixed =
      L.vcodes + L.vsz + L.q + L.p + L.o + L.stats + L.meta + L.bars;
  const long room = (long)SRA_SMEM_LIMIT - 1024 - (long)L.fixed;
  const long fit = room < 0 ? 0 : room / (long)L.stage;
  L.stages = (int)(fit < SRA_MAX_STAGES ? fit : SRA_MAX_STAGES);
  L.total = 1024 + L.stages * L.stage + L.fixed;
  return L;
}

__device__ __forceinline__ uint32_t sra_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename TK, int VBITS, int DH, bool PAGED>
__global__ void __launch_bounds__(SRA_THREADS, 1) sra_kernel(
    const __grid_constant__ CUtensorMap tm_u, const void* __restrict__ q,
    int q_dtype, const TK* __restrict__ k_lat,
    const __nv_bfloat16* __restrict__ k_scale,
    const uint8_t* __restrict__ v_q, const __nv_bfloat16* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ v_zero, const int* __restrict__ idx,
    const uint8_t* __restrict__ valid, const int* __restrict__ q_pos,
    const int* __restrict__ pos_base, const float* __restrict__ freqs,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ o_out, int ql, int H, int n_kv, int S, int r,
    int code_w, int G, int v_group, int n_c, int n_recent, float softcap,
    int use_rope, SraLayout lay) {
  static_assert(sizeof(TK) <= 2, "f32 latents take sra_f32_kernel");
  constexpr int HALF = DH / 2;
  constexpr int VROW = VBITS == 8 ? DH : DH / 2;  // code bytes a slot
  constexpr int NCON = 256;                       // consumer threads
  const int group = H / n_kv;
  const int nq = ql * group;  // (window query, head) pairs of this block
  const int b = blockIdx.x, h = blockIdx.y;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const SraTcLayout L = sra_tc_layout(DH, nq, VBITS, v_group);
  const int ngh = sra_head_groups(DH, v_group);  // staged pairs a slot
  const int g_lo = h * DH / v_group;             // first group of the head
  const int n_k = (r + SRA_KC - 1) / SRA_KC;
  const int n_pass = (n_c + SRA_PASS - 1) / SRA_PASS;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* vcodes = ring + L.stages * L.stage;
  // (scale, zero) of the head's groups, per slot of two passes
  __nv_bfloat162* vsz =
      reinterpret_cast<__nv_bfloat162*>(vcodes + L.vcodes);
  float* q_s = reinterpret_cast<float*>(vcodes + L.vcodes + L.vsz);
  float* p_s = q_s + (size_t)nq * DH;                        // nq x PASS
  float* o_s = p_s + (size_t)nq * SRA_PASS;                  // nq x DH
  float* m_s = o_s + (size_t)nq * DH;
  float* l_s = m_s + nq;
  float* a_s = l_s + nq;
  SraMeta* meta = reinterpret_cast<SraMeta*>(
      reinterpret_cast<unsigned char*>(m_s) + L.stats);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(meta) + L.meta);
  uint64_t* empty = full + SRA_MAX_STAGES;
  uint64_t* vfull = empty + SRA_MAX_STAGES;
  uint64_t* vempty = vfull + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full + s, 1 + 128);  // the TMA arrive + one per slot thread
      mbar_init(empty + s, 2);       // one per consumer warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(vfull + i, 2 * 128);  // metadata + codes of each slot
      mbar_init(vempty + i, NCON);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread tid gathers slot tid of every pass ----
    int ck = 0;
    for (int p = 0; p < n_pass; ++p) {
      const int mb = p & 1;
      const uint32_t vph = (p >> 1) & 1;
      const int slot = p * SRA_PASS + tid;
      const bool live = slot < n_c;
      int row = 0, ok = 0;
      float sc = 0.f;
      if (live) {
        row = min(max(idx[(size_t)b * n_c + slot], 0), S - 1);
        ok = valid[(size_t)b * n_c + slot] != 0;
      }
      const int prow = sra_row<PAGED>(lay, b, S, row);
      if (live) sc = k_scale != nullptr ? __bfloat162float(k_scale[prow]) : 1.f;
      mbar_wait(vempty + mb, vph ^ 1);
      meta[mb * SRA_PASS + tid] = SraMeta{row, prow, ok, sc};
      if (live) {
        const uint8_t* src = v_q + (size_t)prow * code_w + (size_t)h * VROW;
        const uint32_t dst = sals_smem(vcodes + (mb * SRA_PASS + tid) * VROW);
#pragma unroll
        for (int c = 0; c < VROW / 16; ++c)
          cp_async16(dst + 16 * c, src + 16 * c, 16);
        const int g_hi = min((h * DH + DH - 1) / v_group, G - 1);
        __nv_bfloat162* sz = vsz + (size_t)(mb * SRA_PASS + tid) * ngh;
        for (int g = g_lo; g <= g_hi; ++g)
          sz[g - g_lo] = __halves2bfloat162(v_scale[(size_t)prow * G + g],
                                            v_zero[(size_t)prow * G + g]);
      }
      cp_async_arrive(vfull + mb);
      mbar_arrive(vfull + mb);

      const TK* lrow = k_lat + (size_t)prow * r;
      for (int kc = 0; kc < n_k; ++kc, ++ck) {
        const int st = ck % L.stages;
        const uint32_t ph = (ck / L.stages) & 1;
        unsigned char* lat_st = ring + st * L.stage;
        mbar_wait(empty + st, ph ^ 1);
        if (tid == 0) {
          mbar_expect_tx(full + st, (uint32_t)L.u);
          tma_load_2d(lat_st + L.lat, &tm_u, full + st, kc * SRA_KC, h * DH);
        }
        const uint32_t dst = sals_smem(lat_st) + tid * 128;
        const int col0 = kc * SRA_KC;
        if constexpr (sizeof(TK) == 2) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = col0 + 8 * c;
            const bool in = live && col < r;
            cp_async16(dst + ((c ^ (tid & 7)) << 4), in ? lrow + col : k_lat,
                       in ? 16u : 0u);
          }
          cp_async_arrive(full + st);
        } else {
          uint2 raw[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = col0 + 8 * c;
            raw[c] = live && col < r
                         ? *reinterpret_cast<const uint2*>(lrow + col)
                         : make_uint2(0, 0);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int8_t* e = reinterpret_cast<const int8_t*>(&raw[c]);
            uint4 w;
            w.x = sra_bf16x2((float)e[0], (float)e[1]);
            w.y = sra_bf16x2((float)e[2], (float)e[3]);
            w.z = sra_bf16x2((float)e[4], (float)e[5]);
            w.w = sra_bf16x2((float)e[6], (float)e[7]);
            asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                             dst + ((c ^ (tid & 7)) << 4)),
                         "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
                         : "memory");
          }
          fence_proxy_async();
          mbar_arrive(full + st);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int ctid = threadIdx.x - 128;
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32, quad = lane & 3;
  const float scale = (float)(1.0 / sqrt((double)DH));

  // RoPE'd query heads of this kv group for every window query t (row
  // qg = t * group + gi), once (rounded to q's dtype as the reference's
  // oracle does)
  for (int e = ctid; e < nq * DH; e += NCON) {
    const int qg = e / DH, d = e % DH;
    const int t = qg / group, gi = qg % group;
    q_s[e] = sals_load(q, q_dtype,
                       (((size_t)b * ql + t) * H + h * group + gi) * DH + d);
  }
  for (int e = ctid; e < nq * DH; e += NCON) o_s[e] = 0.f;
  for (int e = ctid; e < nq; e += NCON) {
    m_s[e] = SALS_NEG_INF;
    l_s[e] = 0.f;
  }
  named_bar_sync(1, NCON);
  if (use_rope) {
    for (int e = ctid; e < nq * HALF; e += NCON) {
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
    named_bar_sync(1, NCON);
  }
  const int base = pos_base[b];
  const int qpos = q_pos[b];

  int ck = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int mb = p & 1;
    const uint32_t vph = (p >> 1) & 1;
    const int count = min(SRA_PASS, n_c - p * SRA_PASS);

    // K tile (64 slots x DH) = lat . U_h^T on the tensor cores
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < n_k; ++kc, ++ck) {
      const int st = ck % L.stages;
      const uint32_t ph = (ck / L.stages) & 1;
      mbar_wait(full + st, ph);
      fence_proxy_async();  // the gathered rows were written by cp.async
      const uint32_t lat_a = sals_smem(ring + st * L.stage) + cw * 64 * 128;
      const uint32_t u_a = sals_smem(ring + st * L.stage + L.lat);
      wgmma_hold<DH / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SRA_KC / 16; ++kk)
        wgmma_ss<DH>(acc, gmma_desc(lat_a + kk * 32, 16, 1024),
                     gmma_desc(u_a + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold<DH / 2>(acc);
      if (tid == 0) mbar_arrive(empty + st);
    }

    mbar_wait(vfull + mb, vph);
    const SraMeta* pm = meta + mb * SRA_PASS;
    // this thread's accumulator rows: slots sl[0], sl[1] of the pass
    int sl[2];
    SraMeta mt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sl[i] = cw * 64 + warp * 16 + lane / 4 + 8 * i;
      mt[i] = pm[sl[i]];
    }
    if constexpr (sizeof(TK) == 1) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[4 * j + 0] *= mt[0].sc;
        acc[4 * j + 1] *= mt[0].sc;
        acc[4 * j + 2] *= mt[1].sc;
        acc[4 * j + 3] *= mt[1].sc;
      }
    }
    // RoPE at the selected positions: channel d = 8j + 2 quad + c and its
    // partner d + DH/2 (j + DH/16) are in this thread
    if (use_rope) {
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float f = freqs[8 * j + 2 * quad + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float ang = (float)(base + mt[i].row) * f;
            const float cs = cosf(ang), sn = sinf(ang);
            const int a = 4 * j + 2 * i + c, a2 = a + 4 * (DH / 16);
            const float x1 = acc[a], x2 = acc[a2];
            acc[a] = x1 * cs - x2 * sn;
            acc[a2] = x2 * cs + x1 * sn;
          }
        }
      }
    }
    // logits of every (window query, head); query t sees the slot only if
    // its position is at most q_pos + t - n_recent (n_recent = 0: no gate)
    for (int qg = 0; qg < nq; ++qg) {
      const float* qv = q_s + qg * DH + 2 * quad;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float2 qq = *reinterpret_cast<const float2*>(qv + 8 * j);
        a0 += qq.x * acc[4 * j + 0] + qq.y * acc[4 * j + 1];
        a1 += qq.x * acc[4 * j + 2] + qq.y * acc[4 * j + 3];
      }
      a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
      a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
      a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
      a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
      if (quad == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = (i ? a1 : a0) * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          const bool seen =
              n_recent == 0 || base + mt[i].row <= qpos + qg / group - n_recent;
          p_s[qg * SRA_PASS + sl[i]] = mt[i].ok && seen ? x : SALS_NEG_INF;
        }
      }
    }
    named_bar_sync(1, NCON);

    // softmax statistics of the pass, one warp per (window query, head)
    for (int qg = ctid / 32; qg < nq; qg += NCON / 32) {
      float* px = p_s + qg * SRA_PASS;
      float x[SRA_PASS / 32];
      float mx = SALS_NEG_INF;
#pragma unroll
      for (int k = 0; k < SRA_PASS / 32; ++k) {
        x[k] = px[lane + 32 * k];
        mx = fmaxf(mx, x[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[qg];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < SRA_PASS / 32; ++k) {
        const float pk =
            x[k] <= SALS_NEG_INF * 0.5f ? 0.f : expf(x[k] - m_new);
        px[lane + 32 * k] = pk;
        sum += pk;
      }
      sum = sals_warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        m_s[qg] = m_new;
        l_s[qg] = l_s[qg] * alpha + sum;
        a_s[qg] = alpha;
      }
    }
    named_bar_sync(1, NCON);

    // o = o * alpha + sum_s p_s v_s, slot by slot in the given order; a
    // thread owns one channel d of every (NCON / DH)-th query row and
    // dequantizes each value once for up to 8 of them
    {
      constexpr int TPD = NCON / DH;
      const int d = ctid % DH;
      const int cg = h * DH + d;
      const int gl = cg / v_group - g_lo;
      const uint8_t* vc = vcodes + mb * SRA_PASS * VROW;
      const __nv_bfloat162* sz = vsz + (size_t)mb * SRA_PASS * ngh + gl;
      for (int q0 = ctid / DH; q0 < nq; q0 += 8 * TPD) {
        float oc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int qg = q0 + TPD * u;
          oc[u] = qg < nq ? o_s[qg * DH + d] * a_s[qg] : 0.f;
        }
#pragma unroll 4
        for (int s = 0; s < count; ++s) {
          float code;
          if (VBITS == 4) {
            const uint8_t byte = vc[s * VROW + (d >> 1)];
            code = (float)((cg & 1) ? (byte >> 4) : (byte & 0x0F));
          } else {
            code = (float)(int8_t)vc[s * VROW + d] + 128.f;
          }
          const __nv_bfloat162 szv = sz[s * ngh];
          const float v = __fadd_rn(__fmul_rn(code, __low2float(szv)),
                                    __high2float(szv));
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int qg = q0 + TPD * u;
            if (qg < nq) oc[u] = fmaf(p_s[qg * SRA_PASS + s], v, oc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int qg = q0 + TPD * u;
          if (qg < nq) o_s[qg * DH + d] = oc[u];
        }
      }
    }
    mbar_arrive(vempty + mb);
    named_bar_sync(1, NCON);  // p_s / a_s are rewritten by the next pass
  }

  for (int cell = ctid; cell < nq * DH; cell += NCON) {
    const int qg = cell / DH, d = cell % DH;
    const int t = qg / group, gi = qg % group;
    const size_t hq = ((size_t)b * ql + t) * H + h * group + gi;
    o_out[hq * DH + d] = o_s[cell];
    if (d == 0) {
      m_out[hq] = m_s[qg];
      l_out[hq] = l_s[qg];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 latents: the CUDA-core body (see the header)
// ---------------------------------------------------------------------------

constexpr int SRF_THREADS = 512;
constexpr int SRF_T = 32;   // selected slots per tile
constexpr int SRF_JT = 32;  // U columns per shared-memory chunk
constexpr int SRF_LAT_LD = SRF_T + 4;  // lat_s row pitch (floats)

template <typename TK, int VBITS, int DH, bool PAGED>
__global__ void __launch_bounds__(SRF_THREADS) sra_f32_kernel(
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
  constexpr int N_SG = SRF_THREADS / DH;  // slot groups
  constexpr int SPT = SRF_T / N_SG;       // slots per thread
  constexpr int HALF = DH / 2;
  static_assert(SRF_THREADS % DH == 0 && SRF_T % N_SG == 0 && SPT % 4 == 0,
                "tile shape");
  static_assert(SRF_T == 32, "the gather maps one slot to each lane");
  const int group = H / n_kv;
  const int nq = ql * group;  // (window query, head) pairs of this block
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = SRF_THREADS / 32;
  const float scale = (float)(1.0 / sqrt((double)DH));

  extern __shared__ __align__(16) float smem[];
  float* lat_s = smem;                               // r x LAT_LD
  float* u_s = lat_s + (size_t)r * SRF_LAT_LD;       // DH x (JT+1)
  float* k_s = u_s + DH * (SRF_JT + 1);              // T x DH
  float* v_s = k_s + SRF_T * DH;                     // T x DH
  float* q_s = v_s + SRF_T * DH;                     // nq x DH
  float* lg_s = q_s + nq * DH;                       // T x nq
  float* m_s = lg_s + SRF_T * nq;                    // nq*DH softmax cells
  float* l_s = m_s + nq * DH;
  float* o_s = l_s + nq * DH;
  int* row_s = reinterpret_cast<int*>(o_s + nq * DH);  // T
  int* ok_s = row_s + SRF_T;                                    // T
  float* sc_s = reinterpret_cast<float*>(ok_s + SRF_T);         // T
  int* prow_s = reinterpret_cast<int*>(sc_s + SRF_T);  // T physical rows

  // RoPE'd query heads of this kv group for every window query t (row
  // qg = t * group + gi), once (rounded to q's dtype as the reference's
  // oracle does)
  for (int e = tid; e < nq * DH; e += SRF_THREADS) {
    const int qg = e / DH, d = e % DH;
    const int t = qg / group, gi = qg % group;
    q_s[e] = sals_load(q, q_dtype,
                       (((size_t)b * ql + t) * H + h * group + gi) * DH + d);
  }
  __syncthreads();
  if (use_rope) {
    for (int e = tid; e < nq * HALF; e += SRF_THREADS) {
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
  for (int cell = tid; cell < n_cells; cell += SRF_THREADS) {
    m_s[cell] = SALS_NEG_INF;
    l_s[cell] = 0.f;
    o_s[cell] = 0.f;
  }
  const int base = pos_base[b];
  const int qpos = q_pos[b];
  const int d_own = tid % DH, sg = tid / DH;

  for (int t0 = 0; t0 < n_c; t0 += SRF_T) {
    const int count = min(SRF_T, n_c - t0);
    __syncthreads();  // previous tile fully consumed
    if (tid < SRF_T) {
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
          lat_s[(size_t)(c * CH + k) * SRF_LAT_LD + t] = sals_to_f(e0[k]) * sc;
          lat_s[(size_t)(c * CH + CH / 2 + k) * SRF_LAT_LD + t] =
              sals_to_f(e1[k]) * sc;
        }
      }
      for (int j = n_ch * CH + warp; j < r; j += nwarps)
        lat_s[(size_t)j * SRF_LAT_LD + t] = sals_to_f(rowp[j]) * sc;
    }

    // 2. reconstruct the tile: acc[i] = k[slot sg*SPT+i][d_own]
    float acc[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) acc[i] = 0.f;
    // U chunks of 32 columns: with bf16 U each thread holds one 16-byte
    // vector of the next chunk in registers while the current one is used
    constexpr int VPR_U = SRF_JT / 8;                 // vectors per U row
    constexpr int UPT = (DH * VPR_U + SRF_THREADS - 1) / SRF_THREADS;
    const __nv_bfloat16* ub = static_cast<const __nv_bfloat16*>(u);
    uint4 ureg[UPT];
    auto fetch_u = [&](int j0) {
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const int e = tid + i * SRF_THREADS;
        if (e < DH * VPR_U)
          ureg[i] = *reinterpret_cast<const uint4*>(
              ub + (size_t)(h * DH + e / VPR_U) * r + j0 + (e % VPR_U) * 8);
      }
    };
    if (u_vec) fetch_u(0);
    for (int j0 = 0; j0 < r; j0 += SRF_JT) {
      const int jn = min(SRF_JT, r - j0);
      __syncthreads();  // lat_s written / previous u_s chunk consumed
      if (u_vec) {
#pragma unroll
        for (int i = 0; i < UPT; ++i) {
          const int e = tid + i * SRF_THREADS;
          if (e < DH * VPR_U) {
            const __nv_bfloat16* v8 =
                reinterpret_cast<const __nv_bfloat16*>(&ureg[i]);
            float* dst = u_s + (e / VPR_U) * (SRF_JT + 1) + (e % VPR_U) * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) dst[k] = __bfloat162float(v8[k]);
          }
        }
        if (j0 + SRF_JT < r) fetch_u(j0 + SRF_JT);
      } else {
        for (int e = tid; e < DH * SRF_JT; e += SRF_THREADS) {
          const int d = e / SRF_JT, jj = e % SRF_JT;
          u_s[d * (SRF_JT + 1) + jj] =
              jj < jn ? sals_load(u, u_dtype,
                                  (size_t)(h * DH + d) * r + j0 + jj)
                      : 0.f;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        const float uv = u_s[d_own * (SRF_JT + 1) + jj];
        const float4* lp = reinterpret_cast<const float4*>(
            lat_s + (size_t)(j0 + jj) * SRF_LAT_LD + sg * SPT);
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
      for (int e = tid; e < SRF_T * HALF; e += SRF_THREADS) {
        const int t = e / HALF, d = e % HALF;
        const float ang = (float)(base + row_s[t]) * freqs[d];
        const float c = cosf(ang), s = sinf(ang);
        const float x1 = k_s[t * DH + d], x2 = k_s[t * DH + d + HALF];
        k_s[t * DH + d] = x1 * c - x2 * s;
        k_s[t * DH + d + HALF] = x2 * c + x1 * s;
      }
    }
    // 5. dequantize this head's value channels
    for (int e = tid; e < SRF_T * DH; e += SRF_THREADS) {
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
    for (int cell = tid; cell < n_cells; cell += SRF_THREADS) {
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

  for (int cell = tid; cell < n_cells; cell += SRF_THREADS) {
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

size_t sra_f32_smem_bytes(int r, int dh, int group, int ql) {
  const size_t nq = (size_t)ql * group;
  return sizeof(float) * ((size_t)r * SRF_LAT_LD + dh * (SRF_JT + 1) +
                          2 * SRF_T * dh + nq * dh + SRF_T * nq +
                          3 * nq * dh + SRF_T) +
         3 * sizeof(int) * SRF_T;
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
static int launch_sra_f32(const SraCall& c, cudaStream_t stream) {
  const size_t smem = sra_f32_smem_bytes(c.r, DH, c.H / c.n_kv, c.ql);
  if (smem > (size_t)SRA_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // 16-byte vector paths need aligned rows (and whole U chunks)
  const int lat_vec = (reinterpret_cast<uintptr_t>(c.k_lat) % 16 == 0) &&
                      ((size_t)c.r * sizeof(TK)) % 16 == 0;
  const int u_vec = c.u_dtype == SALS_BF16 &&
                    reinterpret_cast<uintptr_t>(c.u) % 16 == 0 &&
                    c.r % SRF_JT == 0;
  cudaFuncSetAttribute(sra_f32_kernel<TK, VBITS, DH, PAGED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(c.B, c.n_kv);
  sra_f32_kernel<TK, VBITS, DH, PAGED><<<grid, SRF_THREADS, smem, stream>>>(
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

static bool sra_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TK, int VBITS, int DH, bool PAGED>
static int launch_sra_tc(const SraCall& c, cudaStream_t stream) {
  const SraTcLayout L =
      sra_tc_layout(DH, c.ql * (c.H / c.n_kv), VBITS, c.v_group);
  // bf16 U_h for TMA and wgmma; 16-byte rows for the gathers
  if (L.stages < 2 || c.u_dtype != SALS_BF16 || c.r % 8 != 0 ||
      c.code_w % 16 != 0 || !sra_aligned(c.k_lat) || !sra_aligned(c.v_q) ||
      !sra_aligned(c.u))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tu;
  const cuuint64_t dims[2] = {(cuuint64_t)c.r, (cuuint64_t)c.n_kv * DH};
  const cuuint64_t strides[1] = {(cuuint64_t)c.r * 2};
  const cuuint32_t box[2] = {SRA_KC, DH};
  const int err = sals_tmap_bf16(&tu, c.u, 2, dims, strides, box);
  if (err) return err;
  cudaFuncSetAttribute(sra_kernel<TK, VBITS, DH, PAGED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.total);
  dim3 grid(c.B, c.n_kv);
  sra_kernel<TK, VBITS, DH, PAGED><<<grid, SRA_THREADS, L.total, stream>>>(
      tu, c.q, c.q_dtype, static_cast<const TK*>(c.k_lat),
      static_cast<const __nv_bfloat16*>(c.k_scale),
      static_cast<const uint8_t*>(c.v_q),
      static_cast<const __nv_bfloat16*>(c.v_scale),
      static_cast<const __nv_bfloat16*>(c.v_zero),
      static_cast<const int*>(c.idx), static_cast<const uint8_t*>(c.valid),
      static_cast<const int*>(c.q_pos), static_cast<const int*>(c.pos_base),
      static_cast<const float*>(c.freqs), static_cast<float*>(c.m),
      static_cast<float*>(c.l), static_cast<float*>(c.o), c.ql, c.H, c.n_kv,
      c.S, c.r, c.code_w, c.G, c.v_group, c.n_c, c.n_recent, c.softcap,
      c.use_rope, c.lay);
  return (int)cudaGetLastError();
}

template <int VBITS, int DH, bool PAGED>
static int dispatch_k(int k_dtype, const SraCall& c, cudaStream_t st) {
  switch (k_dtype) {
    case SALS_F32:
      return launch_sra_f32<float, VBITS, DH, PAGED>(c, st);
    case SALS_BF16:
      return c.u_dtype == SALS_BF16
                 ? launch_sra_tc<__nv_bfloat16, VBITS, DH, PAGED>(c, st)
                 : launch_sra_f32<__nv_bfloat16, VBITS, DH, PAGED>(c, st);
    case SALS_I8:
      return c.u_dtype == SALS_BF16
                 ? launch_sra_tc<int8_t, VBITS, DH, PAGED>(c, st)
                 : launch_sra_f32<int8_t, VBITS, DH, PAGED>(c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
static int dispatch_sra(const SraCall& c, int k_dtype, int v_bits, int dh,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_bits != 8 && v_bits != 4) return (int)cudaErrorInvalidValue;
  if (c.ql < 1 || c.ql > SRA_MAX_QL || c.n_recent < 0)
    return (int)cudaErrorInvalidValue;
  const bool v4 = v_bits == 4;
  if (dh == 128)
    return v4 ? dispatch_k<4, 128, PAGED>(k_dtype, c, st)
              : dispatch_k<8, 128, PAGED>(k_dtype, c, st);
  if (dh == 64)
    return v4 ? dispatch_k<4, 64, PAGED>(k_dtype, c, st)
              : dispatch_k<8, 64, PAGED>(k_dtype, c, st);
  return (int)cudaErrorInvalidValue;
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
