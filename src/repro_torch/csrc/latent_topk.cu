// Latent scoring (SALS §4.3) on Hopper: the fused score -> per-block top-k
// kernel, port of repro/kernels/latent_score.py::latent_topk_pallas and
// (PAGED = true) ::latent_topk_paged_pallas, and the plain (B, S) score
// kernel, port of ::latent_score_pallas.  Both score a cache row with the
// same device function (latent_row_score), so the plain kernel's scores are
// bit for bit the scores the top-k kernel ranks.
//
// Top-k: grid (B, nb), one block per (batch row, 1024-token seq block).
// Each warp scores whole cache rows: its lanes read the leading r* columns
// of a row with 16-byte loads (coalesced), multiply by the f32 latent query
// held in shared memory, reduce with shuffles in f32 and apply the int8
// per-token scale.  A row is selectable iff n_sink <= pos_base+j <=
// pos-n_recent (and j < S); others score NEG_INF.  The block pads its
// scores to a power of two with -inf and the id npad, bitonic-sorts (score,
// id) in shared memory under the key (value desc, id asc), and writes its
// first kb candidates.  The caller merges the (B, nb*kb) candidates with a
// stable sort.
//
// Paged layout: the latents are a pool (n_pages, ps, r) and row b's logical
// position j lives at pool row pt[b, min(j / ps, mp - 1)] * ps + j % ps,
// the page id clamped into the pool (unmapped entries may hold anything;
// the position mask keeps them unselectable).  Only the address differs
// from the dense kernel: every arithmetic line is shared, candidates come
// out in logical order, so paged and dense agree bit for bit on the same
// logical contents, tie-breaks included.
//
// Plain scores: grid (B, ceil(S / 64)), 8 warps a block, each warp scoring
// 8 rows; out[b, j] for j < S, nothing past S.
//
// Bound: both read B*S*r* latent elements once (bytes-bound; 17 MB at the
// llama2-7b slice shapes).  The top-k kernel keeps one block per seq block
// for the candidate order the reference's merge needs, so its grid is small
// (B*nb blocks), the first thing a faster version would change; the plain
// kernel's 64-row blocks fill the SMs.
#include "common.cuh"

#include <math.h>

// Where row b's logical cache position j lives (pages: see the header).
struct TopkLayout {
  const int* page_table;  // (B, mp) int32, or null for the dense arena
  int mp, ps, n_pages;
};

template <bool PAGED>
__device__ __forceinline__ size_t topk_row(const TopkLayout& lay, int b,
                                           int S, int j) {
  if (!PAGED) return (size_t)b * S + j;
  const int lp = min(j / lay.ps, lay.mp - 1);
  const int pg = min(max(lay.page_table[(size_t)b * lay.mp + lp], 0),
                     lay.n_pages - 1);
  return (size_t)pg * lay.ps + j % lay.ps;
}

// The latent score of cache row ``prow``: q_s (r* f32, shared memory) times
// the row's leading r* columns, summed over the warp (every lane returns the
// sum), times the row's int8 scale when k_scale is given.  Lanes read
// 16-byte vectors when vec_ok (row start and r* aligned), else scalars.
// Both kernels of this file score through this one function, so their
// scores agree bit for bit.
template <typename T>
__device__ __forceinline__ float latent_row_score(
    const float* q_s, const T* __restrict__ k_lat,
    const __nv_bfloat16* __restrict__ k_scale, size_t prow, int r,
    int r_star, int lane, int vec_ok) {
  const T* row = k_lat + prow * r;
  float acc = 0.f;
  if (vec_ok) {
    constexpr int EPV = 16 / sizeof(T);
    for (int c = lane * EPV; c < r_star; c += 32 * EPV) {
      uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < EPV; ++t) acc += q_s[c + t] * sals_to_f(e[t]);
    }
  } else {
    for (int c = lane; c < r_star; c += 32)
      acc += q_s[c] * sals_to_f(row[c]);
  }
  acc = sals_warp_sum(acc);
  if (k_scale != nullptr) acc *= __bfloat162float(k_scale[prow]);
  return acc;
}

template <typename T, bool PAGED>
__global__ void latent_topk_kernel(
    const float* __restrict__ q_lat, const T* __restrict__ k_lat,
    const __nv_bfloat16* __restrict__ k_scale, const int* __restrict__ pos,
    const int* __restrict__ pos_base, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int S, int r, int r_star, int bs, int npad,
    int nb, int kb, int n_sink, int n_recent, int vec_ok, TopkLayout lay) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // r_star
  float* sv = q_s + r_star;               // npad scores
  int* si = reinterpret_cast<int*>(sv + npad);  // npad ids
  const int b = blockIdx.x, blk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = tid; c < r_star; c += blockDim.x)
    q_s[c] = q_lat[(size_t)b * r_star + c];
  __syncthreads();

  const int p = pos[b], base = pos_base[b];
  const int j0 = blk * bs;
  for (int col = warp; col < npad; col += nwarps) {
    float score;
    int id;
    if (col < bs) {
      id = col;
      const int j = j0 + col;
      if (j < S) {
        const size_t prow = topk_row<PAGED>(lay, b, S, j);
        const float acc = latent_row_score<T>(q_s, k_lat, k_scale, prow, r,
                                              r_star, lane, vec_ok);
        const int pg = base + j;
        const bool ok = (pg >= n_sink) && (pg <= p - n_recent);
        score = ok ? acc : SALS_NEG_INF;
      } else {
        score = SALS_NEG_INF;  // ragged tail of the last block
      }
    } else {
      score = -INFINITY;  // power-of-two padding
      id = npad;
    }
    if (lane == 0) {
      sv[col] = score;
      si[col] = id;
    }
  }
  __syncthreads();

  // bitonic sort, first = (value desc, id asc)
  for (int k = 2; k <= npad; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < npad; i += blockDim.x) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const float vi = sv[i], vj = sv[ixj];
          const int ii = si[i], ij = si[ixj];
          const bool j_first = (vj > vi) || (vj == vi && ij < ii);
          const bool i_first = (vi > vj) || (vi == vj && ii < ij);
          const bool swap = ((i & k) == 0) ? j_first : i_first;
          if (swap) {
            sv[i] = vj;
            sv[ixj] = vi;
            si[i] = ij;
            si[ixj] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = tid; t < kb; t += blockDim.x) {
    const size_t o = ((size_t)b * nb + blk) * kb + t;
    cand_v[o] = sv[t];
    cand_i[o] = j0 + si[t];
  }
}

template <typename T, bool PAGED>
static void launch_topk(const float* q_lat, const void* k_lat,
                        const void* k_scale, const int* pos,
                        const int* pos_base, float* cand_v, int* cand_i,
                        int B, int S, int r, int r_star, int bs, int nb,
                        int kb, int n_sink, int n_recent, int vec_ok,
                        TopkLayout lay, cudaStream_t stream) {
  int npad = 1;
  while (npad < bs) npad <<= 1;
  const size_t smem = sizeof(float) * (size_t)(r_star + npad) +
                      sizeof(int) * (size_t)npad;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(latent_topk_kernel<T, PAGED>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(B, nb);
  latent_topk_kernel<T, PAGED><<<grid, 1024, smem, stream>>>(
      q_lat, static_cast<const T*>(k_lat),
      static_cast<const __nv_bfloat16*>(k_scale), pos, pos_base, cand_v,
      cand_i, S, r, r_star, bs, npad, nb, kb, n_sink, n_recent, vec_ok, lay);
}

template <bool PAGED>
static int dispatch_topk(const void* q_lat, const void* k_lat, int k_dtype,
                         const void* k_scale, const void* pos,
                         const void* pos_base, void* cand_v, void* cand_i,
                         int B, int S, int r, int r_star, int bs, int nb,
                         int kb, int n_sink, int n_recent, int vec_ok,
                         TopkLayout lay, void* stream) {
  const float* q = static_cast<const float*>(q_lat);
  const int* p = static_cast<const int*>(pos);
  const int* pb = static_cast<const int*>(pos_base);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_dtype) {
    case SALS_F32:
      launch_topk<float, PAGED>(q, k_lat, k_scale, p, pb, cv, ci, B, S, r,
                                r_star, bs, nb, kb, n_sink, n_recent, vec_ok,
                                lay, st);
      break;
    case SALS_BF16:
      launch_topk<__nv_bfloat16, PAGED>(q, k_lat, k_scale, p, pb, cv, ci, B,
                                        S, r, r_star, bs, nb, kb, n_sink,
                                        n_recent, vec_ok, lay, st);
      break;
    case SALS_I8:
      launch_topk<int8_t, PAGED>(q, k_lat, k_scale, p, pb, cv, ci, B, S, r,
                                 r_star, bs, nb, kb, n_sink, n_recent, vec_ok,
                                 lay, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sals_latent_topk(const void* q_lat, const void* k_lat,
                                int k_dtype, const void* k_scale,
                                const void* pos, const void* pos_base,
                                void* cand_v, void* cand_i, int B, int S,
                                int r, int r_star, int bs, int nb, int kb,
                                int n_sink, int n_recent, int vec_ok,
                                void* stream) {
  return dispatch_topk<false>(q_lat, k_lat, k_dtype, k_scale, pos, pos_base,
                              cand_v, cand_i, B, S, r, r_star, bs, nb, kb,
                              n_sink, n_recent, vec_ok,
                              TopkLayout{nullptr, 0, 0, 0}, stream);
}

// Paged: k_lat (n_pages, ps, r) and k_scale (n_pages, ps) pools, page_table
// (B, mp) int32; S = mp * ps is the logical extent.
extern "C" int sals_latent_topk_paged(
    const void* q_lat, const void* k_lat, int k_dtype, const void* k_scale,
    const void* pos, const void* pos_base, const void* page_table,
    void* cand_v, void* cand_i, int B, int S, int r, int r_star, int bs,
    int nb, int kb, int n_sink, int n_recent, int vec_ok, int mp, int ps,
    int n_pages, void* stream) {
  if (mp < 1 || ps < 1 || n_pages < 1 || S != mp * ps)
    return (int)cudaErrorInvalidValue;
  return dispatch_topk<true>(
      q_lat, k_lat, k_dtype, k_scale, pos, pos_base, cand_v, cand_i, B, S, r,
      r_star, bs, nb, kb, n_sink, n_recent, vec_ok,
      TopkLayout{static_cast<const int*>(page_table), mp, ps, n_pages},
      stream);
}

// ---------------------------------------------------------------------------
// Plain (B, S) f32 scores (metrics / overlap): latent_score_pallas
// ---------------------------------------------------------------------------

constexpr int SCORE_WARPS = 8;          // warps per block
constexpr int SCORE_ROWS = 64;          // cache rows per block

template <typename T>
__global__ void latent_score_kernel(const float* __restrict__ q_lat,
                                    const T* __restrict__ k_lat,
                                    const __nv_bfloat16* __restrict__ k_scale,
                                    float* __restrict__ out, int S, int r,
                                    int r_star, int vec_ok) {
  extern __shared__ float q_s[];        // r_star
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < r_star; c += blockDim.x)
    q_s[c] = q_lat[(size_t)b * r_star + c];
  __syncthreads();
  const int j0 = blockIdx.y * SCORE_ROWS;
  for (int jj = warp; jj < SCORE_ROWS; jj += SCORE_WARPS) {
    const int j = j0 + jj;
    if (j >= S) break;
    const size_t prow = (size_t)b * S + j;
    const float acc = latent_row_score<T>(q_s, k_lat, k_scale, prow, r,
                                          r_star, lane, vec_ok);
    if (lane == 0) out[prow] = acc;
  }
}

template <typename T>
static void launch_score(const float* q_lat, const void* k_lat,
                         const void* k_scale, float* out, int B, int S, int r,
                         int r_star, int vec_ok, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)r_star;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(latent_score_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(B, (S + SCORE_ROWS - 1) / SCORE_ROWS);
  latent_score_kernel<T><<<grid, 32 * SCORE_WARPS, smem, stream>>>(
      q_lat, static_cast<const T*>(k_lat),
      static_cast<const __nv_bfloat16*>(k_scale), out, S, r, r_star, vec_ok);
}

// q_lat (B, r*) f32; k_lat (B, S, r) f32 / bf16 / int8, r* <= r; k_scale
// (B, S) bf16 or null; out (B, S) f32.
extern "C" int sals_latent_score(const void* q_lat, const void* k_lat,
                                 int k_dtype, const void* k_scale, void* out,
                                 int B, int S, int r, int r_star, int vec_ok,
                                 void* stream) {
  if (B < 1 || S < 1 || r_star < 1 || r_star > r)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(q_lat);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_dtype) {
    case SALS_F32:
      launch_score<float>(q, k_lat, k_scale, o, B, S, r, r_star, vec_ok, st);
      break;
    case SALS_BF16:
      launch_score<__nv_bfloat16>(q, k_lat, k_scale, o, B, S, r, r_star,
                                  vec_ok, st);
      break;
    case SALS_I8:
      launch_score<int8_t>(q, k_lat, k_scale, o, B, S, r, r_star, vec_ok,
                           st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
