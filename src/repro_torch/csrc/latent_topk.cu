// Fused latent scoring + per-block top-k (SALS §4.3), Hopper port of
// repro/kernels/latent_score.py::latent_topk_pallas.
//
// Grid (B, nb): one block per (batch row, 1024-token seq block).  Each warp
// scores whole cache rows: its lanes read the leading r* columns of a row
// with 16-byte loads (coalesced), multiply by the f32 latent query held in
// shared memory, reduce with shuffles in f32 and apply the int8 per-token
// scale.  A row is selectable iff n_sink <= pos_base+j <= pos-n_recent (and
// j < S); others score NEG_INF.  The block pads its scores to a power of
// two with -inf and the id npad, bitonic-sorts (score, id) in shared memory
// under the key (value desc, id asc), and writes its first kb candidates.
// The caller merges the (B, nb*kb) candidates with a stable sort.
//
// Bound: it reads B*S*r* latent elements once (bytes-bound; 17 MB at the
// llama2-7b slice shapes).  One block per seq block keeps the candidate
// order the reference's merge needs; the grid is small (B*nb blocks), which
// is the first thing a faster version would change.
#include "common.cuh"

#include <math.h>

template <typename T>
__global__ void latent_topk_kernel(
    const float* __restrict__ q_lat, const T* __restrict__ k_lat,
    const __nv_bfloat16* __restrict__ k_scale, const int* __restrict__ pos,
    const int* __restrict__ pos_base, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int S, int r, int r_star, int bs, int npad,
    int nb, int kb, int n_sink, int n_recent, int vec_ok) {
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
        const T* row = k_lat + ((size_t)b * S + j) * r;
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
        if (k_scale != nullptr)
          acc *= __bfloat162float(k_scale[(size_t)b * S + j]);
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

template <typename T>
static void launch_topk(const float* q_lat, const void* k_lat,
                        const void* k_scale, const int* pos,
                        const int* pos_base, float* cand_v, int* cand_i,
                        int B, int S, int r, int r_star, int bs, int nb,
                        int kb, int n_sink, int n_recent, int vec_ok,
                        cudaStream_t stream) {
  int npad = 1;
  while (npad < bs) npad <<= 1;
  const size_t smem = sizeof(float) * (size_t)(r_star + npad) +
                      sizeof(int) * (size_t)npad;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(latent_topk_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(B, nb);
  latent_topk_kernel<T><<<grid, 1024, smem, stream>>>(
      q_lat, static_cast<const T*>(k_lat),
      static_cast<const __nv_bfloat16*>(k_scale), pos, pos_base, cand_v,
      cand_i, S, r, r_star, bs, npad, nb, kb, n_sink, n_recent, vec_ok);
}

extern "C" int sals_latent_topk(const void* q_lat, const void* k_lat,
                                int k_dtype, const void* k_scale,
                                const void* pos, const void* pos_base,
                                void* cand_v, void* cand_i, int B, int S,
                                int r, int r_star, int bs, int nb, int kb,
                                int n_sink, int n_recent, int vec_ok,
                                void* stream) {
  const float* q = static_cast<const float*>(q_lat);
  const int* p = static_cast<const int*>(pos);
  const int* pb = static_cast<const int*>(pos_base);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_dtype) {
    case SALS_F32:
      launch_topk<float>(q, k_lat, k_scale, p, pb, cv, ci, B, S, r, r_star,
                         bs, nb, kb, n_sink, n_recent, vec_ok, st);
      break;
    case SALS_BF16:
      launch_topk<__nv_bfloat16>(q, k_lat, k_scale, p, pb, cv, ci, B, S, r,
                                 r_star, bs, nb, kb, n_sink, n_recent,
                                 vec_ok, st);
      break;
    case SALS_I8:
      launch_topk<int8_t>(q, k_lat, k_scale, p, pb, cv, ci, B, S, r, r_star,
                          bs, nb, kb, n_sink, n_recent, vec_ok, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
