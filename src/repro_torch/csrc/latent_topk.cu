// Latent scoring (SALS §4.3) on Hopper.  Replaces the TPU kernels
// repro/kernels/latent_score.py::latent_topk_pallas, ::latent_topk_paged_pallas
// (both: score -> per-block top-k, then a lax.top_k merge) and
// ::latent_score_pallas (plain (B, S) scores) with two kernels:
//
// 1. latent_score_pass<T, PAGED, MASKED>: the score of every cache row, the
//    f32 latent query (B, r*) times the row's leading r* columns (row stride
//    r), times the row's int8 scale.  Grid (ceil(S / 16), B), 4 warps a
//    block, 4 rows a warp: a lane loads its 16-byte chunks of all 4 rows
//    into registers before it adds any (rows of 256 bytes or more asking
//    L2 for whole 256-byte sector pairs), with no shared-memory staging;
//    the small blocks spread the rows over every SM.  The dense arena and the
//    page pools (PAGED) differ only in the row address (topk_row).  Rows
//    whose start or r*·b is not 16-byte aligned load their chunks element by
//    element.  The sum runs in one fixed order that depends only on the
//    row's contents and r* (lane l takes the chunks l, l+32, ... of the row,
//    in order, then a shuffle tree), so: paged equals dense, the plain scores
//    (MASKED = false, row 8) equal the scores the top-k ranks, and a score
//    pool with r = r* selects as the full cache does, bit for bit.  MASKED
//    (rows 1, 4): a row is selectable iff n_sink <= pos_base+j <=
//    pos-n_recent; the others are not read at all and score SALS_NEG_INF.
//    Scores go to a (B, S) f32 scratch (the plain kernel's output).
// 2. topk_select_kernel: one 1024-thread block per batch row takes the
//    top N_c of its S masked scores in the order (value desc, index asc),
//    the order of a stable descending sort.  Scores map to order-preserving
//    uint32 keys (equal floats, -0 and +0 included, get equal keys).  An
//    MSD radix select (up to four 8-bit passes over shared-memory
//    histograms, each thread's contiguous run of keys kept in registers for
//    S <= 8192, else re-read from L2) finds the key T of the N_c-th largest
//    score; a block scan over the runs gives every key above T its slot and
//    the lowest-index keys equal to T the rest; a bitonic sort of the <= N_c
//    winners in registers (shuffles within a warp, shared memory across
//    warps) orders them.  idx (B, N_c) int32 and valid
//    (B, N_c) (score > NEG_INF/2) are written directly; S < N_c pads with
//    (index 0, invalid) as the reference's merge does.
//
// Bound on the H100: bytes.  The score pass reads the leading r* columns of
// every selectable row once (B·S·r*·b_lat, plus the int8 scale): 13 MB at
// the llama2-7b slice shapes, about 4 µs at 3.35 TB/s.  The design keeps
// many 16-byte loads in flight on every SM from registers, as a gemv does:
// per-row TMA bulk copies into a shared-memory ring, and 16-byte cp.async
// rings, both took about 40% longer on an H100 at those shapes.  The
// selection reads the 4·S bytes of scores from L2 once and is
// latency-bound (a 1024-thread block on one SM per batch row).
#include "common.cuh"

#include <limits.h>
#include <math.h>

// Where row b's logical cache position j lives.  Paged: the latents are a
// pool (n_pages, ps, r) and j lives at pool row pt[b, min(j / ps, mp - 1)]
// * ps + j % ps, the page id clamped into the pool (unmapped entries may
// hold anything; the position mask keeps them unselectable).
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

// ---------------------------------------------------------------------------
// 1. the score pass
// ---------------------------------------------------------------------------

constexpr int SP_WARPS = 4;                  // warps a block
constexpr int SP_THREADS = 32 * SP_WARPS;
constexpr int SP_ROWS = 4;                   // rows a warp scores at once
constexpr int SMEM_LIMIT = 232448;           // per block, opt-in

struct ScoreArgs {
  const float* q_lat;                  // (B, r*) f32
  const void* k_lat;                   // rows of r elements
  const __nv_bfloat16* k_scale;        // per row, or null
  const int* pos;                      // (B,), MASKED only
  const int* pos_base;                 // (B,), MASKED only
  float* out;                          // (B, S) f32
  int S, r, r_star, n_sink, n_recent, vec;
  TopkLayout lay;
};

template <int N> struct RawOf;
template <> struct RawOf<1> { using T = uint8_t; };
template <> struct RawOf<2> { using T = uint16_t; };
template <> struct RawOf<4> { using T = uint32_t; };

// 16-byte chunk c of a row: one vector load when rows and r* allow it
// (vec), else element by element, zero past r*.  `wide`: the row's r*
// columns span at least 256 bytes, so the load asks L2 for the whole
// 256-byte sector pair (a narrower row would drag in columns past r*).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int r_star,
                                            int vec, bool wide) {
  if (vec && wide) {
    uint4 v;
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(reinterpret_cast<const uint4*>(row) + c));
    return v;
  }
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row) + c);
  constexpr int EPV = 16 / sizeof(T);
  using Raw = typename RawOf<sizeof(T)>::T;
  uint4 out;
  Raw* e = reinterpret_cast<Raw*>(&out);
  const Raw* src = reinterpret_cast<const Raw*>(row);
#pragma unroll
  for (int t = 0; t < EPV; ++t) {
    const int i = c * EPV + t;
    e[t] = i < r_star ? src[i] : Raw(0);
  }
  return out;
}

// acc + q · chunk, element by element in order with fmaf (q: the chunk's
// EPV query values, zero past r*).
template <typename T>
__device__ __forceinline__ float chunk_fma(float acc, const uint4& raw,
                                           const float* q) {
  constexpr int EPV = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll
  for (int v = 0; v < EPV / 4; ++v) {
    const float4 qv = q4[v];
    acc = fmaf(qv.x, sals_to_f(e[4 * v + 0]), acc);
    acc = fmaf(qv.y, sals_to_f(e[4 * v + 1]), acc);
    acc = fmaf(qv.z, sals_to_f(e[4 * v + 2]), acc);
    acc = fmaf(qv.w, sals_to_f(e[4 * v + 3]), acc);
  }
  return acc;
}

template <bool MASKED>
__device__ __forceinline__ bool selectable(int j, int p, int base,
                                           int n_sink, int n_recent) {
  if (!MASKED) return true;
  const int pg = base + j;
  return pg >= n_sink && pg <= p - n_recent;
}

// Grid (ceil(S / (SP_WARPS·SP_ROWS)), B).  Warp w of block x scores the
// rows j0 ... j0 + SP_ROWS - 1, j0 = (x·SP_WARPS + w)·SP_ROWS, together:
// for each of its 16-byte chunks (c = lane, lane + 32, ...) a lane loads the
// chunk of all SP_ROWS rows into registers before it adds any, so each warp
// keeps SP_ROWS loads a lane in flight.  Row addresses, masks and int8
// scales are read before the first chunk.  Every score is the one order of
// this file: lane l adds its chunks in order, element by element with
// fmaf, a shuffle tree sums the lanes, then the int8 scale.  Shared memory:
// the query, zero past r* (n_chunk·EPV f32).
template <typename T, bool PAGED, bool MASKED>
__global__ void __launch_bounds__(SP_THREADS)
    latent_score_pass(const ScoreArgs a, int n_chunk) {
  extern __shared__ __align__(16) float q_s[];
  constexpr int EPV = 16 / sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int j0 = (blockIdx.x * SP_WARPS + warp) * SP_ROWS;
  const int p = MASKED ? a.pos[b] : 0, base = MASKED ? a.pos_base[b] : 0;
  const T* k_lat = static_cast<const T*>(a.k_lat);
  const bool wide = a.r_star * (int)sizeof(T) >= 256;

  const T* rows[SP_ROWS];
  bool live[SP_ROWS];
  float scale[SP_ROWS];
#pragma unroll
  for (int i = 0; i < SP_ROWS; ++i) {
    const int j = j0 + i;
    live[i] = j < a.S &&
              selectable<MASKED>(j, p, base, a.n_sink, a.n_recent);
    const size_t prow = live[i] ? topk_row<PAGED>(a.lay, b, a.S, j) : 0;
    rows[i] = k_lat + prow * a.r;
    scale[i] = live[i] && a.k_scale != nullptr
                   ? __bfloat162float(a.k_scale[prow])
                   : 1.f;
  }
  for (int c = tid; c < n_chunk * EPV; c += SP_THREADS)
    q_s[c] = c < a.r_star ? a.q_lat[(size_t)b * a.r_star + c] : 0.f;
  __syncthreads();

  float acc[SP_ROWS];
#pragma unroll
  for (int i = 0; i < SP_ROWS; ++i) acc[i] = 0.f;
  for (int c = lane; c < n_chunk; c += 32) {
    uint4 raw[SP_ROWS];
#pragma unroll
    for (int i = 0; i < SP_ROWS; ++i)
      if (live[i])
        raw[i] = load_chunk<T>(rows[i], c, a.r_star, a.vec, wide);
#pragma unroll
    for (int i = 0; i < SP_ROWS; ++i)
      if (live[i]) acc[i] = chunk_fma<T>(acc[i], raw[i], q_s + c * EPV);
  }
#pragma unroll
  for (int i = 0; i < SP_ROWS; ++i) {
    float score = sals_warp_sum(acc[i]);
    if (a.k_scale != nullptr) score *= scale[i];
    if (lane == 0 && j0 + i < a.S)
      a.out[(size_t)b * a.S + j0 + i] = live[i] ? score : SALS_NEG_INF;
  }
}

template <typename T, bool PAGED, bool MASKED>
static int launch_score_pass(const ScoreArgs& a, int B,
                             cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(T);
  const int n_chunk = (a.r_star + EPV - 1) / EPV;
  const size_t smem = sizeof(float) * (size_t)n_chunk * EPV;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = latent_score_pass<T, PAGED, MASKED>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  constexpr int rows = SP_WARPS * SP_ROWS;
  dim3 grid((a.S + rows - 1) / rows, B);
  kern<<<grid, SP_THREADS, smem, stream>>>(a, n_chunk);
  return (int)cudaGetLastError();
}

template <bool PAGED, bool MASKED>
static int dispatch_score_pass(int k_dtype, const ScoreArgs& a, int B,
                               cudaStream_t st) {
  switch (k_dtype) {
    case SALS_F32:
      return launch_score_pass<float, PAGED, MASKED>(a, B, st);
    case SALS_BF16:
      return launch_score_pass<__nv_bfloat16, PAGED, MASKED>(a, B, st);
    case SALS_I8:
      return launch_score_pass<int8_t, PAGED, MASKED>(a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// 2. the selection
// ---------------------------------------------------------------------------

constexpr int SEL_THREADS = 1024;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_ITEMS = 8;  // keys a thread keeps in registers (S <= 8192)

// Order-preserving key: a > b as floats iff key(a) > key(b); -0 and +0 get
// one key; NaN gets the largest (a descending torch.sort puts it first).
__device__ __forceinline__ uint32_t score_key(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if (f == 0.f) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// Add one key of this lane (in: it exists and matches the prefix) to the
// histogram of digit (key >> shift) & 0xff, one atomic per distinct digit
// of the warp.  Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(int* hist, uint32_t key, bool in,
                                         uint32_t prefix, uint32_t mask,
                                         int shift, int lane) {
  const bool match = in && (key & mask) == prefix;
  if (!__any_sync(0xffffffffu, match)) return;
  const int digit = match ? (int)((key >> shift) & 0xffu) : 256;
  const unsigned peers = __match_any_sync(0xffffffffu, digit);
  if (digit < 256 && lane == __ffs(peers) - 1)
    atomicAdd(hist + digit, __popc(peers));
}

// Grid (B,), SEL_THREADS threads; dynamic shared memory: npad keys + npad
// ids (npad: the power of two >= min(n_c, S), at least 32), twice that
// when the sort runs in registers (npad <= SEL_THREADS / 2).
__global__ void __launch_bounds__(SEL_THREADS)
    topk_select_kernel(const float* __restrict__ scores, int S, int n_c,
                       int npad, int* __restrict__ idx,
                       unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) uint32_t sel_smem[];
  uint32_t* sk = sel_smem;
  int* si = reinterpret_cast<int*>(sk + npad);
  __shared__ int hists[2][256];  // alternate passes count in each half
  __shared__ unsigned long long warp_sum[SEL_WARPS];
  __shared__ int s_digit, s_above, s_count;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  const float* sc = scores + (size_t)b * S;
  const int k = min(n_c, S);

  // radix select: after the passes, the winners are the keys whose masked
  // value is above `prefix`, and the first kk (by index) of those equal to it
  uint32_t prefix = 0u, mask = 0u;
  int kk = k;
  // thread t owns the contiguous run [lo, hi) of indices; for S <= 8192 it
  // keeps the run's keys in registers, else each pass re-reads the scores
  const int per = (S + SEL_THREADS - 1) / SEL_THREADS;
  const int lo = min(tid * per, S), hi = min(lo + per, S);
  const bool cached = per <= SEL_ITEMS;
  uint32_t kr[SEL_ITEMS];
  if (cached) {
#pragma unroll
    for (int u = 0; u < SEL_ITEMS; ++u)
      kr[u] = lo + u < hi ? score_key(sc[lo + u]) : 0u;
  }
  for (int d = tid; d < 512; d += SEL_THREADS) hists[d >> 8][d & 255] = 0;
  __syncthreads();
  for (int shift = 24; shift >= 0 && kk > 0; shift -= 8) {
    int* hist = hists[(shift >> 3) & 1];
    if (cached) {
#pragma unroll
      for (int u = 0; u < SEL_ITEMS; ++u) {
        if (u == per) break;  // per is the same for every thread
        hist_add(hist, kr[u], lo + u < hi, prefix, mask, shift, lane);
      }
    } else {  // coalesced: the histogram does not care whose key it is
      for (int i0 = 0; i0 < S; i0 += SEL_THREADS) {
        const int i = i0 + tid;
        hist_add(hist, i < S ? score_key(sc[i]) : 0u, i < S, prefix, mask,
                 shift, lane);
      }
    }
    __syncthreads();
    if (warp == 0) {  // lane l holds digits 255-8l ... 248-8l, descending
      int c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[255 - 8 * lane - q];
        sum += c[q];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      int run = incl - sum;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (run < kk && run + c[q] >= kk) {
          s_digit = 255 - 8 * lane - q;
          s_above = run;
          s_count = c[q];
        }
        run += c[q];
      }
    } else {  // the next pass's histogram (read two passes ago)
      int* next = hists[((shift >> 3) & 1) ^ 1];
      for (int d = tid - 32; d < 256; d += SEL_THREADS - 32) next[d] = 0;
    }
    __syncthreads();
    prefix |= (uint32_t)s_digit << shift;
    mask |= 0xffu << shift;
    kk -= s_above;
    if (s_count == kk) break;  // the whole bucket is taken
    // s_* are rewritten only after the next pass's first barrier
  }

  if (k > 0) {
    // compaction in index order: a block scan of each run's (gt, eq) counts
    unsigned gt = 0, eq = 0;
    auto count = [&](uint32_t key) {
      const uint32_t km = key & mask;
      gt += km > prefix;
      eq += km == prefix;
    };
    if (cached) {
#pragma unroll
      for (int u = 0; u < SEL_ITEMS; ++u)
        if (lo + u < hi) count(kr[u]);
    } else {
      for (int i = lo; i < hi; ++i) count(score_key(sc[i]));
    }
    const unsigned long long v = ((unsigned long long)gt << 32) | eq;
    unsigned long long incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long w = warp_sum[lane];
      unsigned long long wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long t = __shfl_up_sync(0xffffffffu, wi, off);
        if (lane >= off) wi += t;
      }
      warp_sum[lane] = wi - w;
    }
    __syncthreads();
    const unsigned long long ex = warp_sum[warp] + incl - v;
    int gt_at = (int)(ex >> 32), eq_at = (int)(ex & 0xffffffffu);
    const int n_above = k - kk;
    auto place = [&](uint32_t key, int i) {
      const uint32_t km = key & mask;
      int slot = -1;
      if (km > prefix) {
        slot = gt_at++;
      } else if (km == prefix) {
        if (eq_at < kk) slot = n_above + eq_at;
        ++eq_at;
      }
      if (slot >= 0) {
        sk[slot] = key;
        si[slot] = i;
      }
    };
    if (cached) {
#pragma unroll
      for (int u = 0; u < SEL_ITEMS; ++u)
        if (lo + u < hi) place(kr[u], lo + u);
    } else {
      for (int i = lo; i < hi; ++i) place(score_key(sc[i]), i);
    }
  }
  for (int t = k + tid; t < npad; t += SEL_THREADS) {
    sk[t] = 0u;  // below every real key
    si[t] = INT_MAX;
  }
  __syncthreads();

  // bitonic sort, first = (key desc, id asc).  Up to SEL_THREADS / 2
  // slots, thread t < npad holds slot t in registers: a stage whose partner
  // lies in the warp (j < 32) is a shuffle, the others exchange through one
  // of two halves of shared memory in turn (one barrier a stage, over the
  // sorting warps only).  The other warps only write padding outputs.
  if (2 * npad <= SEL_THREADS) {
    for (int t = npad + tid; t < n_c; t += SEL_THREADS) {
      idx[(size_t)b * n_c + t] = 0;
      valid[(size_t)b * n_c + t] = 0;
    }
    if (tid >= npad) return;
    uint32_t key = sk[tid];
    int id = si[tid];
    int half = 0;
    for (int k2 = 2; k2 <= npad; k2 <<= 1) {
      for (int jj = k2 >> 1; jj > 0; jj >>= 1) {
        uint32_t pk;
        int pi;
        if (jj < 32) {
          pk = __shfl_xor_sync(0xffffffffu, key, jj);
          pi = __shfl_xor_sync(0xffffffffu, id, jj);
        } else {
          uint32_t* xk = sk + half * npad;
          int* xi = reinterpret_cast<int*>(sk + 2 * npad) + half * npad;
          half ^= 1;
          xk[tid] = key;
          xi[tid] = id;
          asm volatile("bar.sync 1, %0;\n" ::"r"(npad) : "memory");
          pk = xk[tid ^ jj];
          pi = xi[tid ^ jj];
        }
        const bool mine_first = key > pk || (key == pk && id < pi);
        if (mine_first != (((tid & jj) == 0) == ((tid & k2) == 0))) {
          key = pk;
          id = pi;
        }
      }
    }
    if (tid < n_c) {
      const size_t o = (size_t)b * n_c + tid;
      const bool real = tid < k;
      idx[o] = real ? id : 0;
      valid[o] = real && key_score(key) > 0.5f * SALS_NEG_INF;
    }
    return;
  }
  for (int k2 = 2; k2 <= npad; k2 <<= 1) {
    for (int jj = k2 >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < npad; i += SEL_THREADS) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const uint32_t ki = sk[i], kj = sk[ixj];
          const int ii = si[i], ij = si[ixj];
          const bool j_first = (kj > ki) || (kj == ki && ij < ii);
          const bool i_first = (ki > kj) || (ki == kj && ii < ij);
          if (((i & k2) == 0) ? j_first : i_first) {
            sk[i] = kj;
            sk[ixj] = ki;
            si[i] = ij;
            si[ixj] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = tid; t < n_c; t += SEL_THREADS) {
    const size_t o = (size_t)b * n_c + t;
    const bool real = t < k;
    idx[o] = real ? si[t] : 0;
    valid[o] = real && key_score(sk[t]) > 0.5f * SALS_NEG_INF;
  }
}

static int launch_select(const float* scores, int* idx, unsigned char* valid,
                         int B, int S, int n_c, cudaStream_t stream) {
  const int k = min(n_c, S);
  int npad = 32;
  while (npad < k) npad <<= 1;
  // keys and ids; the sort in registers exchanges through two halves of each
  const size_t smem = (size_t)(2 * npad <= SEL_THREADS ? 2 : 1) * npad *
                      (sizeof(uint32_t) + sizeof(int));
  if (smem > SMEM_LIMIT - 4096) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(topk_select_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  topk_select_kernel<<<B, SEL_THREADS, smem, stream>>>(scores, S, n_c, npad,
                                                       idx, valid);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

// Which kernels a top-k call launches: both on every serving call; one
// alone only to time it.
enum { TOPK_SCORE = 1, TOPK_SELECT = 2 };

template <bool PAGED>
static int topk_call(const ScoreArgs& a, int k_dtype, int B, int n_c,
                     void* idx, void* valid, int parts, void* stream) {
  if (B < 1 || a.S < 0 || n_c < 0 || a.r_star < 1 || a.r_star > a.r)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((parts & TOPK_SCORE) && a.S > 0) {
    const int err = dispatch_score_pass<PAGED, true>(k_dtype, a, B, st);
    if (err != 0) return err;
  }
  if ((parts & TOPK_SELECT) && n_c > 0)
    return launch_select(a.out, static_cast<int*>(idx),
                         static_cast<unsigned char*>(valid), B, a.S, n_c, st);
  return 0;
}

// q_lat (B, r*) f32; k_lat (B, S, r) f32 / bf16 / int8; k_scale (B, S) bf16
// or null; pos, pos_base (B,) int32; scores (B, S) f32 scratch; idx (B, N_c)
// int32; valid (B, N_c) bool.  `vec`: rows and r* allow 16-byte copies.
// `parts`: TOPK_SCORE | TOPK_SELECT.
extern "C" int sals_latent_topk(const void* q_lat, const void* k_lat,
                                int k_dtype, const void* k_scale,
                                const void* pos, const void* pos_base,
                                void* scores, void* idx, void* valid, int B,
                                int S, int r, int r_star, int n_critical,
                                int n_sink, int n_recent, int vec, int parts,
                                void* stream) {
  const ScoreArgs a{static_cast<const float*>(q_lat),
                    k_lat,
                    static_cast<const __nv_bfloat16*>(k_scale),
                    static_cast<const int*>(pos),
                    static_cast<const int*>(pos_base),
                    static_cast<float*>(scores),
                    S, r, r_star, n_sink, n_recent, vec,
                    TopkLayout{nullptr, 0, 0, 0}};
  return topk_call<false>(a, k_dtype, B, n_critical, idx, valid, parts,
                          stream);
}

// Paged: k_lat (n_pages, ps, r) and k_scale (n_pages, ps) pools, page_table
// (B, mp) int32; S = mp * ps is the logical extent.
extern "C" int sals_latent_topk_paged(
    const void* q_lat, const void* k_lat, int k_dtype, const void* k_scale,
    const void* pos, const void* pos_base, const void* page_table,
    void* scores, void* idx, void* valid, int B, int S, int r, int r_star,
    int n_critical, int n_sink, int n_recent, int vec, int parts, int mp,
    int ps, int n_pages, void* stream) {
  if (mp < 1 || ps < 1 || n_pages < 1 || S != mp * ps)
    return (int)cudaErrorInvalidValue;
  const ScoreArgs a{static_cast<const float*>(q_lat),
                    k_lat,
                    static_cast<const __nv_bfloat16*>(k_scale),
                    static_cast<const int*>(pos),
                    static_cast<const int*>(pos_base),
                    static_cast<float*>(scores),
                    S, r, r_star, n_sink, n_recent, vec,
                    TopkLayout{static_cast<const int*>(page_table), mp, ps,
                               n_pages}};
  return topk_call<true>(a, k_dtype, B, n_critical, idx, valid, parts,
                         stream);
}

// Plain scores: q_lat (B, r*) f32, k_lat (B, S, r) f32 / bf16 / int8, r* <=
// r; k_scale (B, S) bf16 or null; out (B, S) f32.
extern "C" int sals_latent_score(const void* q_lat, const void* k_lat,
                                 int k_dtype, const void* k_scale, void* out,
                                 int B, int S, int r, int r_star, int vec,
                                 void* stream) {
  if (B < 1 || S < 1 || r_star < 1 || r_star > r)
    return (int)cudaErrorInvalidValue;
  const ScoreArgs a{static_cast<const float*>(q_lat),
                    k_lat,
                    static_cast<const __nv_bfloat16*>(k_scale),
                    nullptr,
                    nullptr,
                    static_cast<float*>(out),
                    S, r, r_star, 0, 0, vec,
                    TopkLayout{nullptr, 0, 0, 0}};
  return dispatch_score_pass<false, false>(k_dtype, a, B,
                                           static_cast<cudaStream_t>(stream));
}
