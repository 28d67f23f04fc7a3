// Hopper data movement shared by the port's kernels (sm_90a): TMA tensor
// maps (host), mbarriers, TMA loads, cp.async gathers and the proxy fence.
//
// cuTensorMapEncodeTiled is a driver function.  It is reached through the
// runtime's cudaGetDriverEntryPoint, so the kernel library links no -lcuda:
// <cuda.h> is included for the CUtensorMap type and its enums only.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*SalsEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static SalsEncodeTiled sals_encode_tiled() {
  static SalsEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<SalsEncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; byte strides of
// dimensions 1..rank-1), boxes of `box` elements, 128-byte swizzle (box[0]
// must be 64: one 128-byte row), zero fill outside the tensor.  Returns 0
// or a CUDA error code.
static inline int sals_tmap_bf16(CUtensorMap* map, const void* base,
                                 int rank, const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box) {
  const SalsEncodeTiled fn = sals_encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  auto encode = [&]() {
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
              const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r != CUDA_SUCCESS) {
    // A host thread that has not yet made a runtime call (autograd's
    // backward thread, say) may have no current context, which the driver
    // call needs: make the tensor's device current, then try again.
    cudaPointerAttributes attr;
    if (cudaPointerGetAttributes(&attr, base) == cudaSuccess &&
        cudaSetDevice(attr.device) == cudaSuccess)
      r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Columns that a tile of head_dim dh takes in shared memory: whole
// 64-column boxes (dh 80 takes dh 128's two).  The tensor map covers the
// true dh, so TMA moves only the true row from HBM and zero-fills the
// columns past it; the mbarrier still counts the whole box.
__host__ __device__ constexpr int sals_tile_dh(int dh) {
  return (dh + 63) / 64 * 64;
}

// 4-D map (dh, heads, S, B) of a (B, S, heads, dh) bf16 tensor, boxes of
// 64 x 1 x rows x 1: a tile of `rows` rows of one head is
// sals_tile_dh(dh) / 64 boxes.  dh * 2 bytes (the row stride) must be a
// multiple of 16, as TMA requires: dh 80's 160 is.
static inline int sals_tmap_bshd(CUtensorMap* map, const void* p, int B,
                                 int S, int heads, int dh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return sals_tmap_bf16(map, p, 4, dims, strides, box);
}

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sals_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   sals_smem(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   sals_smem(bar))
               : "memory");
}

// Arrive and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sals_smem(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Spin until the phase of parity `parity` has completed.  A phase that has
// not completed after ~2^33 cycles (seconds) is a fault of the kernel: trap,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = sals_smem(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// An arrive on `bar` once every cp.async this thread issued so far has
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   sals_smem(bar))
               : "memory");
}

// 16-byte cp.async; src_bytes < 16 fills the rest with zeros (0: all).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Order this thread's generic-proxy shared-memory accesses (plain stores,
// cp.async) with the async proxy's (wgmma operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Barrier `id` without waiting: this thread's arrival counts towards the
// `n` threads a bar.sync on `id` waits for.
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16; both addresses on 16
// bytes) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sals_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(sals_smem(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sals_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sals_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(sals_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sals_smem(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Register budget of a warpgroup (all four warps execute it together).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
