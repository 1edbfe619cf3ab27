// Shared helpers for the port's hand-written kernels: element-type
// conversions between the storage type (float or bfloat16) and the float32
// the kernels compute in, the cp.async copies into shared memory, the
// ldmatrix loads and mma.sync product of the tensor-core bodies, the barrier
// of the persistent bodies, and NSD_TRY for host code that launches several.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Return the CUDA error of expr, if any, from the calling function.
#define NSD_TRY(expr)                 \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

namespace nsd {

// v rounded up to a multiple of m.
__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back: what a float32 value becomes after a
// cast to the storage type.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The shared-memory address of p, as the PTX instructions take it.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


// ldmatrix: 8x8 tiles of 16-bit values from shared memory into mma
// fragments. x2 reads the rows addressed by lanes 0-15 (lanes 16-31 repeat
// them), x4 by lanes 0-31; .trans hands out the transposed tiles.
__device__ __forceinline__ void ldsm_x2(const __nv_bfloat16* p, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4(const __nv_bfloat16* p, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const __nv_bfloat16* p, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) . b (16x8, col), bf16 operands, float32 sums.
// Accumulator layout (lane = 4g + t): c[0] (row g, col 2t), c[1] (g, 2t+1),
// c[2] (g+8, 2t), c[3] (g+8, 2t+1).
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cp_async_wait with a count known only at run time (0..3).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Parts of a persistent GRU scan step that a build with -DNSD_SCAN_CUT=<bits>
// leaves out, so that tools/scan_ablation.py can time what is left (such a
// build computes wrong numbers): bit 0 the barrier between steps, bit 1 the
// load of the previous state (forward) or dhp row (backward), bit 2 the
// products. The library is built without it: nothing is left out.
#ifndef NSD_SCAN_CUT
#define NSD_SCAN_CUT 0
#endif
constexpr bool kCutBarrier = (NSD_SCAN_CUT & 1) != 0;
constexpr bool kCutLoad = (NSD_SCAN_CUT & 2) != 0;
constexpr bool kCutMma = (NSD_SCAN_CUT & 4) != 0;

// Barrier of the blocks of a persistent (cooperatively launched, so all
// co-resident) grid that share the counter ctr, zeroed before the launch:
// each arrives once per round, and round k waits until the counter reaches
// target = k * (blocks sharing it). The arrival is a release and the wait an
// acquire (the block's writes before it are visible to every block after
// it; read them through L2, with ld.global.cg or cp.async.cg, since L1 is
// not coherent). It counts arrivals, no value is summed. A wait longer than
// about two seconds traps, so that a fault shows as a launch error and not
// as a hang.
__device__ __forceinline__ void group_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr) : "memory");
    const long long start = clock64();
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(ctr) : "memory");
      if (seen >= target) break;
      if (clock64() - start > 4000000000LL) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// How many blocks of kernel (threads a block, smem bytes of dynamic shared
// memory each) the card holds at once, or -1 on an error.
inline int coresident_blocks(const void* kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess) {
    cudaGetLastError();  // clear what was set
    return -1;
  }
  return per_sm * sms;
}

}  // namespace nsd
