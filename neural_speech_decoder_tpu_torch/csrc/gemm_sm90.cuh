// A bf16 matrix product for Hopper: TMA loads into a ring of shared-memory
// stages and wgmma on them, float32 sums in registers, each sum handed to an
// epilogue functor.
//   epi(m, n, sum_k A(m, k) B(k, n) + bias[n], split)   for every m < M, n < N
// (bias a float32 vector, or null).
// A and B are bf16 row-major arrays read where they lie; which axis of each
// is contiguous is a template flag, so the three layouts need no copies:
//   A K-major: a [M, K]          A M-major (kAT): a [K, M]
//   B K-major: b [N, K]          B N-major (kBT): b [K, N]
// (nn: K-major A, N-major B; nt: both K-major; tn: M-major A, N-major B.)
//
// The design. A block owns a 128 x 256 tile of the output and walks its K
// range in steps of 64. Four stages of 48 KB (A 128 x 64, B 64 x 256, bf16)
// form a ring in shared memory. Warpgroup 0 is the producer: one thread
// issues the TMA copies of a stage (cp.async.bulk.tensor, the 128-byte
// swizzle) and the copies' byte count completes the stage's "full"
// mbarrier. Warpgroups 1 and 2 are the consumers, 64 rows each: they wait on
// "full", run four wgmma.mma_async m64n256k16 (bf16 operands read by
// shared-memory descriptors, float32 accumulators, 128 a thread), wait for
// them and arrive on the stage's "empty" mbarrier, which lets the producer
// refill it. The K-major/MN-major choice is the descriptors' transpose bits
// (legal for 16-bit types), with the descriptor strides of the swizzled
// layout each TMA box gives:
//   K-major tile [rows][64]: rows of 128 bytes; 8-row groups 1024 bytes
//     apart (SBO), a k16 step 32 bytes on;
//   MN-major tile [MN/64][64 k][64]: boxes of 64 k rows of 128 bytes; 8-row
//     groups 1024 bytes apart (SBO), 64-wide MN blocks 8 KB apart (LBO), a
//     k16 step 2 KB on.
// The ragged edges (M, N or K not a multiple of the tile) come from TMA's
// zero fill out of bounds, which adds exact zeros to the sums, and from the
// epilogue's masks. `splits` > 1 cuts K into that many ranges of a multiple
// of 64 (grid.z; a product whose output has few tiles and whose K is long,
// as a dW over all B*T rows, fills the card that way), and the epilogue gets
// each range's partial sum with its index (SplitStore, then split_sum in
// gemm_tile.cuh adds them in order). Each partial sum runs over its range in
// one fixed order in one block, with no atomics, so a rerun gives the same
// bits.
//
// The epilogue functor is called from the accumulator registers as
//   epi.pair(m, n, acc_n, acc_n1, split)
// with the two neighbouring columns a thread holds (n even), so that it can
// store them at once (4 or 8 bytes); StoreF32 and SplitStore of
// gemm_tile.cuh have it beside the tile's operator()(m, n, acc, split). An
// epilogue is kept to stores: it runs on the two consumer warpgroups of
// one block an SM, behind the main loop, so element math belongs in a pass
// of its own (rowops.cuh::each_cols). The bias is the kernel's own: the tile's 256 columns are
// staged in shared memory while the first stages load and added to the
// float32 sums before the epilogue, so that no load of it waits behind the
// epilogue's stores. The projection matmul (matmul.cu) is bias + StoreBf16,
// one rounding.
//
// TMA wants 16-byte aligned base pointers and row strides: the host entry
// refuses other operands (the caller sends them to gemm_tile.cuh).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver enums; the driver's encoder
                   // is reached through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"  // SplitStore, split_sum

namespace nsd {
namespace sm90 {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBBytes = kBN * kBK * 2;   // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 64 * 64 * 2;        // one 64 x 64 MN-major box, 8 KB
// the ring, its barriers, the block's bias columns, and room to align the
// ring to 1024 bytes (the 128-byte swizzle's period)
constexpr size_t kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + kBN * 4 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A 2-D box of the tensor map at (c0 inner, c1 outer) into shared memory at
// dst; its bytes complete the transaction count of bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (all in 16-byte units), the 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d[64 x 256 of this warpgroup] += A (64 x 16) . B (16 x 256); kTA/kTB: the
// operand is MN-major (transposed).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %130, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "n"(kTA), "n"(kTB), "r"(1));
}

// out [M, ld] = bf16(acc): the float32 sum rounded once, two columns a store.
struct StoreBf16 {
  __nv_bfloat16* out;
  int ld;
  __device__ __forceinline__ void pair(int m, int n, float v0, float v1, int) const {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * ld + n) = __floats2bfloat162_rn(v0, v1);
  }
};

template <bool kAT, bool kBT, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const float* __restrict__ bias,
                     const Epi epi, int M, int N, int K, int kc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * kStageBytes;  // kStages barriers
  const uint32_t empty = full + kStages * 8;           // kStages barriers
  float* sbias = reinterpret_cast<float*>(smem_raw + (empty + kStages * 8 - raw));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  // this block's K range [k_lo, k_hi); kc is a multiple of kBK
  const int k_lo = z * kc, k_hi = min(K, k_lo + kc);
  const int nk = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t a = ring + s * kStageBytes, b = a + kABytes;
        const int k0 = k_lo + kt * kBK;
        mbar_expect_tx(bar, kStageBytes);
        if (kAT) {
          tma_load(a, &ta, m0, k0, bar);
          tma_load(a + kBox, &ta, m0 + 64, k0, bar);
        } else {
          tma_load(a, &ta, k0, m0, bar);
        }
        if (kBT) {
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j) tma_load(b + j * kBox, &tb, n0 + 64 * j, k0, bar);
        } else {
          tma_load(b, &tb, k0, n0, bar);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // rows c*64 .. c*64+63 of the block tile
    // the tile's bias columns, read once while the first stages load
    const int col = threadIdx.x - 128;
    if (bias) sbias[col] = n0 + col < N ? bias[n0 + col] : 0.f;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);
      // both MN-major and K-major A put this warpgroup's 64 rows 8 KB on
      const uint32_t a = ring + s * kStageBytes + c * kBox, b = ring + s * kStageBytes + kABytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = kAT ? smem_desc(a + kk * 2048, kBox, 1024)
                                : smem_desc(a + kk * 32, 16, 1024);
        const uint64_t db = kBT ? smem_desc(b + kk * 2048, kBox, 1024)
                                : smem_desc(b + kk * 32, 16, 1024);
        wgmma_m64n256k16<kAT ? 1 : 0, kBT ? 1 : 0>(d, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (tid == 0) mbar_arrive(empty + 8 * s);
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers: sbias written
    // d[4j + r]: row w*16 + lane/4 + 8*(r/2), column 8j + 2*(lane%4) + r%2
    const int warp = tid / 32, lane = tid % 32;
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= N) continue;  // N is even: n + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M) continue;
        float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (bias) {
          v0 += sbias[n - n0];
          v1 += sbias[n - n0 + 1];
        }
        epi.pair(m, n, v0, v1, z);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no -lcuda); null where the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 [outer, inner] array read in boxes of
// [box_outer, 64], swizzled by 128 bytes, zero outside the array.
inline bool make_map(CUtensorMap* map, const void* p, int inner, int outer, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K-range length of a product cut into `splits` ranges: a multiple of kBK,
// so that every range but the last ends on a k-step.
inline int split_len(int K, int splits) {
  return round_up((K + splits - 1) / splits, kBK);
}

// epi(m, n, A . B over each of `splits` K ranges (+ bias[n], may be null;
// with one range only), range index) on stream st; a is [K, M] when kAT
// else [M, K], b is [K, N] when kBT else [N, K]. Both pointers 16-byte
// aligned, and the contiguous extents (M or K of a, N or K of b) and N
// multiples of 8: cudaErrorInvalidValue otherwise; cudaErrorNotSupported
// without the driver's tensor-map encoder.
template <bool kAT, bool kBT, class Epi>
cudaError_t gemm(const __nv_bfloat16* a, const __nv_bfloat16* b, const float* bias,
                 const Epi& epi, int M, int N, int K, int splits, cudaStream_t st) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 65535 || (bias && splits > 1) ||
      !aligned(a) || !aligned(b) ||
      (kAT ? M : K) % 8 || (kBT ? N : K) % 8 || N % 8 || (M + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if (!encode_tiled()) return cudaErrorNotSupported;
  CUtensorMap ta, tb;
  const bool ok = (kAT ? make_map(&ta, a, M, K, 64) : make_map(&ta, a, K, M, kBM)) &&
                  (kBT ? make_map(&tb, b, N, K, 64) : make_map(&tb, b, K, N, kBN));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = gemm_sm90_kernel<kAT, kBT, Epi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, kSmemBytes, st>>>(ta, tb, bias, epi, M, N, K,
                                              split_len(K, splits));
  return cudaGetLastError();
}

// out [M, N] (bf16) = a^T . b summed over K, a [K, M] and b [K, N] (a dW
// over all B*T rows): in `splits` K ranges whose float32 partial sums go to
// ws [splits][M][N] and are added in order (split_sum), rounded once to
// bf16; one range rounds its sums straight to bf16.
inline cudaError_t gemm_tn_split(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                 __nv_bfloat16* out, int M, int N, int K, int splits,
                                 float* ws, cudaStream_t st) {
  if (splits <= 1) return gemm<true, true>(a, b, nullptr, StoreBf16{out, N}, M, N, K, 1, st);
  NSD_TRY((gemm<true, true>(a, b, nullptr, SplitStore{ws, M, N}, M, N, K, splits, st)));
  return split_sum<__nv_bfloat16>(ws, out, splits, (size_t)M * N, st);
}

}  // namespace sm90
}  // namespace nsd
