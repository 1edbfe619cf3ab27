// The projection matmul's float32 body: C[m, n] = sum_k A(k, m) * B(k, n) on
// float32 FMAs, read straight from row-major float32 operands, with the
// float32 bias added to the sum (the result is float32, so nothing rounds).
// Each operand is either k-major (element (k, i) at p[k * ld + i]: nn's B,
// tn's A and B) or i-major (at p[i * ld + k]: nn's and nt's A, nt's B), so
// the three layouts of matmul.cu need no transposed copy.
//
// The classic full-float32 SIMT tile: 128 x 128 of the output per block, k
// slabs of 16, 256 threads each forming an 8 x 8 micro-tile (rows ty*4.. and
// 64+ty*4.., columns tx*4.. and 64+tx*4..) from 128-bit shared loads of
// k-major slabs As[16][128+4], Bs[16][128+4] (the two 4-wide halves 64 apart:
// a quarter warp's B loads cover 128 contiguous bytes, its A loads are
// broadcasts). Two stages: while slab k is multiplied, slab k+1 is in
// flight. A k-major operand comes by cp.async.cg 16-byte copies straight
// into shared memory (zero-filled past the ragged edge); an i-major one is
// loaded into registers (float4 along k) before the FMAs and stored
// transposed after them. No TF32 and no wgmma (its float32 is TF32): the
// products are the float32 FMA's. Each output's sum runs over k in one
// fixed order in one thread, so a rerun gives the same bits; no atomics.
//
// What bounds it on an H100: the operations, 2*M*N*K flops at 67 TFLOP/s
// (7.524 ms at the GRU projection's 20032 x 6144 x 2048). The operands need
// the contiguous extents (ld and the tile's i range) to be multiples of 4
// and 16-byte aligned pointers; the caller (ops/kernels/matmul.py::
// matmul_body) sends every other float32 product to gemm_tile.cuh.
//
// The tile itself (gemm_f32_tile) also takes a k-major operand whose rows
// come in groups (GroupedSlabs: row k at (k / group) * gstride + (k % group)
// * ld), the strided time-step views that gru_scan_bwd.cu's float32 dW_hh
// contraction reads; an A operand that smooths a trial's rows along time as
// its slabs load (SmoothedSlabs, frontend.cu's float32 body); an output row
// stride of its own; and an epilogue functor applied to each 4-wide group of
// outputs after the bias (NoEpilogue, the default, stores them as they are).
//
// gemm_split (the fused FF and conv-module backwards' f32 bodies) launches
// the tile over K ranges: grid.z cuts K into `splits` ranges, each a
// multiple of the 16-deep slab (the last ends at K), whose float32 partial
// sums go to ws [splits][M][N] and are added in order by split_sum
// (gemm_tn_split); one range writes the product itself. gemm (matmul.cu)
// is its one range.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"  // split_sum

namespace nsd {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kTile = 128;      // output rows and columns of a block
constexpr int kSlab = 16;       // k per stage
constexpr int kLd = kTile + 4;  // row stride of a [kSlab][kTile] shared slab
constexpr int kChunks = kSlab * kTile / 4 / kThreads;  // float4 a thread moves a slab

// threadIdx.x read anew where it is used: a loader that takes its thread
// index from here forms its per-thread offsets inside the tile's loop, where
// the compiler would otherwise keep them in registers across it (and, next
// to the tile's 64 sums at two blocks an SM, spill them).
__device__ __forceinline__ int tid_anew() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// One operand's slabs for the block whose tile starts at i0 of the operand's
// extent (rows of A, columns of B). fetch() starts slab k0's way into dst
// (k-major) or into registers (i-major); put() stores the registers into dst
// transposed (i-major; nothing to do for k-major).
template <bool kKMajor>
struct Slabs;

template <>
struct Slabs<true> {
  const float* p;
  int ld, extent, i0;
  // kSlab rows of 32 float4: chunks tid, tid + 256, ...
  __device__ __forceinline__ void fetch(float* dst, int k0, int K, int tid = threadIdx.x) {
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int c = tid + r * kThreads, k = c / 32, i = (c % 32) * 4;
      const bool ok = k0 + k < K && i0 + i < extent;
      cp_async16(dst + k * kLd + i, ok ? p + (size_t)(k0 + k) * ld + i0 + i : p, ok);
    }
  }
  __device__ __forceinline__ void put(float*) const {}
};

template <>
struct Slabs<false> {
  const float* p;
  int ld, extent, i0;
  float4 v[kChunks];  // 128 rows of kSlab / 4 float4 along k: chunks tid, tid + 256, ...
  __device__ __forceinline__ void fetch(float*, int k0, int K) {
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int c = threadIdx.x + r * kThreads, i = c / (kSlab / 4), k = (c % (kSlab / 4)) * 4;
      v[r] = i0 + i < extent && k0 + k < K
                 ? *reinterpret_cast<const float4*>(p + (size_t)(i0 + i) * ld + k0 + k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int c = threadIdx.x + r * kThreads, i = c / (kSlab / 4), k = (c % (kSlab / 4)) * 4;
      dst[(k + 0) * kLd + i] = v[r].x;
      dst[(k + 1) * kLd + i] = v[r].y;
      dst[(k + 2) * kLd + i] = v[r].z;
      dst[(k + 3) * kLd + i] = v[r].w;
    }
  }
};

// A k-major operand whose row k lies at p[(k / group) * gstride + (k % group)
// * ld]: Slabs<true> over rows that come in groups (time steps of B rows,
// D*B rows apart).
struct GroupedSlabs {
  const float* p;
  int ld, extent, i0, group;
  size_t gstride;
  __device__ __forceinline__ void fetch(float* dst, int k0, int K) {
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int c = threadIdx.x + r * kThreads, k = c / 32, i = (c % 32) * 4;
      const int row = k0 + k;
      const bool ok = row < K && i0 + i < extent;
      const float* src =
          p + (size_t)(row / group) * gstride + (size_t)(row % group) * ld + i0 + i;
      cp_async16(dst + k * kLd + i, ok ? src : p, ok);
    }
  }
  __device__ __forceinline__ void put(float*) const {}
};

// The A operand A(k, m) = sum_j a.taps.v[j] * x[m - a.pad_left + j][k] of
// one trial x [a.n_time][a.n_ch] of a.x (rows outside [0, n_time) read as
// zero): the serving frontend's smoothing along time, formed as the slabs
// load. kTaps taps, or with kTaps = 0 a.n_taps of at most the capacity of
// a.taps.v. `a` is the kernel's __grid_constant__ parameter block, held by
// reference so that every read of it is a kernel-parameter operand and not
// a register (the tile's 64 sums leave little room at two blocks an SM).
//
// fetch(k0) starts by cp.async the raw rows of the slab after k0's (the
// tile's 128 rows and their taps - 1 halo rows, 16 channels; zero-filled
// outside the trial and past K; offsets from tid_anew) into one of two
// slots of a ring in dynamic shared memory (kRingFloats); put() smooths
// slab k0's rows from its slot into dst. So each slab's rows are in flight
// two slabs ahead, and the tile's wait and barrier before its FMAs make
// them whole before the put that follows the FMAs. The first fetch (k0 = 0)
// starts slab 0's rows too, in a group of their own, and the first put
// waits for them and for every thread, smooths, and waits for every thread
// again (the next fetch reuses slot 0). Thread (c, s) smooths channel c, rows 8s..8s+7 from a sliding
// window of its column: each output's taps added in order j = 0, 1, ... by
// fused multiply-adds from 0 (frontend.cu's FMA body's arithmetic). The two
// 8-row strips a warp reads share banks (rows 8 apart, 16 floats each); on
// an H100 that conflict cost less than the registers of a swizzled layout's
// addresses, which spilled.
template <int kTaps, class Args>
struct SmoothedSlabs {
  static constexpr int kWin =
      kTaps ? kTaps : int(sizeof(decltype(Args::taps)) / sizeof(float));
  static constexpr int kStrip = 8;  // rows a thread smooths
  static constexpr int kRingRows = kTile + kWin - 1;
  static constexpr int kSlotFloats = kRingRows * kSlab;
  static constexpr int kRingFloats = 2 * kSlotFloats;
  static_assert(kSlab * (kTile / kStrip) == kThreads, "a thread a (channel, strip)");
  const Args& a;
  const float* p;  // the trial's first row
  int i0;          // the tile's first row
  int slab;        // the slab the next put() smooths

  static __device__ __forceinline__ float* ring() {
    extern __shared__ __align__(16) float smoothed_ring[];
    return smoothed_ring;
  }

  __device__ __forceinline__ void load(int s, int K) {
    const int rows = kTile + (kTaps ? kTaps : a.n_taps) - 1;
    float* slot = ring() + (s & 1) * kSlotFloats;
    const int k = s * kSlab;
#pragma unroll
    for (int u = 0; u < (kRingRows * 4 + kThreads - 1) / kThreads; ++u) {
      const int c = tid_anew() + u * kThreads, r = c / 4, ch = k + (c % 4) * 4;
      const int src = i0 - a.pad_left + r;
      if (r < rows) {
        const bool ok = src >= 0 && src < a.n_time && ch < K;
        cp_async16(slot + r * kSlab + (c % 4) * 4,
                   ok ? p + (size_t)src * a.n_ch + ch : p, ok);
      }
    }
  }
  __device__ __forceinline__ void fetch(float*, int k0, int K) {
    slab = k0 / kSlab;
    if (k0 == 0) {
      load(0, K);
      cp_async_commit();
    }
    if (k0 + kSlab < K) load(slab + 1, K);
  }
  __device__ __forceinline__ void put(float* dst) const {
    if (slab == 0) {
      cp_async_wait<1>();
      __syncthreads();
    }
    const float* slot = ring() + (slab & 1) * kSlotFloats;
    const int c = threadIdx.x % kSlab, r0 = threadIdx.x / kSlab * kStrip;
    float acc[kStrip];
#pragma unroll
    for (int r = 0; r < kStrip; ++r) acc[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kStrip + kWin - 1; ++q) {
      if (kTaps == 0 && q >= kStrip + a.n_taps - 1) continue;  // past the window's rows
      const float v = slot[(r0 + q) * kSlab + c];
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        const int j = q - r;
        if (j >= 0 && j < kWin && (kTaps != 0 || j < a.n_taps))
          acc[r] = fmaf(a.taps.v[j], v, acc[r]);
      }
    }
    *reinterpret_cast<float4*>(dst + c * kLd + r0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst + c * kLd + r0 + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (slab == 0) __syncthreads();
  }
};

// The tile's default epilogue: outputs stored as they are.
struct NoEpilogue {
  __device__ __forceinline__ float4 operator()(float4 v) const { return v; }
};

// The block's tile of out [M, N] (row stride ldo) = epi(A . B + bias) (bias
// [N] may be null), its rows from sa.i0 and columns from sb.i0; A's extent is
// M, B's N, both K long along the sum.
template <class SA, class SB, class Epi = NoEpilogue>
__device__ __forceinline__ void gemm_f32_tile(SA& sa, SB& sb, int M, int N, int K,
                                              const float* __restrict__ bias,
                                              float* __restrict__ out, int ldo,
                                              Epi epi = Epi()) {
  __shared__ __align__(16) float As[2][kSlab * kLd];
  __shared__ __align__(16) float Bs[2][kSlab * kLd];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = sa.i0, n0 = sb.i0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int slabs = (K + kSlab - 1) / kSlab;
  sa.fetch(As[0], 0, K);
  sb.fetch(Bs[0], 0, K);
  cp_async_commit();
  sa.put(As[0]);
  sb.put(Bs[0]);
  for (int s = 0; s < slabs; ++s) {
    const int cur = s & 1;
    const bool next = s + 1 < slabs;
    if (next) {
      sa.fetch(As[cur ^ 1], (s + 1) * kSlab, K);
      sb.fetch(Bs[cur ^ 1], (s + 1) * kSlab, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[cur];
    const float* bs = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kLd + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kLd + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kLd + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kLd + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) {
      sa.put(As[cur ^ 1]);
      sb.put(Bs[cur ^ 1]);
    }
    __syncthreads();
  }
  // N is a multiple of 4, so a 4-wide group is all in or all out
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + tx * 4;
      if (n >= N) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]);
      if (bias) {
        v.x += bias[n];
        v.y += bias[n + 1];
        v.z += bias[n + 2];
        v.w += bias[n + 3];
      }
      *reinterpret_cast<float4*>(out + (size_t)m * ldo + n) = epi(v);
    }
  }
}

// The length of each of `splits` K ranges: a multiple of the slab
// (ops/kernels/ffn.py::split_len with the slab as its step).
inline int split_len(int K, int splits) { return round_up((K + splits - 1) / splits, kSlab); }

// out [M, N] (row stride N) = A . B + bias (bias [N] may be null); A's
// extent is M, B's N, both K long along the sum. kSplit: K is cut into
// gridDim.z ranges kc long (the last ending at K), range z summed into out +
// z * M * N with no bias, each operand read from the range's first k (p +
// k_lo * ld k-major, p + k_lo i-major: 16-byte aligned, kc being a multiple
// of 16). Else one range with the operands and out as given: kernel
// parameters, which the loop reads where they lie, where pointers derived
// from them would take registers (at nt's 128-register cap they spilled and
// slowed the projection's nt product on an H100). kBlocks: the blocks an SM
// is to hold (2 caps the registers at 128 a thread).
template <bool kAK, bool kBK, int kBlocks, bool kSplit>
__global__ void __launch_bounds__(kThreads, kBlocks)
    gemm_f32_kernel(int M, int N, int K, int kc, const float* __restrict__ a, int lda,
                    const float* __restrict__ b, int ldb, const float* __restrict__ bias,
                    float* __restrict__ out) {
  if constexpr (kSplit) {
    const int k_lo = (int)blockIdx.z * kc;
    Slabs<kAK> sa{a + (kAK ? (size_t)k_lo * lda : (size_t)k_lo), lda, M,
                  (int)blockIdx.y * kTile};
    Slabs<kBK> sb{b + (kBK ? (size_t)k_lo * ldb : (size_t)k_lo), ldb, N,
                  (int)blockIdx.x * kTile};
    gemm_f32_tile(sa, sb, M, N, min(K, k_lo + kc) - k_lo, nullptr,
                  out + (size_t)blockIdx.z * M * N, N);
  } else {
    Slabs<kAK> sa{a, lda, M, (int)blockIdx.y * kTile};
    Slabs<kBK> sb{b, ldb, N, (int)blockIdx.x * kTile};
    gemm_f32_tile(sa, sb, M, N, K, bias, out, N);
  }
}

// Launch out = A . B (+ bias) over `splits` K ranges on stream st; see
// gemm_f32_kernel. Every range must hold rows, and a bias goes with one
// range only: cudaErrorInvalidValue otherwise. N is a multiple of 4 with
// out 16-byte aligned. Two blocks an SM, but one for an i-major A with a
// k-major B (nn): capped at 128 registers that one spills, and on an H100
// one block without the cap ran faster at the GRU projection's shapes.
template <bool kAK, bool kBK>
cudaError_t gemm_split(const float* a, int lda, const float* b, int ldb, const float* bias,
                       float* out, int M, int N, int K, int splits, cudaStream_t st) {
  constexpr int kBlocks = !kAK && kBK ? 1 : 2;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 65535 || (bias && splits > 1) ||
      (long long)(splits - 1) * split_len(K, splits) >= K || (M + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  const int kc = split_len(K, splits);
  if (splits == 1)
    gemm_f32_kernel<kAK, kBK, kBlocks, false>
        <<<grid, kThreads, 0, st>>>(M, N, K, kc, a, lda, b, ldb, bias, out);
  else
    gemm_f32_kernel<kAK, kBK, kBlocks, true>
        <<<grid, kThreads, 0, st>>>(M, N, K, kc, a, lda, b, ldb, bias, out);
  return cudaGetLastError();
}

// out [M, N] = A . B (+ bias) in one K range (matmul.cu).
template <bool kAK, bool kBK>
cudaError_t gemm(const float* a, int lda, const float* b, int ldb, const float* bias,
                 float* out, int M, int N, int K, cudaStream_t st) {
  return gemm_split<kAK, kBK>(a, lda, b, ldb, bias, out, M, N, K, 1, st);
}

// out [M, N] = a^T . b summed over K, a [K, M] and b [K, N] row-major (a dW
// over all B*T rows): in `splits` K ranges whose float32 partial sums go to
// ws [splits][M][N] and are added in order (split_sum); one range writes
// out itself.
inline cudaError_t gemm_tn_split(const float* a, const float* b, float* out, int M, int N,
                                 int K, int splits, float* ws, cudaStream_t st) {
  if (splits <= 1) return gemm<true, true>(a, M, b, N, nullptr, out, M, N, K, st);
  NSD_TRY((gemm_split<true, true>(a, M, b, N, nullptr, ws, M, N, K, splits, st)));
  return split_sum<float>(ws, out, splits, (size_t)M * N, st);
}

}  // namespace f32
}  // namespace nsd
