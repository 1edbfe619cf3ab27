// One tiled matrix product for the fused FF and conv-module kernels:
//   C[m, n] = sum_k A(m, k) * B(k, n), accumulated in float32,
// with the operands read through loader functors (the prologue: a layer
// norm, a SiLU or a rounding applied as an element is loaded) and every
// result handed to an epilogue functor (bias, rounding, activation, dropout,
// store). A loader is a struct with
//   __device__ float operator()(int r, int c) const;   // element (r, c)
//   __device__ void load8(int r, int c, float v[8]) const;  // 8 elements
//       from (r, c) along the contiguous axis
//   static constexpr bool kColContig;  // true: consecutive c are adjacent
// and `Tr<L>` reads it transposed, so one kernel serves the NN, NT (A.B^T)
// and TN (A^T.B) products. An epilogue is
//   __device__ void operator()(int m, int n, float acc, int split) const;
//
// Two bodies, chosen by the operands' storage type:
// - float32: 128x128 block tiles, k-steps of 8, 256 threads each forming an
//   8x8 sub-tile with FMAs from shared memory (no TF32: it would change the
//   numbers);
// - bfloat16: 128x128 block tiles, k-steps of 32, 8 warps each forming a
//   64x32 sub-tile with wmma 16x16x16 bf16 products into float32
//   accumulators (mma.sync on sm_90a); loaded values are rounded to bf16,
//   which is exact for every loader here (they return bf16 values). Each
//   operand is read 8 elements at a time along its contiguous axis (16-byte
//   loads where aligned) and kept in shared memory in that orientation
//   (row- or column-major fragments), so its stores are 16 bytes too.
// Every output's sum runs over k in one fixed order, so a run repeats bit for
// bit. `splits` > 1 cuts K into that many ranges (grid.z), each written by the
// epilogue with its split index; `split_sum` then adds them in order. No
// atomics anywhere.
//
// This is the simple design the port starts from: one stage, no cp.async,
// TMA or wgmma (later work).
#pragma once

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace nsd {

constexpr int kGemmThreads = 256;
constexpr int kGemmTile = 128;  // rows and columns of a block tile

// L read transposed: Tr<L>(r, c) = L(c, r).
template <class L>
struct Tr {
  L l;
  static constexpr bool kColContig = !L::kColContig;
  __device__ __forceinline__ float operator()(int r, int c) const { return l(c, r); }
  __device__ __forceinline__ void load8(int r, int c, float* v) const { l.load8(c, r, v); }
};

// v[0..kN) = q[0..kN) as float: 16-byte loads (kN * sizeof(T) a multiple
// of 16) where q is 16-byte aligned, else element by element.
template <int kN>
__device__ __forceinline__ void load_raw(const float* q, float* v) {
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      const float4 a = reinterpret_cast<const float4*>(q)[j];
      v[4 * j] = a.x, v[4 * j + 1] = a.y, v[4 * j + 2] = a.z, v[4 * j + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) v[e] = q[e];
  }
}
template <int kN>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* q, float* v) {
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const uint4 u = reinterpret_cast<const uint4*>(q)[j];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[8 * j + 2 * i] = f.x;
        v[8 * j + 2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) v[e] = to_f32(q[e]);
  }
}

// q[0..kN) = v[0..kN) (rounded to nearest for bf16): 16-byte stores, q
// 16-byte aligned and kN * sizeof(T) a multiple of 16.
template <int kN>
__device__ __forceinline__ void store_raw(float* q, const float* v) {
#pragma unroll
  for (int j = 0; j < kN / 4; ++j)
    reinterpret_cast<float4*>(q)[j] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}
template <int kN>
__device__ __forceinline__ void store_raw(__nv_bfloat16* q, const float* v) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[8 * j + 2 * i], v[8 * j + 2 * i + 1]);
    reinterpret_cast<uint4*>(q)[j] = u;
  }
}

// A row-major matrix of S with row stride ld, each element rounded to T as
// it is loaded.
template <typename S, typename T>
struct Mat {
  const S* p;
  int ld;
  static constexpr bool kColContig = true;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return round_to<T>(to_f32(p[(size_t)r * ld + c]));
  }
  __device__ __forceinline__ void load8(int r, int c, float* v) const {
    load_raw<8>(p + (size_t)r * ld + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = round_to<T>(v[e]);
  }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// dst(r, c) <- src(r0 + r, c0 + c) for an R x C tile, 0 outside
// [0, r_end) x [0, c_end); the walk follows the source's contiguous axis.
template <int R, int C, bool kColContig, class Src, class Store>
__device__ __forceinline__ void load_tile(const Src& src, int r0, int r_end, int c0,
                                          int c_end, Store store) {
  for (int i = threadIdx.x; i < R * C; i += kGemmThreads) {
    const int r = kColContig ? i / C : i % R;
    const int c = kColContig ? i % C : i / R;
    const int gr = r0 + r, gc = c0 + c;
    store(r, c, (gr < r_end && gc < c_end) ? src(gr, gc) : 0.f);
  }
}

template <class AL, class BL, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_fma_kernel(int M, int N, int K, int kc, AL a, BL b, Epi epi) {
  constexpr int BM = kGemmTile, BN = kGemmTile, BK = 8;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int k_lo = z * kc, k_hi = min(K, k_lo + kc);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    load_tile<BM, BK, AL::kColContig>(a, m0, M, k0, k_hi,
                                      [&](int r, int c, float v) { As[c][r] = v; });
    load_tile<BK, BN, BL::kColContig>(b, k0, k_hi, n0, N,
                                      [&](int r, int c, float v) { Bs[r][c] = v; });
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) epi(m, n, acc[i][j], z);
    }
  }
}

// An R x C tile of src from (r0, c0) into bf16 shared memory, 0 outside
// [0, r_end) x [0, c_end): 8 elements per step along the source's
// contiguous axis, stored 16 bytes at a time at dst[r * ld + c] (kColContig)
// or dst[c * ld + r].
template <int R, int C, bool kColContig, class Src>
__device__ __forceinline__ void load_tile8(const Src& src, int r0, int r_end, int c0,
                                           int c_end, __nv_bfloat16* dst, int ld) {
  constexpr int kRun = kColContig ? C / 8 : R / 8;  // 8-element runs per line
  for (int i = threadIdx.x; i < R * C / 8; i += kGemmThreads) {
    const int r = kColContig ? i / kRun : (i % kRun) * 8;
    const int c = kColContig ? (i % kRun) * 8 : i / kRun;
    const int gr = r0 + r, gc = c0 + c;
    float v[8];
    if (kColContig ? (gr < r_end && gc + 8 <= c_end) : (gc < c_end && gr + 8 <= r_end)) {
      src.load8(gr, gc, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int er = kColContig ? gr : gr + e, ec = kColContig ? gc + e : gc;
        v[e] = (er < r_end && ec < c_end) ? src(er, ec) : 0.f;
      }
    }
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst + (kColContig ? r * ld + c : c * ld + r)) = u;
  }
}

template <class AL, class BL, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_wmma_kernel(int M, int N, int K, int kc, AL a, BL b, Epi epi) {
  using namespace nvcuda;
  constexpr int BM = kGemmTile, BN = kGemmTile, BK = 32;
  // each operand kept in its source's orientation: A as [BM][BK] (row-major
  // fragments) or [BK][BM] (column-major), B as [BK][BN] or [BN][BK]; the
  // strides are padded by 8 and stay multiples of 8
  constexpr bool kAr = AL::kColContig, kBr = BL::kColContig;
  constexpr int LA = kAr ? BK + 8 : BM + 8, LB = kBr ? BN + 8 : BK + 8;
  using LayA = std::conditional_t<kAr, wmma::row_major, wmma::col_major>;
  using LayB = std::conditional_t<kBr, wmma::row_major, wmma::col_major>;
  __shared__ __align__(128) __nv_bfloat16 As[(kAr ? BM : BK) * LA];
  __shared__ __align__(128) __nv_bfloat16 Bs[(kBr ? BK : BN) * LB];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // a 64 x 32 sub-tile per warp
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int k_lo = z * kc, k_hi = min(K, k_lo + kc);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    load_tile8<BM, BK, kAr>(a, m0, M, k0, k_hi, As, LA);
    load_tile8<BK, BN, kBr>(b, k0, k_hi, n0, N, Bs, LB);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayA> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayB> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + i * 16;
        wmma::load_matrix_sync(fa[i], As + (kAr ? m * LA + kk : kk * LA + m), LA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], Bs + (kBr ? kk * LB + n : n * LB + kk), LB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = e * 32 + lane;
        const int m = m0 + wm * 64 + i * 16 + idx / 16;
        const int n = n0 + wn * 32 + j * 16 + idx % 16;
        if (m < M && n < N) epi(m, n, cs[idx], z);
      }
      __syncwarp();
    }
  }
}

// How many K ranges a product of an M x N result is cut into: enough blocks
// for two waves on the card's 132 SMs, at most 16, each range at least 256
// long.
inline int gemm_splits(int M, int N, int K) {
  const int tiles = ((M + kGemmTile - 1) / kGemmTile) * ((N + kGemmTile - 1) / kGemmTile);
  int s = (264 + tiles - 1) / tiles;
  s = s < 16 ? s : 16;
  const int by_k = K / 256;
  s = s < by_k ? s : by_k;
  return s > 1 ? s : 1;
}

// Launch C = A.B over M x N x K on stream st, in bf16 products (wmma) or
// float32 FMAs, cut into `splits` K ranges.
template <class AL, class BL, class Epi>
cudaError_t gemm(bool bf16, int M, int N, int K, int splits, const AL& a, const BL& b,
                 const Epi& epi, cudaStream_t st) {
  const int bk = bf16 ? 32 : 8;
  int kc = (K + splits - 1) / splits;
  kc = (kc + bk - 1) / bk * bk;
  const dim3 grid((N + kGemmTile - 1) / kGemmTile, (M + kGemmTile - 1) / kGemmTile, splits);
  if (bf16)
    gemm_wmma_kernel<<<grid, kGemmThreads, 0, st>>>(M, N, K, kc, a, b, epi);
  else
    gemm_fma_kernel<<<grid, kGemmThreads, 0, st>>>(M, N, K, kc, a, b, epi);
  return cudaGetLastError();
}

// The epilogue that stores the float32 sums: out [M, ld]. (pair: columns n
// and n + 1 at once, gemm_sm90.cuh's contract; n and ld even.)
struct StoreF32 {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    out[(size_t)m * ld + n] = acc;
  }
  __device__ __forceinline__ void pair(int m, int n, float v0, float v1, int) const {
    *reinterpret_cast<float2*>(out + (size_t)m * ld + n) = make_float2(v0, v1);
  }
};

// The epilogue of a split product: split z's partial sums into ws [z][M][N].
struct SplitStore {
  float* ws;
  int M, N;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int z) const {
    ws[((size_t)z * M + m) * N + n] = acc;
  }
  __device__ __forceinline__ void pair(int m, int n, float v0, float v1, int z) const {
    *reinterpret_cast<float2*>(ws + ((size_t)z * M + m) * N + n) = make_float2(v0, v1);
  }
};

// out[i] = sum over z of ws[z][i], in order of z, rounded to T.
template <typename T>
__global__ void split_sum_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                 int splits, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[(size_t)z * n + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T>
cudaError_t split_sum(const float* ws, T* out, int splits, size_t n, cudaStream_t st) {
  const size_t want = (n + 255) / 256;
  split_sum_kernel<T><<<(unsigned)(want < 4096 ? want : 4096), 256, 0, st>>>(ws, out,
                                                                            splits, n);
  return cudaGetLastError();
}

// A product whose result is summed over a long K (dW over all B*T' rows),
// cut into split ranges and added in order: out [M, N] in T. ws holds
// gemm_splits(M, N, K) * M * N floats.
template <typename T, class AL, class BL>
cudaError_t gemm_split_sum(bool bf16, int M, int N, int K, const AL& a, const BL& b,
                           float* ws, T* out, cudaStream_t st) {
  const int splits = gemm_splits(M, N, K);
  cudaError_t err = gemm(bf16, M, N, K, splits, a, b, SplitStore{ws, M, N}, st);
  if (err != cudaSuccess) return err;
  return split_sum<T>(ws, out, splits, (size_t)M * N, st);
}

}  // namespace nsd
