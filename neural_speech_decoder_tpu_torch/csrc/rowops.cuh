// Row and column passes shared by the fused FF and conv-module kernels: the
// layer norm's float32 statistics and its backward (one warp per row), the
// normalised rows written once as a product's operand (ln_apply), and
// column sums over all B*T' rows in a fixed order (per-chunk partials, then
// their sum), which stand in for the TPU kernels' per-program partial
// vectors summed outside. No atomics: a run repeats bit for bit.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"
#include "hashrng.cuh"

namespace nsd {

constexpr float kLnEps = 1e-5f;  // models/conformer.py::_layer_norm
constexpr int kColChunks = 64;   // row chunks of a column sum

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, 1/sqrt(var + eps)) of one row of D elements, in float32, summed by
// one warp (every lane gets it); var is the mean of squared deviations
// (jnp.var). The one copy of the statistics: ln_bwd and the scale's column
// sums rely on ln_stats and ln_apply writing the same bits.
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ row, int D, int lane) {
  float s = 0.f;
  for (int k = lane; k < D; k += 32) s += to_f32(row[k]);
  const float mean = warp_sum(s) / D;
  float q = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float c = to_f32(row[k]) - mean;
    q += c * c;
  }
  const float var = warp_sum(q) / D;
  return make_float2(mean, rsqrtf(var + kLnEps));
}

// stats[m] = row_stats of row m of x [M, D].
template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats,
                                int M, int D) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float2 st = row_stats(x + (size_t)m * D, D, lane);
  if (lane == 0) stats[m] = st;
}

template <typename T>
cudaError_t ln_stats(const T* x, float2* stats, int M, int D, cudaStream_t st) {
  ln_stats_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(x, stats, M, D);
  return cudaGetLastError();
}

// ln_stats, and out[m, k] = the layer norm of x's element rounded to T, as
// LnLoad loads it (kSilu: then cdt(SiLU) of that, as the conv module's
// LnSiluLoad): the A operand of a product written once, so that TMA
// (gemm_sm90.cuh) or cp.async (gemm_f32.cuh) can read it; the same bits as
// the loaders give.
template <typename T, bool kSilu>
__global__ void ln_apply_kernel(const T* __restrict__ x, float2* __restrict__ stats,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, T* __restrict__ out, int M,
                                int D) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const T* row = x + (size_t)m * D;
  const float2 st = row_stats(row, D, lane);
  if (lane == 0) stats[m] = st;
  T* o = out + (size_t)m * D;
  for (int k = lane; k < D; k += 32) {
    const float xhat = (to_f32(row[k]) - st.x) * st.y;
    float v = round_to<T>(xhat * scale[k] + bias[k]);
    if (kSilu) v = round_to<T>(v * sigmoid(v));
    o[k] = from_f32<T>(v);
  }
}

template <typename T, bool kSilu>
cudaError_t ln_apply(const T* x, float2* stats, const float* scale, const float* bias, T* out,
                     int M, int D, cudaStream_t st) {
  ln_apply_kernel<T, kSilu><<<(M + 7) / 8, 256, 0, st>>>(x, stats, scale, bias, out, M, D);
  return cudaGetLastError();
}

// The layer norm's backward through x given dxn = dL/d(xhat*scale + bias):
// dxhat = dxn*scale; dx = rstd*(dxhat - mean(dxhat) - xhat*mean(dxhat*xhat)).
template <typename TX, typename TO>
__global__ void ln_bwd_kernel(const float* __restrict__ dxn, const TX* __restrict__ x,
                              const float2* __restrict__ stats,
                              const float* __restrict__ scale, TO* __restrict__ dx,
                              int M, int D) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float2 st = stats[m];
  const float* g = dxn + (size_t)m * D;
  const TX* row = x + (size_t)m * D;
  float a = 0.f, b = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float dxhat = g[k] * scale[k];
    const float xhat = (to_f32(row[k]) - st.x) * st.y;
    a += dxhat;
    b += dxhat * xhat;
  }
  const float ma = warp_sum(a) / D, mb = warp_sum(b) / D;
  TO* out = dx + (size_t)m * D;
  for (int k = lane; k < D; k += 32) {
    const float dxhat = g[k] * scale[k];
    const float xhat = (to_f32(row[k]) - st.x) * st.y;
    out[k] = from_f32<TO>(st.y * (dxhat - ma - xhat * mb));
  }
}

template <typename TX, typename TO>
cudaError_t ln_bwd(const float* dxn, const TX* x, const float2* stats, const float* scale,
                   TO* dx, int M, int D, cudaStream_t st) {
  ln_bwd_kernel<TX, TO><<<(M + 7) / 8, 256, 0, st>>>(dxn, x, stats, scale, dx, M, D);
  return cudaGetLastError();
}

// Element (r, c) of a float32 row-major matrix.
struct Elem {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[(size_t)r * ld + c];
  }
};

// dxn[r, c] * xhat[r, c], xhat the layer norm's normalised x: the terms of
// the layer norm scale's gradient.
template <typename T>
struct ElemTimesXhat {
  const float* dxn;
  const T* x;
  const float2* stats;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const float2 st = stats[r];
    return dxn[(size_t)r * ld + c] * ((to_f32(x[(size_t)r * ld + c]) - st.x) * st.y);
  }
};

// part[chunk][n] = sum of elem(r, n) over the chunk's rows: 32 columns by 8
// row strides per block, the 8 strides added in order.
template <class E>
__global__ void colsum_part_kernel(E elem, float* __restrict__ part, int M, int N,
                                   int rows) {
  __shared__ float red[8][33];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane, chunk = blockIdx.y;
  const int r_lo = chunk * rows, r_hi = min(M, r_lo + rows);
  float s = 0.f;
  if (n < N)
    for (int r = r_lo + g; r < r_hi; r += 8) s += elem(r, n);
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && n < N) {
    float t = red[0][lane];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += red[i][lane];
    part[(size_t)chunk * N + n] = t;
  }
}

// out[n] = sum over i < parts of part[i][n], in order of i.
static __global__ void sum_parts_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int parts, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = part[n];
  for (int i = 1; i < parts; ++i) s += part[(size_t)i * N + n];
  out[n] = s;
}

static inline cudaError_t sum_parts(const float* part, float* out, int parts, int N,
                                    cudaStream_t st) {
  sum_parts_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, out, parts, N);
  return cudaGetLastError();
}

// out[n] = sum over the M rows of elem(r, n); part holds kColChunks * N
// floats.
template <class E>
cudaError_t colsum(const E& elem, float* part, float* out, int M, int N, cudaStream_t st) {
  const int rows = (M + kColChunks - 1) / kColChunks;
  colsum_part_kernel<E><<<dim3((N + 31) / 32, kColChunks), 256, 0, st>>>(elem, part, M, N,
                                                                         rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(part, out, kColChunks, N, st);
}

// The layer norm of row m of x [M, ld] at column k, (x - mean) * rstd *
// scale + bias with the float32 statistics, rounded to T: a product's A
// operand loaded through the norm.
template <typename T>
struct LnLoad {
  const T* x;
  const float2* stats;
  const float* scale;
  const float* bias;
  int ld;
  static constexpr bool kColContig = true;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const float2 st = stats[m];
    const float xhat = (to_f32(x[(size_t)m * ld + k]) - st.x) * st.y;
    return round_to<T>(xhat * scale[k] + bias[k]);
  }
  // columns k .. k + kN of row m
  template <int kN>
  __device__ __forceinline__ void load_n(int m, int k, float* v) const {
    const float2 st = stats[m];
    load_raw<kN>(x + (size_t)m * ld + k, v);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float xhat = (v[e] - st.x) * st.y;
      v[e] = round_to<T>(xhat * scale[k + e] + bias[k + e]);
    }
  }
  __device__ __forceinline__ void load8(int m, int k, float* v) const { load_n<8>(m, k, v); }
};

// gm = g [batch * n_time, d] through a dropout site, in float32: kept where
// uniform2d(seed, b + salt_offset, t, col) >= rate and scaled by inv; gq (may
// be null) gets gm rounded to T, a product's operand written once.
template <typename T>
__global__ void mask_grad_kernel(const T* __restrict__ g, const int32_t* __restrict__ seed,
                                 float* __restrict__ gm, T* __restrict__ gq, int batch,
                                 int n_time, int d, int salt_offset, float rate, float inv) {
  const size_t n = (size_t)batch * n_time * d;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = to_f32(g[i]);
    if (rate > 0.f) {
      const int col = i % d;
      const int m = i / d;
      const int bb = m / n_time;
      const bool kept = hash_uniform(*seed, bb + salt_offset, m - bb * n_time, col) >= rate;
      v = kept ? v * inv : 0.f;
    }
    gm[i] = v;
    if (gq) gq[i] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t mask_grad(const T* g, const int32_t* seed, float* gm, T* gq, int batch,
                      int n_time, int d, int salt_offset, float rate, float inv,
                      cudaStream_t st) {
  const size_t want = ((size_t)batch * n_time * d + 255) / 256;
  mask_grad_kernel<T><<<(unsigned)(want < 8192 ? want : 8192), 256, 0, st>>>(
      g, seed, gm, gq, batch, n_time, d, salt_offset, rate, inv);
  return cudaGetLastError();
}

// out = bf16(o) through a dropout site, o [batch * n_time, ld] a product's
// float32 sums with its bias: kept where uniform2d(seed, b + salt_offset, t,
// col) >= rate and scaled by the float32 inv, then rounded once; 8 columns
// a call (each_cols), o and out 16-byte aligned.
struct DropRoundPass {
  static constexpr int kCols = 8;
  const float* o;
  const int32_t* seed;
  __nv_bfloat16* out;
  int n_time, salt_offset, ld;
  float rate, inv;
  __device__ __forceinline__ void operator()(int m, int n) const {
    const size_t i = (size_t)m * ld + n;
    float v[kCols];
    load_raw<kCols>(o + i, v);
    const int bb = m / n_time, t = m - bb * n_time;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      v[k] = hash_uniform(*seed, bb + salt_offset, t, n + k) >= rate ? v[k] * inv : 0.f;
    store_raw<kCols>(out + i, v);
  }
};

// fn(m, n) for every row m < M and n = 0, kCols, 2 kCols, ... < N (kCols =
// Fn::kCols, N a multiple of it): an elementwise pass over an M x N array,
// kCols consecutive columns a thread (16-byte loads and stores), at full
// occupancy.
template <class Fn>
__global__ void __launch_bounds__(256) each_cols_kernel(Fn fn, int M, int N) {
  const int per_row = N / Fn::kCols;
  const size_t n = (size_t)M * per_row;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = static_cast<int>(i / per_row);
    fn(m, static_cast<int>(i - (size_t)m * per_row) * Fn::kCols);
  }
}

template <class Fn>
cudaError_t each_cols(const Fn& fn, int M, int N, cudaStream_t st) {
  const size_t want = ((size_t)M * (N / Fn::kCols) + 255) / 256;
  each_cols_kernel<Fn><<<(unsigned)(want < 8192 ? want : 8192), 256, 0, st>>>(fn, M, N);
  return cudaGetLastError();
}

// Byte offsets into one workspace: each piece 256-byte aligned.
struct Carve {
  size_t off = 0;
  char* base = nullptr;
  template <typename U>
  U* take(size_t n) {
    U* p = reinterpret_cast<U*>(base ? base + off : nullptr);
    off += (n * sizeof(U) + 255) / 256 * 256;
    return p;
  }
};

}  // namespace nsd
