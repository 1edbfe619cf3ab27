// Fused inference frontend of the GRU decoder:
//   out[b, t, :] = softsign(smooth(x)[b, t, :] @ W[day[b]] + bias[day[b]])
// with smooth() the Gaussian of n_taps <= 32 taps (20 on the GRU path) along
// time, zero-padded "same" (pad (k-1)//2 left, the rest right).
//
// Replaces the Pallas TPU kernel
// neural_speech_decoder_tpu/ops/pallas/frontend_kernel.py::fused_frontend,
// which runs one program per trial with the whole [T, C] trial and its
// [C, C] day matrix in VMEM.
//
// Semantics kept from the TPU kernel: the day index is clipped to
// [0, n_days-1]; the smoothing sums in float32 and the smoothed value is
// rounded to x's type before the product; the product accumulates in
// float32; the bias is float32; the output has x's type.
//
// What bounds it on an H100: the traffic floor is one read of x and one
// write of the output (the day matrices, 6 MB in f32 for 24 days, stay in
// the 50 MB L2). Each output element costs 2*C flops for 8 bytes of that
// traffic in f32 (64 flop/byte at C=256), which is above the ridge of the
// card's FP32 FMA units (about 20 flop/byte) and below that of its tensor
// cores. So this version, whose product runs on FP32 FMAs, is bound by FMA
// throughput; moving the product to the tensor cores would leave it bound
// by memory.
//
// Design: one block per (tile of kRows time rows, trial). The block copies
// the input rows its smoothing reads (the tile plus the n_taps-1 halo rows,
// zero outside [0, T)) into shared memory with several loads in flight per
// thread, then smooths them for all C channels into a channel-major slab.
// The product walks the output columns in passes of kCols, staging kChunk
// rows of W[day] at a time in the space the input rows used, with the next
// chunk's loads in flight in registers while the current chunk is
// multiplied. Each of the 256 threads keeps a 2 x 8 register tile of
// outputs and reads its operands as one 8-byte and two 16-byte shared loads
// per step of the contraction. W[day] does not fit one block's shared memory
// in f32 (256 KB at C=256), hence the staged chunks.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 32;
constexpr int kRows = 32;      // time rows per block
constexpr int kCols = 128;     // output columns per pass
constexpr int kChunk = 32;     // rows of W staged per step
constexpr int kThreads = 256;  // 16 column lanes x 16 row lanes

struct Taps {
  float v[kMaxTaps];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    frontend_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias,
                    const int32_t* __restrict__ day, T* __restrict__ out,
                    int n_time, int n_ch, int n_days, Taps taps, int n_taps,
                    int pad_left) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float taps_s[kMaxTaps];
  constexpr int kLd = kRows + 4;  // smoothed row stride: 16-byte aligned
  constexpr int kWLoads = kChunk * kCols / kThreads;  // 16 per thread
  const int k_pad = (n_ch + kChunk - 1) / kChunk * kChunk;
  const int n_raw = (kRows + n_taps - 1) * n_ch;
  float* sm = smem;                // [k_pad][kLd] smoothed, channel-major
  float* raw = smem + k_pad * kLd;  // [kRows + n_taps - 1][n_ch] input rows
  float* wt = raw;                  // [kChunk][kCols] W rows, once raw is used
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  int d = day[b];
  d = d < 0 ? 0 : (d >= n_days ? n_days - 1 : d);
  const T* xb = x + (size_t)b * n_time * n_ch;
  const T* wd = w + (size_t)d * n_ch * n_ch;
  const float* bd = bias + (size_t)d * n_ch;
  if (tid < kMaxTaps) taps_s[tid] = taps.v[tid];

  // 1. The input rows the tile's smoothing reads, zero outside [0, T):
  //    four independent loads in flight per thread.
  const int r0 = t0 - pad_left;
  for (int base = tid; base < n_raw; base += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads;
      const int src = r0 + i / n_ch;
      v[u] = (i < n_raw && src >= 0 && src < n_time)
                 ? nsd::to_f32(xb[(ptrdiff_t)r0 * n_ch + i])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads;
      if (i < n_raw) raw[i] = v[u];
    }
  }
  for (int i = n_ch * kLd + tid; i < k_pad * kLd; i += kThreads) sm[i] = 0.f;
  __syncthreads();
  // 2. Smooth in float32, rounded to T as the TPU kernel casts before its
  //    product; stored channel-major so a thread's rows are one vector load.
  for (int i = tid; i < kRows * n_ch; i += kThreads) {
    const int r = i / n_ch;
    const int c = i - r * n_ch;
    float s = 0.f;
    for (int j = 0; j < n_taps; ++j) s += taps_s[j] * raw[(r + j) * n_ch + c];
    sm[c * kLd + r] = nsd::round_to<T>(s);
  }

  // 3. The product, kCols output columns per pass, W staged kChunk rows at
  //    a time (zero past C); the next chunk's loads are in flight in
  //    registers during the current chunk's products. Thread (tx, ty) owns
  //    rows 2ty, 2ty+1 and columns 4tx..4tx+3 and 64+4tx..64+4tx+3.
  const int tx = tid % 16;
  const int ty = tid / 16;
  float w_reg[kWLoads];
  auto load_chunk = [&](int c0, int k0) {
#pragma unroll
    for (int u = 0; u < kWLoads; ++u) {
      const int i = tid + u * kThreads;
      const int k = k0 + i / kCols;
      const int o = c0 + i % kCols;
      w_reg[u] = (k < n_ch && o < n_ch) ? nsd::to_f32(wd[(size_t)k * n_ch + o])
                                        : 0.f;
    }
  };
  load_chunk(0, 0);
  for (int c0 = 0; c0 < n_ch; c0 += kCols) {
    float acc[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    }
    for (int k0 = 0; k0 < n_ch; k0 += kChunk) {
      // Wait until every thread is done with the raw rows (the first time)
      // or with the previous W chunk.
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) wt[tid + u * kThreads] = w_reg[u];
      __syncthreads();
      if (k0 + kChunk < n_ch) {
        load_chunk(c0, k0 + kChunk);
      } else if (c0 + kCols < n_ch) {
        load_chunk(c0 + kCols, 0);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const float2 a =
            *reinterpret_cast<const float2*>(&sm[(k0 + kk) * kLd + 2 * ty]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&wt[kk * kCols + 4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&wt[kk * kCols + 64 + 4 * tx]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j] = fmaf(a.x, bv[j], acc[0][j]);
          acc[1][j] = fmaf(a.y, bv[j], acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 2 * ty + r;
      if (t < n_time) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int o = c0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
          if (o < n_ch) {
            const float y = acc[r][j] + bd[o];
            out[((size_t)b * n_time + t) * n_ch + o] =
                nsd::from_f32<T>(y / (1.f + fabsf(y)));
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_frontend(const void* x, const void* w, const void* bias,
                            const void* day, void* out, int batch, int n_time,
                            int n_ch, int n_days, const float* taps_host,
                            int n_taps, int pad_left, cudaStream_t stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || batch < 1 || n_time < 1 ||
      n_ch < 1 || n_days < 1) {
    return cudaErrorInvalidValue;
  }
  Taps taps;
  for (int j = 0; j < kMaxTaps; ++j) taps.v[j] = j < n_taps ? taps_host[j] : 0.f;
  const size_t raw = (size_t)(kRows + n_taps - 1) * n_ch;
  const size_t k_pad = (size_t)(n_ch + kChunk - 1) / kChunk * kChunk;
  const size_t smem =
      sizeof(float) * (k_pad * (kRows + 4) +
                       (raw > (size_t)kChunk * kCols ? raw : kChunk * kCols));
  cudaError_t err = cudaFuncSetAttribute(
      frontend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_time + kRows - 1) / kRows, batch);
  frontend_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int32_t*>(day),
      static_cast<T*>(out), n_time, n_ch, n_days, taps, n_taps, pad_left);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nsd_frontend_f32(const void* x, const void* w, const void* bias,
                     const void* day, void* out, int batch, int n_time,
                     int n_ch, int n_days, const float* taps, int n_taps,
                     int pad_left, void* stream) {
  return static_cast<int>(launch_frontend<float>(
      x, w, bias, day, out, batch, n_time, n_ch, n_days, taps, n_taps,
      pad_left, static_cast<cudaStream_t>(stream)));
}

int nsd_frontend_bf16(const void* x, const void* w, const void* bias,
                      const void* day, void* out, int batch, int n_time,
                      int n_ch, int n_days, const float* taps, int n_taps,
                      int pad_left, void* stream) {
  return static_cast<int>(launch_frontend<__nv_bfloat16>(
      x, w, bias, day, out, batch, n_time, n_ch, n_days, taps, n_taps,
      pad_left, static_cast<cudaStream_t>(stream)));
}

const char* nsd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
