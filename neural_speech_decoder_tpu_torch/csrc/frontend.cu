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
// cores. So the FMA and float32 bodies, whose products run on FP32 FMAs, are
// bound by FMA throughput; the tensor-core body (bf16) is bound by memory at
// its floor.
//
// Three bodies. The FMA body (the first design; the shapes neither other
// body takes, and an A/B's older arm): one block per (tile of kRows time
// rows, trial). The block copies
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
//
// The tensor-core body (namespace tc; bf16, 20 taps, C = 256, the width of
// every configuration, 16-byte aligned x, W and out): one block per (trial,
// run of 64-row tiles), one block an SM (193 KB of shared memory), two
// warpgroups. W[day] in bf16 (256 x 256, 128 KB) and the day's bias are
// staged once per block by cp.async into the 128-byte swizzled layout the
// tensor cores read (gemm_sm90.cuh's N-major B boxes) and stay there while
// the block walks its tiles. Each tile's product runs as 16 k16 steps of
// wgmma m64n128k16 a warpgroup (bf16 operands read by shared-memory
// descriptors, float32 sums in registers), asynchronously: while it runs,
// the same threads smooth the next tile into the other of two A buffers
// (K-major, swizzled). A thread smooths four channels over 16
// rows from a sliding window of 35 input words in registers, all requested
// before its first sum, the rows asked into L2 a tile earlier (each
// output's taps added in order j = 0..19 by fused multiply-adds from 0, the
// FMA body's arithmetic) and rounds them to bf16. After the product, bias
// and Softsign are applied to the sums in registers and the bf16 results
// staged in the tile's A buffer (once both warpgroups' products, which read
// all of it, are done), then written out in 16-byte stores. Why
// wgmma: mma.sync reached about 240 TFLOP/s here, and an asynchronous
// product lets the smoothing, on the FMA units, run under it.
//
// The float32 body (namespace f32; float32, C a multiple of 4, 16-byte
// aligned x, W and out, at most kMaxTaps taps): the FMA body's arithmetic
// on gemm_f32.cuh's pipelined FP32 tile, which the float32 projection and
// fused bodies run at about 41 TFLOP/s: one block per (128 output columns,
// 128 time rows, trial), so a tile never straddles two trials, two blocks an
// SM. B is W[day] read k-major by cp.async; A is SmoothedSlabs, which
// brings each 16-channel slab's 128 + taps - 1 input rows into a ring of two
// in dynamic shared memory by cp.async two slabs ahead and smooths them into
// the tile's A slab after the previous slab's FMAs (20 FMAs an A element
// against the 128 uses of it in the product). The epilogue adds the bias,
// applies Softsign and stores 16 bytes. Each output's taps are added in
// order j = 0.. from 0 and its product over k = 0..C-1 from 0 in one
// thread, then the bias, then y / (1 + |y|), as in the FMA body, so the two
// give the same bits. Against the FMA body it reads W[day] once a block
// into a 4x larger output tile (the FMA body stages all of it for every 32
// rows), holds 8 x 8 outputs a thread (2 x 8 there), and keeps the input
// loads in flight under the product.
#include <stdint.h>

#include "common.cuh"
#include "gemm_f32.cuh"   // the pipelined FP32 tile and SmoothedSlabs
#include "gemm_sm90.cuh"  // smem_desc: the wgmma shared-memory descriptor

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

// ------------------------------------------------------- tensor-core body
// Parts of frontend_tc_kernel that a build with -DNSD_FRONTEND_CUT=<bits>
// leaves out, so that tools/frontend_ablation.py can time what is left (such
// a build computes wrong numbers): bit 0 the smoothing (A is the input rows
// as they are), bit 1 the product, bit 2 the Softsign's division, bit 3 the
// input loads (the rows read as zeros), bit 4 the output stores.
// The library is built without it: nothing is left out.
#ifndef NSD_FRONTEND_CUT
#define NSD_FRONTEND_CUT 0
#endif
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kTaps = 20;        // the taps this body is built for
constexpr int kHalo = kTaps - 1;
constexpr int kTileRows = 64;    // time rows a tile: one wgmma m64
constexpr int kStrip = 16;       // rows a thread smooths
constexpr int kTcThreads = 256;  // two warpgroups, 128 output columns each
constexpr int kCh = 256;         // channels: W is 256 x 256, A 64 x 256
constexpr int kBox = 64 * 64 * 2;          // a 64 x 64 bf16 box of the 128-byte swizzle
constexpr int kABytes = 4 * kBox;          // A: 4 k blocks of [64 rows][64 k]
constexpr int kWBytes = 16 * kBox;         // W: 4 k blocks of 4 n boxes [64 k][64 n]
constexpr size_t kSmemBytes = kWBytes + 2 * kABytes + kCh * 4 + 1024;

// Byte offset of element (row, col) in a [64][64] bf16 box with the 128-byte
// swizzle (TMA's and wgmma's layout): row r at r * 128, its 16-byte chunk c
// stored at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Byte offset of 16-byte chunk c (columns 8c..8c+7) of row r of the output
// staged as [64][256] bf16: chunks swizzled by r % 8, so that the eight
// rows a warp's epilogue store covers fall on distinct banks.
__device__ __forceinline__ uint32_t out_chunk(int row, int c) {
  return row * 512 + ((c ^ (row & 7)) << 4);
}

// d[64 rows x 128 columns of this warpgroup] (+)= A (64 x 16, K-major) .
// B (16 x 128, N-major); scale_d 0 starts the sums.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
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
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Ask L2 for the input rows tile t0 smooths ([t0 - pad_left, t0 + 64 + 19 -
// pad_left) clipped to [0, T), contiguous in x), so that its loads hit L2.
__device__ __forceinline__ void prefetch_rows(const bf16* xb, int t0, int pad_left, int n_time) {
  const int lo = max(t0 - pad_left, 0), hi = min(t0 - pad_left + kTileRows + kHalo, n_time);
  if (threadIdx.x == 0 && hi > lo) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(xb + (size_t)lo * kCh),
                 "r"((hi - lo) * kCh * 2)
                 : "memory");
  }
}

// Keep the compiler from moving d's registers across the asynchronous
// product (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Rows [t0, t0+64) of trial xb smoothed in float32 (each output's taps added
// in order from 0 by fused multiply-adds, the FMA body's arithmetic) and
// rounded to bf16 into the swizzled A tile: thread item = (4 channels, strip
// of 16 rows); its 35 input words (8 bytes each, zero outside [0, T)) are
// all requested before the first sum, and input row q of the strip adds tap
// q - r to output row r.
__device__ __forceinline__ void smooth_tile(uint8_t* a_tile, const bf16* xb, int t0,
                                            int pad_left, int n_time, const Taps& taps) {
  constexpr int n_quads = kCh / 4;
  for (int item = threadIdx.x; item < n_quads * (kTileRows / kStrip); item += kTcThreads) {
    const int k = 4 * (item % n_quads), r0 = item / n_quads * kStrip;
    const int src0 = t0 - pad_left + r0;
    uint2 raw[kStrip + kHalo];
#pragma unroll
    for (int q = 0; q < kStrip + kHalo; ++q) {
      const int src = src0 + q;
      raw[q] = src >= 0 && src < n_time && !(NSD_FRONTEND_CUT & 8)
                   ? __ldg(reinterpret_cast<const uint2*>(xb + (size_t)src * kCh + k))
                   : make_uint2(0u, 0u);
    }
    float acc[4][kStrip];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < kStrip; ++r) acc[c][r] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < kStrip + kHalo; ++q) {
      const float v[4] = {__uint_as_float(raw[q].x << 16), __uint_as_float(raw[q].x & 0xffff0000u),
                          __uint_as_float(raw[q].y << 16), __uint_as_float(raw[q].y & 0xffff0000u)};
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        const int j = q - r;
        if (j >= 0 && j < kTaps) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (NSD_FRONTEND_CUT & 1) {
              if (j == 0) acc[c][r] = v[c];
            } else {
              acc[c][r] = fmaf(taps.v[j >= 0 && j < kTaps ? j : 0], v[c], acc[c][r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      *reinterpret_cast<uint2*>(a_tile + (k / 64) * kBox + swz(r0 + r, k % 64)) =
          make_uint2(nsd::pack(acc[0][r], acc[1][r]), nsd::pack(acc[2][r], acc[3][r]));
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    frontend_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, const int32_t* __restrict__ day,
                       bf16* __restrict__ out, int n_time, int n_days, Taps taps,
                       int pad_left, int tiles_per_block) {
  extern __shared__ uint8_t smem_tc[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_tc) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ws = base;                             // W[day], 4 k blocks x 4 n boxes
  uint8_t* const a0 = base + kWBytes;                // A, two buffers
  uint8_t* const a1 = a0 + kABytes;
  float* bs = reinterpret_cast<float*>(base + kWBytes + 2 * kABytes);
  const int b = blockIdx.y;
  const int n_tiles = (n_time + kTileRows - 1) / kTileRows;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(n_tiles, tile0 + tiles_per_block);
  if (tile0 >= tile1) return;
  const int tid = threadIdx.x;
  int d = day[b];
  d = d < 0 ? 0 : (d >= n_days ? n_days - 1 : d);
  const bf16* xb = x + (size_t)b * n_time * kCh;
  const bf16* wd = w + (size_t)d * kCh * kCh;
  // W[day] by 16-byte cp.async into the swizzled boxes; the bias.
  for (int i = tid; i < kCh * (kCh / 8); i += kTcThreads) {
    const int k = i / (kCh / 8), n = (i % (kCh / 8)) * 8;
    nsd::cp_async16(ws + (k / 64) * 4 * kBox + (n / 64) * kBox + swz(k % 64, n % 64),
                    wd + (size_t)k * kCh + n, true);
  }
  nsd::cp_async_commit();
  for (int i = tid; i < kCh; i += kTcThreads) bs[i] = bias[(size_t)d * kCh + i];
  if (tile0 + 1 < tile1) prefetch_rows(xb, (tile0 + 1) * kTileRows, pad_left, n_time);
  smooth_tile(a0, xb, tile0 * kTileRows, pad_left, n_time, taps);
  nsd::cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const uint32_t w_addr = nsd::smem_u32(ws) + 2 * wg * kBox;  // this warpgroup's n boxes
  for (int tile = tile0; tile < tile1; ++tile) {
    const bool odd = (tile - tile0) & 1;
    uint8_t* const a_cur = odd ? a1 : a0;
    uint8_t* const a_next = odd ? a0 : a1;
    const int t0 = tile * kTileRows;
    // 1. The product of this tile on the tensor cores, asynchronously: 16
    //    k16 steps of m64n128 for each warpgroup.
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const uint32_t a_addr = nsd::smem_u32(a_cur);
    if (tile + 2 < tile1) prefetch_rows(xb, t0 + 2 * kTileRows, pad_left, n_time);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (!(NSD_FRONTEND_CUT & 2)) {
#pragma unroll
      for (int kk = 0; kk < kCh / 16; ++kk) {
        const uint64_t da = nsd::sm90::smem_desc(a_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        const uint64_t db = nsd::sm90::smem_desc(w_addr + (kk / 4) * 4 * kBox + (kk % 4) * 2048,
                                                 kBox, 1024);
        wgmma_m64n128k16(acc, da, db, kk > 0 ? 1 : 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // 2. Meanwhile the next tile, smoothed into the other A buffer (its rows
    //    were asked into L2 a tile earlier).
    if (tile + 1 < tile1) smooth_tile(a_next, xb, t0 + kTileRows, pad_left, n_time, taps);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    // wait_group waits for this warpgroup's product only, and each
    // warpgroup's product reads all of A: both must be done before step 3
    // writes into A
    __syncthreads();
    // 3. Bias and Softsign in registers, one bf16 rounding, staged in this
    //    tile's A buffer (free now) as [64][256] rows
    //    whose 16-byte chunks are swizzled by row: acc[4j + r] is row
    //    16 warp + lane/4 + 8 (r/2), column 128 wg + 8j + 2 (lane%4) + r%2.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * wg + 8 * j + 2 * (lane % 4);
      const float b0 = bs[col], b1 = bs[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + lane / 4 + 8 * h;
        const float y0 = acc[4 * j + 2 * h] + b0, y1 = acc[4 * j + 2 * h + 1] + b1;
        *reinterpret_cast<uint32_t*>(a_cur + out_chunk(row, col / 8) + (col % 8) * 2) =
            (NSD_FRONTEND_CUT & 4) ? nsd::pack(y0, y1)
                                   : nsd::pack(y0 / (1.f + fabsf(y0)), y1 / (1.f + fabsf(y1)));
      }
    }
    __syncthreads();
    // 4. 16-byte stores of the rows inside [0, T).
    for (int i = tid; i < kTileRows * (kCh / 8); i += kTcThreads) {
      const int row = i / (kCh / 8), c = i % (kCh / 8);
      if (t0 + row < n_time && !((NSD_FRONTEND_CUT & 16) && n_days > 0)) {
        *reinterpret_cast<uint4*>(out + ((size_t)b * n_time + t0 + row) * kCh + 8 * c) =
            *reinterpret_cast<const uint4*>(a_cur + out_chunk(row, c));
      }
    }
    // the next tile's A complete and visible to the tensor cores; this
    // tile's buffer free for the one after
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

cudaError_t launch(const void* x, const void* w, const void* bias, const void* day, void* out,
                   int batch, int n_time, int n_ch, int n_days, const float* taps_host,
                   int n_taps, int pad_left, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (n_taps != kTaps || n_ch != kCh || !aligned || batch < 1 || n_time < 1 || n_days < 1) {
    return cudaErrorInvalidValue;
  }
  Taps taps;
  for (int j = 0; j < kMaxTaps; ++j) taps.v[j] = j < n_taps ? taps_host[j] : 0.f;
  NSD_TRY(cudaFuncSetAttribute(frontend_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes));
  int dev = 0, sms = 0;
  NSD_TRY(cudaGetDevice(&dev));
  NSD_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  // about one block an SM: each trial's tiles cut into runs, each block
  // staging W[day] once for its run
  const int n_tiles = (n_time + kTileRows - 1) / kTileRows;
  int groups = sms / batch;
  groups = groups < 1 ? 1 : (groups > n_tiles ? n_tiles : groups);
  const int per_block = (n_tiles + groups - 1) / groups;
  groups = (n_tiles + per_block - 1) / per_block;
  frontend_tc_kernel<<<dim3(groups, batch), kTcThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const int32_t*>(day), static_cast<bf16*>(out), n_time, n_days, taps, pad_left,
      per_block);
  return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------ float32 body
namespace f32 {

using nsd::f32::kTile;

// Softsign on the tile's outputs, the bias already added.
struct Softsign {
  __device__ __forceinline__ float4 operator()(float4 v) const {
    return make_float4(v.x / (1.f + fabsf(v.x)), v.y / (1.f + fabsf(v.y)),
                       v.z / (1.f + fabsf(v.z)), v.w / (1.f + fabsf(v.w)));
  }
};

// The kernel's parameters, one __grid_constant__ block that SmoothedSlabs
// reads where it lies.
struct Args {
  const float* x;
  const float* w;
  const float* bias;
  const int32_t* day;
  float* out;
  int n_time, n_ch, n_days, n_taps, pad_left;
  Taps taps;
};

template <int kTaps>
using Smoothed = nsd::f32::SmoothedSlabs<kTaps, Args>;

// B, W[day]: Slabs<true> with its offsets formed inside the tile's loop.
struct DaySlabs : nsd::f32::Slabs<true> {
  __device__ __forceinline__ void fetch(float* dst, int k0, int K) {
    Slabs<true>::fetch(dst, k0, K, nsd::f32::tid_anew());
  }
};

// kTaps: the taps the body is built for (20, the GRU's), or 0 for any count
// up to kMaxTaps, read at run time.
template <int kTaps>
__global__ void __launch_bounds__(nsd::f32::kThreads, 2)
    frontend_f32_kernel(const __grid_constant__ Args a) {
  const int b = blockIdx.z;
  int d = a.day[b];
  d = d < 0 ? 0 : (d >= a.n_days ? a.n_days - 1 : d);
  const size_t trial = (size_t)b * a.n_time * a.n_ch;
  Smoothed<kTaps> sa{a, a.x + trial, (int)blockIdx.y * kTile, 0};
  DaySlabs sb{{a.w + (size_t)d * a.n_ch * a.n_ch, a.n_ch, a.n_ch, (int)blockIdx.x * kTile}};
  nsd::f32::gemm_f32_tile(sa, sb, a.n_time, a.n_ch, a.n_ch, a.bias + (size_t)d * a.n_ch,
                          a.out + trial, a.n_ch, Softsign{});
}

template <int kTaps>
cudaError_t launch_taps(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Smoothed<kTaps>::kRingFloats * sizeof(float);
  NSD_TRY(cudaFuncSetAttribute(frontend_f32_kernel<kTaps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid((a.n_ch + kTile - 1) / kTile, (a.n_time + kTile - 1) / kTile, batch);
  frontend_f32_kernel<kTaps><<<grid, nsd::f32::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w, const void* bias, const void* day, void* out,
                   int batch, int n_time, int n_ch, int n_days, const float* taps_host,
                   int n_taps, int pad_left, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (n_taps < 1 || n_taps > kMaxTaps || n_ch < 1 || n_ch % 4 != 0 || !aligned || batch < 1 ||
      batch > 65535 || n_time < 1 || (n_time + kTile - 1) / kTile > 65535 || n_days < 1) {
    return cudaErrorInvalidValue;
  }
  Args a{static_cast<const float*>(x), static_cast<const float*>(w),
         static_cast<const float*>(bias), static_cast<const int32_t*>(day),
         static_cast<float*>(out), n_time, n_ch, n_days, n_taps, pad_left, {}};
  for (int j = 0; j < kMaxTaps; ++j) a.taps.v[j] = j < n_taps ? taps_host[j] : 0.f;
  return n_taps == 20 ? launch_taps<20>(a, batch, stream) : launch_taps<0>(a, batch, stream);
}

}  // namespace f32

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

int nsd_frontend_tc_bf16(const void* x, const void* w, const void* bias,
                         const void* day, void* out, int batch, int n_time,
                         int n_ch, int n_days, const float* taps, int n_taps,
                         int pad_left, void* stream) {
  return static_cast<int>(tc::launch(x, w, bias, day, out, batch, n_time, n_ch, n_days, taps,
                                     n_taps, pad_left, static_cast<cudaStream_t>(stream)));
}

int nsd_frontend_f32_tile(const void* x, const void* w, const void* bias, const void* day,
                          void* out, int batch, int n_time, int n_ch, int n_days,
                          const float* taps, int n_taps, int pad_left, void* stream) {
  return static_cast<int>(f32::launch(x, w, bias, day, out, batch, n_time, n_ch, n_days, taps,
                                      n_taps, pad_left, static_cast<cudaStream_t>(stream)));
}

const char* nsd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
