// The Conformer's convolution module (without its residual) and its
// backward.
//
//   x [B, T, D] (float32 or bfloat16, the compute type cdt), ln_s, ln_b [D]
//   f32, W1 [D, 2D] cdt, b1 [2D] f32, taps [k, D] f32, dw_b [D] f32, ln2_s,
//   ln2_b [D] f32, W2 [D, D] cdt, b2 [D] f32, seed [1] int32; per row b:
//     xn  = cdt(LN(x))                 (float32 statistics)
//     hq  = cdt(xn . W1 + b1)          (float32 accumulation)
//     glu = a * sigmoid(g) in float32, (a, g) the halves of hq; gluq = cdt(glu)
//     c   = sum_k gluq[t + k - pad_l] * taps[k] + dw_b   (float32 taps, zero
//           outside [0, T); pad_l = k//2, or k-1 when causal)
//     cq  = cdt(c); cn = cdt(LN2(cq)); s = cdt(cn * sigmoid(cn))
//     o   = s . W2 + b2; dropout: o = keep ? o * 1/(1-rate) : 0; out = cdt(o)
//   keep at (b, t, d) is uniform2d(seed, b, t, d) >= rate (hashrng.cuh).
//   The backward takes g [B, T, D], recomputes the forward and gives dx (x's
//   type), dW1 and dW2 in cdt, and ln_s, ln_b, b1, taps, dw_b, ln2_s,
//   ln2_b, b2 gradients in float32; the taps' gradient multiplies the
//   unrounded float32 glu (the TPU kernel's `glup`), not the gluq that the
//   forward convolved.
//
// Replaces the Pallas TPU kernels of
// neural_speech_decoder_tpu/ops/pallas/conv_module_kernel.py: _fwd_kernel
// (via fused_conv_module -> _conv_mod_fwd) and _bwd_kernel (via
// _conv_mod_bwd).
//
// What bounds it on an H100: the operations. At B=64, T'=313, D=1024, k=31
// the forward's products are 84 + 42 GFLOP and the depthwise conv 1.3; the
// backward's five products 336 GFLOP. The design is the FF module's
// (csrc/ffn.cu): the module is cut at its products, each with its prologue
// (the first norm; the second norm and SiLU) applied as the A tile is loaded
// and its epilogue (bias, rounding, dropout) applied as it is stored; the
// GLU and the depthwise conv are one kernel over a (time, channel) window in
// shared memory, and their backward (dglu by the flipped taps, the GLU's
// backward, the taps' gradient) another. Every sum has a fixed order.
//
// Three bodies in each direction, as the FF module's (csrc/ffn.cu): the tile
// body (any shape the others cannot read) on gemm_tile.cuh, the sm90 body
// (bf16, D a multiple of 8), whose products run on gemm_sm90.cuh's TMA
// ring into wgmma from bf16 operands written once, each the bits the
// tile body's loader would have given: xn = cdt(LN(x)) and s =
// cdt(SiLU(cdt(LN2(cq)))) by row passes beside the norms' statistics, gq =
// cdt(gm) beside the float32 gm that db2 sums, dhq = cdt(dh) beside the
// float32 dh that db1 sums. The sm90 forward and the sm90 backward's
// recompute share one front, conv_front_sm90, whose window pass is
// glu_dwconv_wide_kernel (8 channels a thread, 16-byte loads, several
// frames a thread); the tile body keeps glu_dwconv_kernel, which takes any D
// and any alignment.
//
// The f32 body (float32, D a multiple of 4) is the sm90 body's stages with
// every product on gemm_f32.cuh's pipelined FP32 FMA tile (no TF32), as the
// FF module's (csrc/ffn.cu): both directions share conv_front_f32, where
// xn = LN(x) and s = SiLU(LN2(cq)) are written once by row passes (the
// loaders' values), hq with b1 in the tile's store, cq by
// glu_dwconv_kernel; the forward's second product stores out with b2 and
// the output dropout runs as a pass in place; gm and dh, float32 already,
// are the backward products' operands as they lie; SiLU' of the recomputed
// cn in the sm90 body's pass, 4 columns a thread.
#include <stdint.h>

#include "common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"
#include "hashrng.cuh"
#include "rowops.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = nsd::sm90;
namespace f32 = nsd::f32;

using nsd::Carve;
using nsd::LnLoad;
using nsd::Mat;
using nsd::Tr;

constexpr int kMaxTaps = 64;
constexpr int kTimeTile = 64;
constexpr int kChanTile = 32;
// glu_dwconv_wide_kernel's tiling: 128 channels a block, 8 a thread, and
// kWideFrames frames a thread, so 256 threads cover 64 frames
constexpr int kWideChan = 128;
constexpr int kWideGroups = kWideChan / 8;
constexpr int kWideFrames = 4;
constexpr int kWideTime = 256 / kWideGroups * kWideFrames;
// Parts of glu_dwconv_wide_kernel that a build with -DNSD_WINDOW_CUT=<bits>
// leaves out, so that tools/window_ablation.py can time what is left (such a
// build computes wrong numbers): bit 0 the loads of hq and the GLU (the
// window is zeros), bit 1 the staging of the taps, bit 2 the window sums.
// The library is built without it: nothing is left out.
#ifndef NSD_WINDOW_CUT
#define NSD_WINDOW_CUT 0
#endif

struct Shape {
  int b, t, d, kw, pad_l;
  float rate, inv;
  __host__ __device__ int m() const { return b * t; }
};

// s = cdt(SiLU(cn)), cn = cdt(LN2(cq)): element (m, k) of the second
// product's A operand.
template <typename T>
struct LnSiluLoad {
  LnLoad<T> ln;
  static constexpr bool kColContig = true;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const float cn = ln(m, k);
    return nsd::round_to<T>(cn * nsd::sigmoid(cn));
  }
  __device__ __forceinline__ void load8(int m, int k, float* v) const {
    ln.load8(m, k, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = nsd::round_to<T>(v[e] * nsd::sigmoid(v[e]));
  }
};

// hq = cdt(acc + b1) (the sm90 body's is gemm_sm90.cuh's bias + StoreBf16,
// the same value).
template <typename T>
struct BiasRoundEpi {
  const float* bias;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    out[(size_t)m * ld + n] = nsd::from_f32<T>(acc + bias[n]);
  }
};

// o = acc + b2 through the output dropout, out = cdt(o).
template <typename T>
struct OutEpi {
  const float* b2;
  const int32_t* seed;
  T* out;
  int n_time, ld;
  float rate, inv;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    float o = acc + b2[n];
    if (rate > 0.f) {
      const int bb = m / n_time;
      o = nsd::hash_uniform(*seed, bb, m - bb * n_time, n) >= rate ? o * inv : 0.f;
    }
    out[(size_t)m * ld + n] = nsd::from_f32<T>(o);
  }
};

// dcn = acc * SiLU'(cn), cn recomputed from cq: stored in float32.
template <typename T>
struct DcnEpi {
  LnLoad<T> ln2;
  float* dcn;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    const float cn = ln2(m, n);
    const float sig = nsd::sigmoid(cn);
    dcn[(size_t)m * ln2.ld + n] = acc * sig * (1.f + cn * (1.f - sig));
  }
};

// dcn = DcnEpi's value of the stored ds (in place in dcn), cn recomputed 16
// bytes of T at a time (8 bf16 or 4 float32 columns): the operand bodies'
// pass after their ds product, which only stores (an sm90 epilogue runs
// behind the main loop on one block an SM, where the norm's loads and SiLU'
// cost more than the product).
template <typename T>
struct DcnPass {
  static constexpr int kCols = 16 / sizeof(T);
  LnLoad<T> ln2;
  float* dcn;
  __device__ __forceinline__ void operator()(int m, int n) const {
    const size_t i = (size_t)m * ln2.ld + n;
    float v[kCols], cn[kCols];
    nsd::load_raw<kCols>(dcn + i, v);
    ln2.template load_n<kCols>(m, n, cn);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const float sig = nsd::sigmoid(cn[k]);
      v[k] = v[k] * sig * (1.f + cn[k] * (1.f - sig));
    }
    nsd::store_raw<kCols>(dcn + i, v);
  }
};

// glu at (row m, channel ch) from hq [M, 2D], float32.
template <typename T>
__device__ __forceinline__ float glu_at(const T* hq, int m, int ch, int d) {
  const float a = nsd::to_f32(hq[(size_t)m * 2 * d + ch]);
  const float g = nsd::to_f32(hq[(size_t)m * 2 * d + d + ch]);
  return a * nsd::sigmoid(g);
}

// cq = cdt(sum_k gluq[t + k - pad_l] * taps[k] + dw_b) for a tile of 64
// frames by 32 channels of one batch row; the window of gluq (64 + k - 1
// frames) sits in shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
    glu_dwconv_kernel(const T* __restrict__ hq, const float* __restrict__ taps,
                      const float* __restrict__ dw_b, T* __restrict__ cq, Shape p) {
  extern __shared__ float win[];  // [64 + k - 1][32]
  const int c0 = blockIdx.x * kChanTile, t0 = blockIdx.y * kTimeTile, b = blockIdx.z;
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int rows = kTimeTile + p.kw - 1;
  for (int i = threadIdx.x; i < rows * kChanTile; i += 256) {
    const int r = i / kChanTile, c = i % kChanTile;
    const int tt = t0 - p.pad_l + r, ch = c0 + c;
    win[i] = (tt >= 0 && tt < p.t && ch < p.d)
                 ? nsd::round_to<T>(glu_at(hq, b * p.t + tt, ch, p.d))
                 : 0.f;
  }
  __syncthreads();
  const int ch = c0 + lane;
  if (ch >= p.d) return;
  for (int r = g; r < kTimeTile && t0 + r < p.t; r += 8) {
    float acc = win[r * kChanTile + lane] * taps[ch];
    for (int k = 1; k < p.kw; ++k)
      acc = acc + win[(r + k) * kChanTile + lane] * taps[(size_t)k * p.d + ch];
    cq[((size_t)b * p.t + t0 + r) * p.d + ch] = nsd::from_f32<T>(acc + dw_b[ch]);
  }
}

// v[0..8) = the 8 bf16 at q, 16-byte aligned, as float.
__device__ __forceinline__ void bf16x8(const bf16* q, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(q);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// glu_dwconv_kernel's function for bf16 with D a multiple of 8 (the sm90
// bodies): a block of 256 threads takes 64 frames by 128 channels of one
// batch row. Its window of gluq (64 + k - 1 frames, zero outside [0, T)) is
// written to shared memory as bf16, which holds gluq exactly, from 16-byte
// loads of a and g (8 channels a thread); the block's taps are staged there
// once, each group of 8 channels stored as two halves of 4 so that a
// quarter-warp's 16-byte reads fall on distinct banks. A thread then owns 8
// channels of 4 consecutive frames: it walks the taps in order and keeps
// the 4 window rows they need in registers, loading one new row a tap, so
// that one row read feeds 4 outputs. The sums are the old kernel's, in its
// order: acc starts at -0 (a fused multiply-add onto -0 is the product
// itself, its sign included), acc = fma(w[r + k], taps[k], acc) for k = 0,
// 1, ..., then + dw_b and one rounding.
__global__ void __launch_bounds__(256, 2)
    glu_dwconv_wide_kernel(const bf16* __restrict__ hq, const float* __restrict__ taps,
                           const float* __restrict__ dw_b, bf16* __restrict__ cq, Shape p) {
  extern __shared__ __align__(16) uint8_t wide_smem[];
  float* stap = reinterpret_cast<float*>(wide_smem);  // [k][2 halves][16 groups][4]
  bf16* win = reinterpret_cast<bf16*>(wide_smem + (size_t)p.kw * kWideChan * 4);
  const int c0 = blockIdx.x * kWideChan, t0 = blockIdx.y * kWideTime, b = blockIdx.z;
  const int rows = kWideTime + p.kw - 1;
  // the taps: 4 channels a 16-byte load where they are aligned, else 1
  const bool taps16 = (reinterpret_cast<uintptr_t>(taps) & 15) == 0 && !(NSD_WINDOW_CUT & 2);
  const bool taps4 = !taps16 && !(NSD_WINDOW_CUT & 2);
  for (int i = threadIdx.x; taps16 && i < p.kw * kWideChan / 4; i += 256) {
    const int k = i / (kWideChan / 4), c = i % (kWideChan / 4) * 4;
    reinterpret_cast<float4*>(stap)[k * kWideChan / 4 + c % 8 / 4 * kWideGroups + c / 8] =
        c0 + c < p.d ? *reinterpret_cast<const float4*>(taps + (size_t)k * p.d + c0 + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; taps4 && i < p.kw * kWideChan; i += 256) {
    const int k = i / kWideChan, c = i % kWideChan;
    stap[k * kWideChan + c % 8 / 4 * (kWideChan / 2) + c / 8 * 4 + c % 4] =
        c0 + c < p.d ? taps[(size_t)k * p.d + c0 + c] : 0.f;
  }
  for (int i = threadIdx.x; i < rows * kWideGroups; i += 256) {
    const int r = i / kWideGroups, grp = i % kWideGroups;
    const int tt = t0 - p.pad_l + r, ch = c0 + grp * 8;
    uint4 q = make_uint4(0, 0, 0, 0);
    if (!(NSD_WINDOW_CUT & 1) && tt >= 0 && tt < p.t && ch < p.d) {
      const bf16* row = hq + ((size_t)b * p.t + tt) * 2 * p.d + ch;
      float a[8], g[8];
      bf16x8(row, a);
      bf16x8(row + p.d, g);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(a[2 * e] * nsd::sigmoid(g[2 * e]),
                                     a[2 * e + 1] * nsd::sigmoid(g[2 * e + 1]));
    }
    *reinterpret_cast<uint4*>(win + r * kWideChan + grp * 8) = q;
  }
  __syncthreads();
  const int grp = threadIdx.x % kWideGroups;
  const int r0 = threadIdx.x / kWideGroups * kWideFrames;  // frame t0 + r0 + j reads rows r0 + j + k
  const int ch = c0 + grp * 8;
  if (ch >= p.d || t0 + r0 >= p.t) return;
  float acc[kWideFrames][8], ring[kWideFrames][8];  // window row r0 + x in ring[x % kWideFrames]
#pragma unroll
  for (int j = 0; j < kWideFrames; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = -0.f;
#pragma unroll
  for (int x = 0; x + 1 < kWideFrames; ++x)
    bf16x8(win + (r0 + x) * kWideChan + grp * 8, ring[x]);
  for (int k0 = 0; k0 < p.kw && !(NSD_WINDOW_CUT & 4); k0 += kWideFrames) {
#pragma unroll
    for (int kk = 0; kk < kWideFrames; ++kk) {
      const int k = k0 + kk;
      if (k < p.kw) {
        bf16x8(win + (r0 + k + kWideFrames - 1) * kWideChan + grp * 8,
               ring[(kk + kWideFrames - 1) % kWideFrames]);
        const float4 lo = *reinterpret_cast<const float4*>(stap + k * kWideChan + grp * 4);
        const float4 hi =
            *reinterpret_cast<const float4*>(stap + k * kWideChan + kWideChan / 2 + grp * 4);
        const float tap[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < kWideFrames; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[j][e] = __fmaf_rn(ring[(j + kk) % kWideFrames][e], tap[e], acc[j][e]);
      }
    }
  }
  float bias[8];
  nsd::load_raw<8>(dw_b + ch, bias);
#pragma unroll
  for (int j = 0; j < kWideFrames; ++j) {
    if (t0 + r0 + j >= p.t) break;
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(__fadd_rn(acc[j][2 * e], bias[2 * e]),
                                   __fadd_rn(acc[j][2 * e + 1], bias[2 * e + 1]));
    *reinterpret_cast<uint4*>(cq + ((size_t)b * p.t + t0 + r0 + j) * p.d + ch) = q;
  }
}

// cq from hq on glu_dwconv_wide_kernel: D a multiple of 8, hq and cq
// 16-byte aligned (the workspace's).
cudaError_t glu_dwconv_wide(const bf16* hq, const float* taps, const float* dwb, bf16* cq,
                            const Shape& p, cudaStream_t st) {
  const size_t smem = (size_t)p.kw * kWideChan * 4 + (size_t)(kWideTime + p.kw - 1) * kWideChan * 2;
  NSD_TRY(cudaFuncSetAttribute(glu_dwconv_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem)));
  const dim3 grid((p.d + kWideChan - 1) / kWideChan, (p.t + kWideTime - 1) / kWideTime, p.b);
  glu_dwconv_wide_kernel<<<grid, 256, smem, st>>>(hq, taps, dwb, cq, p);
  return cudaGetLastError();
}

// The depthwise conv's and the GLU's backward for 32 channels of one batch
// row, walking the frames in tiles of 64:
//   dglu[t] = sum_k dc[t + pad_l - k] * taps[k]  (the flipped taps, k = 0 up)
//   dh = (dglu * sig(g), dglu * a * sig(g) * (1 - sig(g)))  in float32
//   part[b][k][ch] = sum_t dc[t] * glu[t + k - pad_l]  (unrounded glu)
// dhq (may be null) gets dh rounded to T, a product's operand.
template <typename T>
__global__ void __launch_bounds__(256)
    dwconv_bwd_kernel(const T* __restrict__ hq, const float* __restrict__ dc,
                      const float* __restrict__ taps, float* __restrict__ dh,
                      T* __restrict__ dhq, float* __restrict__ part, Shape p) {
  extern __shared__ float smem[];
  const int rows = kTimeTile + p.kw - 1;
  float* dcw = smem;                        // dc[t0 - pad_r + r]
  float* gluw = smem + rows * kChanTile;    // glu[t0 - pad_l + r]
  const int c0 = blockIdx.x * kChanTile, b = blockIdx.y;
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int pad_r = p.kw - 1 - p.pad_l;
  const int n_pairs = p.kw * kChanTile;  // (tap, channel) pairs of the taps' gradient
  float acc[kMaxTaps * kChanTile / 256];
#pragma unroll
  for (int i = 0; i < kMaxTaps * kChanTile / 256; ++i) acc[i] = 0.f;
  for (int t0 = 0; t0 < p.t; t0 += kTimeTile) {
    for (int i = threadIdx.x; i < rows * kChanTile; i += 256) {
      const int r = i / kChanTile, c = i % kChanTile, ch = c0 + c;
      const int td = t0 - pad_r + r, tg = t0 - p.pad_l + r;
      dcw[i] = (td >= 0 && td < p.t && ch < p.d) ? dc[((size_t)b * p.t + td) * p.d + ch]
                                                 : 0.f;
      gluw[i] = (tg >= 0 && tg < p.t && ch < p.d) ? glu_at(hq, b * p.t + tg, ch, p.d)
                                                  : 0.f;
    }
    __syncthreads();
    const int ch = c0 + lane;
    if (ch < p.d) {
      for (int r = g; r < kTimeTile && t0 + r < p.t; r += 8) {
        float dg = dcw[(r + p.kw - 1) * kChanTile + lane] * taps[ch];
        for (int k = 1; k < p.kw; ++k)
          dg = dg + dcw[(r + p.kw - 1 - k) * kChanTile + lane] * taps[(size_t)k * p.d + ch];
        const size_t m = (size_t)b * p.t + t0 + r;
        const float a = nsd::to_f32(hq[m * 2 * p.d + ch]);
        const float sg = nsd::sigmoid(nsd::to_f32(hq[m * 2 * p.d + p.d + ch]));
        const float da = dg * sg, dgate = dg * a * sg * (1.f - sg);
        dh[m * 2 * p.d + ch] = da;
        dh[m * 2 * p.d + p.d + ch] = dgate;
        if (dhq) {
          dhq[m * 2 * p.d + ch] = nsd::from_f32<T>(da);
          dhq[m * 2 * p.d + p.d + ch] = nsd::from_f32<T>(dgate);
        }
      }
    }
    // the taps' gradient: pair i = (tap i / 32, channel i % 32)
    const int n_rows = min(kTimeTile, p.t - t0);
#pragma unroll
    for (int j = 0; j < kMaxTaps * kChanTile / 256; ++j) {
      const int i = threadIdx.x + j * 256;
      if (i >= n_pairs) break;
      const int k = i / kChanTile, c = i % kChanTile;
      float s = acc[j];
      for (int r = 0; r < n_rows; ++r)
        s += dcw[(r + pad_r) * kChanTile + c] * gluw[(r + k) * kChanTile + c];
      acc[j] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxTaps * kChanTile / 256; ++j) {
    const int i = threadIdx.x + j * 256;
    if (i >= n_pairs) break;
    const int k = i / kChanTile, ch = c0 + i % kChanTile;
    if (ch < p.d) part[((size_t)b * p.kw + k) * p.d + ch] = acc[j];
  }
}

// The pieces of the workspace (pointers from base, or sizes from nullptr).
// s2, s1: the sm90 or f32 backward's K ranges of dW2 and dW1, 1 and 1 for
// the sm90 or f32 forward, or 0 for the tile body.
template <typename T>
struct Work {
  float2 *st1, *st2;
  T *hq, *cq;
  float *gm, *dcn, *dc, *dh, *split, *part, *taps_part;
  float* o;              // the sm90 forward: s . W2 + b2 in float32 (rate > 0)
  T *xn, *s, *gq, *dhq;  // the operand bodies' (gq, dhq: the sm90 backward's)
  size_t bytes;
  Work(const Shape& p, bool bwd, char* base, int s2 = 0, int s1 = 0) {
    Carve c;
    c.base = base;
    const size_t m = p.m(), d = p.d;
    const bool operands = s2 > 0 || s1 > 0;  // an operand body (sm90, f32)
    st1 = c.take<float2>(m);
    st2 = c.take<float2>(m);
    hq = c.take<T>(m * 2 * d);
    cq = c.take<T>(m * d);
    gm = dcn = dc = dh = split = part = taps_part = o = nullptr;
    xn = s = gq = dhq = nullptr;
    if (!bwd && operands) {
      xn = c.take<T>(m * d);
      s = c.take<T>(m * d);
      if (sizeof(T) == 2) o = c.take<float>(m * d);  // the f32 forward's o is out itself
    }
    if (bwd) {
      gm = c.take<float>(m * d);
      dcn = c.take<float>(m * d);
      dc = c.take<float>(m * d);
      dh = c.take<float>(m * 2 * d);
      // the tile body's split sums always go through the workspace; the
      // operand bodies' only where a product has more than one K range
      if (!operands) {
        s1 = nsd::gemm_splits(p.d, 2 * p.d, p.m());
        s2 = nsd::gemm_splits(p.d, p.d, p.m());
      }
      const size_t n1 = !operands || s1 > 1 ? (size_t)s1 * 2 * d * d : 0;
      const size_t n2 = !operands || s2 > 1 ? (size_t)s2 * d * d : 0;
      split = c.take<float>(n1 > n2 ? n1 : n2);
      part = c.take<float>((size_t)nsd::kColChunks * 2 * d);
      taps_part = c.take<float>((size_t)p.b * p.kw * d);
      if (operands) {
        xn = c.take<T>(m * d);
        s = c.take<T>(m * d);
        if (sizeof(T) == 2) {  // float32's are gm and dh themselves
          gq = c.take<T>(m * d);
          dhq = c.take<T>(m * 2 * d);
        }
      }
    }
    bytes = c.off;
  }
};

size_t window_bytes(const Shape& p, int n) {
  return sizeof(float) * n * (kTimeTile + p.kw - 1) * kChanTile;
}

// cq from hq on glu_dwconv_kernel (any D, any alignment).
template <typename T>
cudaError_t glu_dwconv(const T* hq, const float* taps, const float* dwb, T* cq, const Shape& p,
                       cudaStream_t st) {
  const dim3 grid((p.d + kChanTile - 1) / kChanTile, (p.t + kTimeTile - 1) / kTimeTile, p.b);
  glu_dwconv_kernel<T><<<grid, 256, window_bytes(p, 1), st>>>(hq, taps, dwb, cq, p);
  return cudaGetLastError();
}

// Forward up to cq and the second norm's statistics (shared by both
// directions).
template <typename T>
cudaError_t conv_front(const T* x, const float* lns, const float* lnb, const T* w1,
                       const float* b1, const float* taps, const float* dwb,
                       const Work<T>& w, const Shape& p, cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  const int M = p.m();
  NSD_TRY(nsd::ln_stats(x, w.st1, M, p.d, st));
  NSD_TRY(nsd::gemm(bf16, M, 2 * p.d, p.d, 1, LnLoad<T>{x, w.st1, lns, lnb, p.d},
                    Mat<T, T>{w1, 2 * p.d}, BiasRoundEpi<T>{b1, w.hq, 2 * p.d}, st));
  NSD_TRY(glu_dwconv(w.hq, taps, dwb, w.cq, p, st));
  return nsd::ln_stats(w.cq, w.st2, M, p.d, st);
}

template <typename T>
cudaError_t conv_fwd(const T* x, const float* lns, const float* lnb, const T* w1,
                     const float* b1, const float* taps, const float* dwb,
                     const float* ln2s, const float* ln2b, const T* w2, const float* b2,
                     const int32_t* seed, T* out, char* ws, const Shape& p,
                     cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  Work<T> w(p, false, ws);
  NSD_TRY(conv_front(x, lns, lnb, w1, b1, taps, dwb, w, p, st));
  return nsd::gemm(bf16, p.m(), p.d, p.d, 1,
                   LnSiluLoad<T>{{w.cq, w.st2, ln2s, ln2b, p.d}}, Mat<T, T>{w2, p.d},
                   OutEpi<T>{b2, seed, out, p.t, p.d, p.rate, p.inv}, st);
}

template <typename T>
cudaError_t conv_bwd(const T* x, const float* lns, const float* lnb, const T* w1,
                     const float* b1, const float* taps, const float* dwb,
                     const float* ln2s, const float* ln2b, const T* w2,
                     const int32_t* seed, const T* g, T* dx, float* dlns, float* dlnb,
                     T* dw1, float* db1, float* dtaps, float* ddwb, float* dln2s,
                     float* dln2b, T* dw2, float* db2, char* ws, const Shape& p,
                     cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  Work<T> w(p, true, ws);
  const int M = p.m(), D = p.d;
  NSD_TRY(conv_front(x, lns, lnb, w1, b1, taps, dwb, w, p, st));
  const LnLoad<T> ln2{w.cq, w.st2, ln2s, ln2b, D};
  // through the output dropout; db2; dW2 = s^T . cdt(gm)
  NSD_TRY(nsd::mask_grad(g, seed, w.gm, static_cast<T*>(nullptr), p.b, p.t, D, 0, p.rate,
                         p.inv, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.gm, D}, w.part, db2, M, D, st));
  const Mat<float, T> gq{w.gm, D};
  NSD_TRY(nsd::gemm_split_sum<T>(bf16, D, D, M, Tr<LnSiluLoad<T>>{{ln2}}, gq, w.split, dw2,
                                 st));
  // ds = cdt(gm) . W2^T -> dcn through SiLU'; the second norm's backward
  NSD_TRY(nsd::gemm(bf16, M, D, D, 1, gq, Tr<Mat<T, T>>{{w2, D}}, DcnEpi<T>{ln2, w.dcn},
                    st));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<T>{w.dcn, w.cq, w.st2, D}, w.part, dln2s, M, D,
                      st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.dcn, D}, w.part, dln2b, M, D, st));
  NSD_TRY(nsd::ln_bwd(w.dcn, w.cq, w.st2, ln2s, w.dc, M, D, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.dc, D}, w.part, ddwb, M, D, st));
  // the depthwise conv's and the GLU's backward; the taps' gradient
  dwconv_bwd_kernel<T><<<dim3((D + kChanTile - 1) / kChanTile, p.b), 256,
                         window_bytes(p, 2), st>>>(w.hq, w.dc, taps, w.dh, nullptr,
                                                   w.taps_part, p);
  NSD_TRY(cudaGetLastError());
  NSD_TRY(nsd::sum_parts(w.taps_part, dtaps, p.b, p.kw * D, st));
  // db1; dW1 = xn^T . cdt(dh); dxn = cdt(dh) . W1^T (into gm's room)
  NSD_TRY(nsd::colsum(nsd::Elem{w.dh, 2 * D}, w.part, db1, M, 2 * D, st));
  const LnLoad<T> xn{x, w.st1, lns, lnb, D};
  const Mat<float, T> dhq{w.dh, 2 * D};
  NSD_TRY(nsd::gemm_split_sum<T>(bf16, D, 2 * D, M, Tr<LnLoad<T>>{xn}, dhq, w.split, dw1,
                                 st));
  float* dxn = w.gm;
  NSD_TRY(nsd::gemm(bf16, M, D, 2 * D, 1, dhq, Tr<Mat<T, T>>{{w1, 2 * D}},
                    nsd::StoreF32{dxn, D}, st));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<T>{dxn, x, w.st1, D}, w.part, dlns, M, D, st));
  NSD_TRY(nsd::colsum(nsd::Elem{dxn, D}, w.part, dlnb, M, D, st));
  return nsd::ln_bwd(dxn, x, w.st1, lns, dx, M, D, st);
}

// The front of both sm90 bodies, up to cq, s and the second norm's
// statistics: xn = cdt(LN(x)) written by a row pass, hq = cdt(xn . W1 + b1)
// on gemm_sm90.cuh, the GLU and depthwise conv on glu_dwconv_wide_kernel
// (conv_front's cq, bit for bit), then s = cdt(SiLU(cdt(LN2(cq)))).
cudaError_t conv_front_sm90(const bf16* x, const float* lns, const float* lnb, const bf16* w1,
                            const float* b1, const float* taps, const float* dwb,
                            const float* ln2s, const float* ln2b, const Work<bf16>& w,
                            const Shape& p, cudaStream_t st) {
  const int M = p.m(), D = p.d;
  NSD_TRY((nsd::ln_apply<bf16, false>(x, w.st1, lns, lnb, w.xn, M, D, st)));
  NSD_TRY((sm90::gemm<false, true>(w.xn, w1, b1, sm90::StoreBf16{w.hq, 2 * D}, M, 2 * D, D,
                                   1, st)));
  NSD_TRY(glu_dwconv_wide(w.hq, taps, dwb, w.cq, p, st));
  return nsd::ln_apply<bf16, true>(w.cq, w.st2, ln2s, ln2b, w.s, M, D, st);
}

// The forward's sm90 body (bf16): the front, then o = s . W2 + b2 on
// gemm_sm90.cuh: at rate 0 bias + one rounding in the product's store
// (OutEpi's value); otherwise o stored in float32 and the output dropout
// (salt b) applied by a pass that rounds.
cudaError_t conv_fwd_sm90(const bf16* x, const float* lns, const float* lnb, const bf16* w1,
                          const float* b1, const float* taps, const float* dwb,
                          const float* ln2s, const float* ln2b, const bf16* w2,
                          const float* b2, const int32_t* seed, bf16* out, char* ws,
                          const Shape& p, cudaStream_t st) {
  Work<bf16> w(p, false, ws, 1, 1);
  const int M = p.m(), D = p.d;
  NSD_TRY(conv_front_sm90(x, lns, lnb, w1, b1, taps, dwb, ln2s, ln2b, w, p, st));
  if (p.rate <= 0.f)
    return sm90::gemm<false, true>(w.s, w2, b2, sm90::StoreBf16{out, D}, M, D, D, 1, st);
  NSD_TRY((sm90::gemm<false, true>(w.s, w2, b2, nsd::StoreF32{w.o, D}, M, D, D, 1, st)));
  return nsd::each_cols(nsd::DropRoundPass<bf16>{w.o, seed, out, p.t, 0, D, p.rate, p.inv}, M,
                        D, st);
}

// The backward's sm90 body (bf16): conv_bwd's stages, every product on
// gemm_sm90.cuh reading bf16 operands written once (see the header); s2 and
// s1 are the K ranges of dW2 and dW1.
cudaError_t conv_bwd_sm90(const bf16* x, const float* lns, const float* lnb, const bf16* w1,
                          const float* b1, const float* taps, const float* dwb,
                          const float* ln2s, const float* ln2b, const bf16* w2,
                          const int32_t* seed, const bf16* g, bf16* dx, float* dlns,
                          float* dlnb, bf16* dw1, float* db1, float* dtaps, float* ddwb,
                          float* dln2s, float* dln2b, bf16* dw2, float* db2, char* ws,
                          const Shape& p, int s2, int s1, cudaStream_t st) {
  Work<bf16> w(p, true, ws, s2, s1);
  const int M = p.m(), D = p.d;
  NSD_TRY(conv_front_sm90(x, lns, lnb, w1, b1, taps, dwb, ln2s, ln2b, w, p, st));
  const LnLoad<bf16> ln2{w.cq, w.st2, ln2s, ln2b, D};
  // through the output dropout (gm, and gq = cdt(gm)); db2; dW2 = s^T . gq
  NSD_TRY(nsd::mask_grad(g, seed, w.gm, w.gq, p.b, p.t, D, 0, p.rate, p.inv, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.gm, D}, w.part, db2, M, D, st));
  NSD_TRY(sm90::gemm_tn_split(w.s, w.gq, dw2, D, D, M, s2, w.split, st));
  // ds = gq . W2^T (into dcn's room) -> dcn through SiLU'; the second norm's
  // backward
  NSD_TRY((sm90::gemm<false, false>(w.gq, w2, nullptr, nsd::StoreF32{w.dcn, D}, M, D, D, 1,
                                    st)));
  NSD_TRY(nsd::each_cols(DcnPass<bf16>{ln2, w.dcn}, M, D, st));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<bf16>{w.dcn, w.cq, w.st2, D}, w.part, dln2s, M, D,
                      st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.dcn, D}, w.part, dln2b, M, D, st));
  NSD_TRY(nsd::ln_bwd(w.dcn, w.cq, w.st2, ln2s, w.dc, M, D, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.dc, D}, w.part, ddwb, M, D, st));
  // the depthwise conv's and the GLU's backward (dh, and dhq = cdt(dh)); the
  // taps' gradient
  dwconv_bwd_kernel<bf16><<<dim3((D + kChanTile - 1) / kChanTile, p.b), 256,
                            window_bytes(p, 2), st>>>(w.hq, w.dc, taps, w.dh, w.dhq,
                                                      w.taps_part, p);
  NSD_TRY(cudaGetLastError());
  NSD_TRY(nsd::sum_parts(w.taps_part, dtaps, p.b, p.kw * D, st));
  // db1; dW1 = xn^T . dhq; dxn = dhq . W1^T (into gm's room)
  NSD_TRY(nsd::colsum(nsd::Elem{w.dh, 2 * D}, w.part, db1, M, 2 * D, st));
  NSD_TRY(sm90::gemm_tn_split(w.xn, w.dhq, dw1, D, 2 * D, M, s1, w.split, st));
  float* dxn = w.gm;
  NSD_TRY((sm90::gemm<false, false>(w.dhq, w1, nullptr, nsd::StoreF32{dxn, D}, M, D, 2 * D, 1,
                                    st)));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<bf16>{dxn, x, w.st1, D}, w.part, dlns, M, D, st));
  NSD_TRY(nsd::colsum(nsd::Elem{dxn, D}, w.part, dlnb, M, D, st));
  return nsd::ln_bwd(dxn, x, w.st1, lns, dx, M, D, st);
}

// The front of both f32 bodies (float32), up to cq, s and the second
// norm's statistics: xn = LN(x) by a row pass, hq = xn . W1 + b1 on
// gemm_f32.cuh (nn, b1 in the tile's store), the GLU and depthwise conv on
// glu_dwconv_kernel, then s = SiLU(LN2(cq)) by a row pass.
cudaError_t conv_front_f32(const float* x, const float* lns, const float* lnb, const float* w1,
                           const float* b1, const float* taps, const float* dwb,
                           const float* ln2s, const float* ln2b, const Work<float>& w,
                           const Shape& p, cudaStream_t st) {
  const int M = p.m(), D = p.d;
  NSD_TRY((nsd::ln_apply<float, false>(x, w.st1, lns, lnb, w.xn, M, D, st)));
  NSD_TRY((f32::gemm<false, true>(w.xn, D, w1, 2 * D, b1, w.hq, M, 2 * D, D, st)));
  NSD_TRY(glu_dwconv(w.hq, taps, dwb, w.cq, p, st));
  return nsd::ln_apply<float, true>(w.cq, w.st2, ln2s, ln2b, w.s, M, D, st);
}

// The forward's f32 body (float32): the front, then o = s . W2 + b2 on
// gemm_f32.cuh (nn) straight into out, which is OutEpi's value at rate 0;
// otherwise the output dropout (salt b, the float32 inv) by a pass over out
// in place.
cudaError_t conv_fwd_f32(const float* x, const float* lns, const float* lnb, const float* w1,
                         const float* b1, const float* taps, const float* dwb,
                         const float* ln2s, const float* ln2b, const float* w2,
                         const float* b2, const int32_t* seed, float* out, char* ws,
                         const Shape& p, cudaStream_t st) {
  Work<float> w(p, false, ws, 1, 1);
  const int M = p.m(), D = p.d;
  NSD_TRY(conv_front_f32(x, lns, lnb, w1, b1, taps, dwb, ln2s, ln2b, w, p, st));
  NSD_TRY((f32::gemm<false, true>(w.s, D, w2, D, b2, out, M, D, D, st)));
  if (p.rate <= 0.f) return cudaSuccess;
  return nsd::each_cols(nsd::DropRoundPass<float>{out, seed, out, p.t, 0, D, p.rate, p.inv}, M,
                        D, st);
}

// The backward's f32 body (float32): conv_bwd's stages, every product on
// gemm_f32.cuh reading float32 arrays where they lie (see the header); s2
// and s1 are the K ranges of dW2 and dW1.
cudaError_t conv_bwd_f32(const float* x, const float* lns, const float* lnb, const float* w1,
                         const float* b1, const float* taps, const float* dwb,
                         const float* ln2s, const float* ln2b, const float* w2,
                         const int32_t* seed, const float* g, float* dx, float* dlns,
                         float* dlnb, float* dw1, float* db1, float* dtaps, float* ddwb,
                         float* dln2s, float* dln2b, float* dw2, float* db2, char* ws,
                         const Shape& p, int s2, int s1, cudaStream_t st) {
  Work<float> w(p, true, ws, s2, s1);
  const int M = p.m(), D = p.d;
  // the forward again, keeping xn, hq, cq and s
  NSD_TRY(conv_front_f32(x, lns, lnb, w1, b1, taps, dwb, ln2s, ln2b, w, p, st));
  const LnLoad<float> ln2{w.cq, w.st2, ln2s, ln2b, D};
  // through the output dropout; db2; dW2 = s^T . gm (tn)
  NSD_TRY(nsd::mask_grad(g, seed, w.gm, static_cast<float*>(nullptr), p.b, p.t, D, 0, p.rate,
                         p.inv, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.gm, D}, w.part, db2, M, D, st));
  NSD_TRY(f32::gemm_tn_split(w.s, w.gm, dw2, D, D, M, s2, w.split, st));
  // ds = gm . W2^T (nt, into dcn's room) -> dcn through SiLU'; the second
  // norm's backward
  NSD_TRY((f32::gemm<false, false>(w.gm, D, w2, D, nullptr, w.dcn, M, D, D, st)));
  NSD_TRY(nsd::each_cols(DcnPass<float>{ln2, w.dcn}, M, D, st));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<float>{w.dcn, w.cq, w.st2, D}, w.part, dln2s, M, D,
                      st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.dcn, D}, w.part, dln2b, M, D, st));
  NSD_TRY(nsd::ln_bwd(w.dcn, w.cq, w.st2, ln2s, w.dc, M, D, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.dc, D}, w.part, ddwb, M, D, st));
  // the depthwise conv's and the GLU's backward; the taps' gradient
  dwconv_bwd_kernel<float><<<dim3((D + kChanTile - 1) / kChanTile, p.b), 256,
                             window_bytes(p, 2), st>>>(w.hq, w.dc, taps, w.dh, nullptr,
                                                       w.taps_part, p);
  NSD_TRY(cudaGetLastError());
  NSD_TRY(nsd::sum_parts(w.taps_part, dtaps, p.b, p.kw * D, st));
  // db1; dW1 = xn^T . dh (tn); dxn = dh . W1^T (nt, into gm's room)
  NSD_TRY(nsd::colsum(nsd::Elem{w.dh, 2 * D}, w.part, db1, M, 2 * D, st));
  NSD_TRY(f32::gemm_tn_split(w.xn, w.dh, dw1, D, 2 * D, M, s1, w.split, st));
  float* dxn = w.gm;
  NSD_TRY((f32::gemm<false, false>(w.dh, 2 * D, w1, 2 * D, nullptr, dxn, M, D, 2 * D, st)));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<float>{dxn, x, w.st1, D}, w.part, dlns, M, D, st));
  NSD_TRY(nsd::colsum(nsd::Elem{dxn, D}, w.part, dlnb, M, D, st));
  return nsd::ln_bwd(dxn, x, w.st1, lns, dx, M, D, st);
}

bool bad_shape(int b, int t, int d, int kw, int pad_l) {
  return b < 1 || t < 1 || d < 1 || kw < 1 || kw > kMaxTaps || pad_l < 0 || pad_l >= kw;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Shape make_shape(int b, int t, int d, int kw, int pad_l, float rate, float inv) {
  Shape p;
  p.b = b;
  p.t = t;
  p.d = d;
  p.kw = kw;
  p.pad_l = pad_l;
  p.rate = rate;
  p.inv = inv;
  return p;
}

}  // namespace

extern "C" {

// Bytes of workspace the forward (bwd = 0) or backward (bwd = 1) takes.
long long nsd_conv_workspace(int b, int t, int d, int kw, int bf16, int bwd) {
  const Shape p = make_shape(b, t, d, kw, 0, 0.f, 1.f);
  return static_cast<long long>(bf16 ? Work<__nv_bfloat16>(p, bwd, nullptr).bytes
                                     : Work<float>(p, bwd, nullptr).bytes);
}

#define NSD_CONV_ENTRIES(SUFFIX, T)                                                         \
  int nsd_conv_fwd_##SUFFIX(const void* x, const void* lns, const void* lnb,                \
                            const void* w1, const void* b1, const void* taps,               \
                            const void* dwb, const void* ln2s, const void* ln2b,            \
                            const void* w2, const void* b2, const void* seed, void* out,    \
                            void* ws, int b, int t, int d, int kw, int pad_l, float rate,   \
                            float inv, void* stream) {                                      \
    if (bad_shape(b, t, d, kw, pad_l)) return static_cast<int>(cudaErrorInvalidValue);      \
    return static_cast<int>(conv_fwd<T>(                                                    \
        static_cast<const T*>(x), static_cast<const float*>(lns),                           \
        static_cast<const float*>(lnb), static_cast<const T*>(w1),                          \
        static_cast<const float*>(b1), static_cast<const float*>(taps),                     \
        static_cast<const float*>(dwb), static_cast<const float*>(ln2s),                    \
        static_cast<const float*>(ln2b), static_cast<const T*>(w2),                         \
        static_cast<const float*>(b2), static_cast<const int32_t*>(seed),                   \
        static_cast<T*>(out), static_cast<char*>(ws),                                       \
        make_shape(b, t, d, kw, pad_l, rate, inv), static_cast<cudaStream_t>(stream)));     \
  }                                                                                         \
  int nsd_conv_bwd_##SUFFIX(                                                                \
      const void* x, const void* lns, const void* lnb, const void* w1, const void* b1,      \
      const void* taps, const void* dwb, const void* ln2s, const void* ln2b,                \
      const void* w2, const void* seed, const void* g, void* dx, void* dlns, void* dlnb,    \
      void* dw1, void* db1, void* dtaps, void* ddwb, void* dln2s, void* dln2b, void* dw2,   \
      void* db2, void* ws, int b, int t, int d, int kw, int pad_l, float rate, float inv,   \
      void* stream) {                                                                       \
    if (bad_shape(b, t, d, kw, pad_l)) return static_cast<int>(cudaErrorInvalidValue);      \
    return static_cast<int>(conv_bwd<T>(                                                    \
        static_cast<const T*>(x), static_cast<const float*>(lns),                           \
        static_cast<const float*>(lnb), static_cast<const T*>(w1),                          \
        static_cast<const float*>(b1), static_cast<const float*>(taps),                     \
        static_cast<const float*>(dwb), static_cast<const float*>(ln2s),                    \
        static_cast<const float*>(ln2b), static_cast<const T*>(w2),                         \
        static_cast<const int32_t*>(seed), static_cast<const T*>(g), static_cast<T*>(dx),   \
        static_cast<float*>(dlns), static_cast<float*>(dlnb), static_cast<T*>(dw1),         \
        static_cast<float*>(db1), static_cast<float*>(dtaps), static_cast<float*>(ddwb),    \
        static_cast<float*>(dln2s), static_cast<float*>(dln2b), static_cast<T*>(dw2),       \
        static_cast<float*>(db2), static_cast<char*>(ws),                                   \
        make_shape(b, t, d, kw, pad_l, rate, inv), static_cast<cudaStream_t>(stream)));     \
  }

NSD_CONV_ENTRIES(tile_f32, float)
NSD_CONV_ENTRIES(tile_bf16, __nv_bfloat16)

// Bytes of workspace the sm90 forward takes.
long long nsd_conv_fwd_sm90_workspace(int b, int t, int d, int kw) {
  const Shape p = make_shape(b, t, d, kw, 0, 0.f, 1.f);
  return static_cast<long long>(Work<bf16>(p, false, nullptr, 1, 1).bytes);
}

// The bf16 forward on gemm_sm90.cuh: nsd_conv_fwd_tile_bf16's arguments. D a
// multiple of 8, x, W1, W2 and out 16-byte aligned: cudaErrorInvalidValue
// otherwise.
int nsd_conv_fwd_sm90(const void* x, const void* lns, const void* lnb, const void* w1,
                      const void* b1, const void* taps, const void* dwb, const void* ln2s,
                      const void* ln2b, const void* w2, const void* b2, const void* seed,
                      void* out, void* ws, int b, int t, int d, int kw, int pad_l, float rate,
                      float inv, void* stream) {
  if (bad_shape(b, t, d, kw, pad_l) || d % 8 || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(conv_fwd_sm90(
      static_cast<const bf16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(ln2s),
      static_cast<const float*>(ln2b), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const int32_t*>(seed), static_cast<bf16*>(out),
      static_cast<char*>(ws), make_shape(b, t, d, kw, pad_l, rate, inv),
      static_cast<cudaStream_t>(stream)));
}

// Bytes of workspace the sm90 backward takes with s2 and s1 K ranges.
long long nsd_conv_bwd_sm90_workspace(int b, int t, int d, int kw, int s2, int s1) {
  const Shape p = make_shape(b, t, d, kw, 0, 0.f, 1.f);
  return static_cast<long long>(Work<bf16>(p, true, nullptr, s2, s1).bytes);
}

// The bf16 backward on gemm_sm90.cuh: nsd_conv_bwd_tile_bf16's arguments,
// and the K ranges of dW2 (s2) and dW1 (s1). D a multiple of 8, W1 and W2
// 16-byte aligned: cudaErrorInvalidValue otherwise.
int nsd_conv_bwd_sm90(const void* x, const void* lns, const void* lnb, const void* w1,
                      const void* b1, const void* taps, const void* dwb, const void* ln2s,
                      const void* ln2b, const void* w2, const void* seed, const void* g,
                      void* dx, void* dlns, void* dlnb, void* dw1, void* db1, void* dtaps,
                      void* ddwb, void* dln2s, void* dln2b, void* dw2, void* db2, void* ws,
                      int b, int t, int d, int kw, int pad_l, int s2, int s1, float rate,
                      float inv, void* stream) {
  if (bad_shape(b, t, d, kw, pad_l) || d % 8 || s2 < 1 || s1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(conv_bwd_sm90(
      static_cast<const bf16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(ln2s),
      static_cast<const float*>(ln2b), static_cast<const bf16*>(w2),
      static_cast<const int32_t*>(seed), static_cast<const bf16*>(g), static_cast<bf16*>(dx),
      static_cast<float*>(dlns), static_cast<float*>(dlnb), static_cast<bf16*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dtaps), static_cast<float*>(ddwb),
      static_cast<float*>(dln2s), static_cast<float*>(dln2b), static_cast<bf16*>(dw2),
      static_cast<float*>(db2), static_cast<char*>(ws),
      make_shape(b, t, d, kw, pad_l, rate, inv), s2, s1, static_cast<cudaStream_t>(stream)));
}

// Bytes of workspace the f32 forward takes.
long long nsd_conv_fwd_f32_workspace(int b, int t, int d, int kw) {
  const Shape p = make_shape(b, t, d, kw, 0, 0.f, 1.f);
  return static_cast<long long>(Work<float>(p, false, nullptr, 1, 1).bytes);
}

// The float32 forward on gemm_f32.cuh: nsd_conv_fwd_tile_f32's arguments. D
// a multiple of 4, W1, W2 and out 16-byte aligned: cudaErrorInvalidValue
// otherwise.
int nsd_conv_fwd_f32(const void* x, const void* lns, const void* lnb, const void* w1,
                     const void* b1, const void* taps, const void* dwb, const void* ln2s,
                     const void* ln2b, const void* w2, const void* b2, const void* seed,
                     void* out, void* ws, int b, int t, int d, int kw, int pad_l, float rate,
                     float inv, void* stream) {
  if (bad_shape(b, t, d, kw, pad_l) || d % 4 || !aligned16(w1) || !aligned16(w2) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(conv_fwd_f32(
      static_cast<const float*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(ln2s),
      static_cast<const float*>(ln2b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const int32_t*>(seed), static_cast<float*>(out),
      static_cast<char*>(ws), make_shape(b, t, d, kw, pad_l, rate, inv),
      static_cast<cudaStream_t>(stream)));
}

// Bytes of workspace the f32 backward takes with s2 and s1 K ranges.
long long nsd_conv_bwd_f32_workspace(int b, int t, int d, int kw, int s2, int s1) {
  const Shape p = make_shape(b, t, d, kw, 0, 0.f, 1.f);
  return static_cast<long long>(Work<float>(p, true, nullptr, s2, s1).bytes);
}

// The float32 backward on gemm_f32.cuh: nsd_conv_bwd_tile_f32's arguments,
// and the K ranges of dW2 (s2) and dW1 (s1). D a multiple of 4, W1, W2, dW1
// and dW2 16-byte aligned: cudaErrorInvalidValue otherwise.
int nsd_conv_bwd_f32(const void* x, const void* lns, const void* lnb, const void* w1,
                     const void* b1, const void* taps, const void* dwb, const void* ln2s,
                     const void* ln2b, const void* w2, const void* seed, const void* g,
                     void* dx, void* dlns, void* dlnb, void* dw1, void* db1, void* dtaps,
                     void* ddwb, void* dln2s, void* dln2b, void* dw2, void* db2, void* ws,
                     int b, int t, int d, int kw, int pad_l, int s2, int s1, float rate,
                     float inv, void* stream) {
  if (bad_shape(b, t, d, kw, pad_l) || d % 4 || s2 < 1 || s1 < 1 || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(dw1) || !aligned16(dw2))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(conv_bwd_f32(
      static_cast<const float*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(taps),
      static_cast<const float*>(dwb), static_cast<const float*>(ln2s),
      static_cast<const float*>(ln2b), static_cast<const float*>(w2),
      static_cast<const int32_t*>(seed), static_cast<const float*>(g), static_cast<float*>(dx),
      static_cast<float*>(dlns), static_cast<float*>(dlnb), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dtaps), static_cast<float*>(ddwb),
      static_cast<float*>(dln2s), static_cast<float*>(dln2b), static_cast<float*>(dw2),
      static_cast<float*>(db2), static_cast<char*>(ws),
      make_shape(b, t, d, kw, pad_l, rate, inv), s2, s1, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
