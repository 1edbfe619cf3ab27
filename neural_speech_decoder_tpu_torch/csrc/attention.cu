// Multi-head self-attention of the Conformer, read straight from the qkv
// projection, with its backward and the dropout masks they draw.
//
//   qkv [B, T, 3D] (float32 or bfloat16; D = H * dh, dh 64 or 128), columns
//   ({q,k,v}, head, dh) or, interleaved, (head, {q,k,v}, dh); lens [B] int32;
//   seed [1] int32 -> out [B, T, D], head-major (head h in columns h*dh..).
//   For each (batch b, head h), query row i and key column j:
//     s[i,j] = (q_i . k_j, accumulated in float32) * scale;
//     s[i,j] = -1e9 where j >= min(len_b, T), and, with a band (left >= 0),
//              where j > i or i - j > left;
//     p[i,:] = softmax(s[i,:]) in float32, and 0 for a row whose maximum is
//              <= -1e9 (every key masked);
//     dropout (rate > 0): p[i,j] * 1/(1-rate) where
//              uniform2d(seed, b*H + h, i, j) >= rate, else 0 (hashrng.cuh);
//     out_i = sum_j round(p[i,j]) v_j, accumulated in float32, where round
//              casts to the input's type; stored in the input's type.
//   The backward takes g [B, T, D] (out's cotangent) and gives dqkv [B, T,
//   3D] in qkv's column layout:
//     dv_j = sum_i round(dropped p[i,j]) g_i;
//     dP[i,j] = g_i . v_j, masked and scaled like p by the dropout;
//     dS = round(p * (dP - rowsum(dP * p)));
//     dq = (dS k) * scale, dk = (dS^T q) * scale, rounded to the input's type.
//
// Replaces the Pallas TPU kernels of
// neural_speech_decoder_tpu/ops/pallas/attention_kernel.py: _fwd_kernel
// (via fused_mhsa_qkv -> _call_fwd), _bwd_kernel (via _fused_bwd) and the
// dropout_masks test hook (hashrng.cuh's hash_masks_kernel, the [bh, t, t]
// masks). Their semantics are kept: the order of the score product and the
// scale, the -1e9 mask constant, zero rows where every key
// is masked (F.scaled_dot_product_attention gives NaN or uniform rows), the
// casts of p and dS to the input's type before their products, and the
// interpret-mode dropout bits (the murmur3 hash; the compiled TPU path's
// hardware PRNG bits cannot be reproduced off the TPU). Each bit is a
// function of (seed, b*H+h, row, col) alone, so T needs no padding to 128.
//
// What bounds it on an H100: the operations. At B=64, T=313, H=8, dh=128 the
// forward's two products are 2 * 2*T*T*dh per (b, h), 12.8 GFLOP each over
// the 512 programs, against 0.12 GB (bf16) of qkv and out; the backward's
// five products (dV, dP, dS, dQ, dK) are 32 GFLOP. The float32 kernels run
// their products on float32 FMAs, so the FMA rate (67 TFLOP/s) is their
// floor (TF32 would change the numbers); the bfloat16 forward and backward
// run on the tensor cores (namespace tc below). At T'=313 their 2560 blocks
// of small tiles are bound by latency and occupancy more than by the
// tensor-core peak, so they use mma.sync, whose register fragments keep the
// elementwise softmax and dS steps simple, rather than wgmma.
//
// Design: the TPU kernel keeps a whole [Tp, Tp] float32 score tile per
// (b, h) in VMEM (576 KB at Tp=384), more than a block's 227 KB of shared
// memory. The float32 kernels that run by default (body "f32", namespace
// f32 at the end) walk the keys once in the forward and form S and dP once
// in the backward. The first port's float32 kernels (body "fma", kept for
// A/B runs) follow here: a block takes 64 query rows of one (b, h) and
// walks the keys in tiles of 64: a first pass forms each row's max and sum
// (online, with rescaling), a second recomputes the scores and forms p,
// its dropout and the product with V. The backward is two kernels: the dQ
// kernel (per query tile) forms the row statistics again, then rowsum(dP *
// p) over all keys, then dS and dQ, and stores the three statistics; the
// dK/dV kernel (per key tile) walks the query tiles with them. No atomics: every sum has a fixed
// order, so a run is reproducible bit for bit. Tiles of keys that every row
// of the block masks (past min(len, T), or outside the band) are skipped;
// they add exact zeros. All operands stay in shared memory in their natural
// [rows][dh] layout, padded to dh+4 floats so that the strided float4 reads
// of the three product shapes (A.B^T, A.B, A^T.B) hit distinct banks.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hashrng.cuh"

namespace {

constexpr int kTile = 64;  // query rows and key columns per tile
constexpr int kThreads = 256;
constexpr int kLDP = kTile + 4;  // row stride of the [64][64] p/dS tiles
constexpr float kNeg = -1e9f;

struct Params {
  int batch, n_time, heads, left;  // left < 0: no band
  float scale, rate, inv_keep;
  int interleaved;
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d);
template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b, float c,
                                              float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Columns of head h's q, k and v in a qkv row.
__device__ __forceinline__ int qkv_col(const Params& p, int which, int h, int dh) {
  return (p.interleaved ? 3 * h + which : which * p.heads + h) * dh;
}

// Rows [row0, row0+64) of a row-major matrix with row stride ld, columns
// [col, col+DH), as float into dst [64][DH+4]; rows >= n_rows are 0.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, size_t ld, int col) {
  constexpr int C4 = DH / 4;
  for (int idx = threadIdx.x; idx < kTile * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c = (idx % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = load4(src + (size_t)(row0 + r) * ld + col + c);
    *reinterpret_cast<float4*>(dst + r * (DH + 4) + c) = v;
  }
}

// acc[r][c] += sum_k A[ty*4+r][k] * B[tx+16c][k]  (A.B^T, both [64][DH+4])
template <int DH>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float acc[4][4], int ty, int tx) {
  constexpr int LD = DH + 4;
#pragma unroll 2
  for (int k = 0; k < DH; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty * 4 + r) * LD + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * LD + k);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(a[r].x, b[c].x, s);
        s = fmaf(a[r].y, b[c].y, s);
        s = fmaf(a[r].z, b[c].z, s);
        s = fmaf(a[r].w, b[c].w, s);
        acc[r][c] = s;
      }
    }
  }
}

// acc[r][g*4+e] += sum_k P[ty*4+r][k] * X[k][g*64+tx*4+e]
// (P [64][64+4] . X [64][DH+4])
template <int DH>
__device__ __forceinline__ void mm_ab(const float* P, const float* X,
                                      float acc[4][DH / 16], int ty, int tx) {
  constexpr int LD = DH + 4;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(P + (ty * 4 + r) * kLDP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < DH / 64; ++g) {
        const float4 b =
            *reinterpret_cast<const float4*>(X + (k + kk) * LD + g * 64 + tx * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av = comp(a[r], kk);
          acc[r][g * 4 + 0] = fmaf(av, b.x, acc[r][g * 4 + 0]);
          acc[r][g * 4 + 1] = fmaf(av, b.y, acc[r][g * 4 + 1]);
          acc[r][g * 4 + 2] = fmaf(av, b.z, acc[r][g * 4 + 2]);
          acc[r][g * 4 + 3] = fmaf(av, b.w, acc[r][g * 4 + 3]);
        }
      }
    }
  }
}

// acc[r][g*4+e] += sum_q P[q][ty*4+r] * X[q][g*64+tx*4+e]
// (P^T . X with P [64][64+4], X [64][DH+4])
template <int DH>
__device__ __forceinline__ void mm_atb(const float* P, const float* X,
                                       float acc[4][DH / 16], int ty, int tx) {
  constexpr int LD = DH + 4;
#pragma unroll 4
  for (int q = 0; q < kTile; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(P + q * kLDP + ty * 4);
#pragma unroll
    for (int g = 0; g < DH / 64; ++g) {
      const float4 b =
          *reinterpret_cast<const float4*>(X + q * LD + g * 64 + tx * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av = comp(a, r);
        acc[r][g * 4 + 0] = fmaf(av, b.x, acc[r][g * 4 + 0]);
        acc[r][g * 4 + 1] = fmaf(av, b.y, acc[r][g * 4 + 1]);
        acc[r][g * 4 + 2] = fmaf(av, b.z, acc[r][g * 4 + 2]);
        acc[r][g * 4 + 3] = fmaf(av, b.w, acc[r][g * 4 + 3]);
      }
    }
  }
}

// Sum or max over the 16 lanes (tx) that share a row.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool masked(const Params& p, int i, int j, int limit) {
  return j >= limit || (p.left >= 0 && (j > i || i - j > p.left));
}

// The softmax probability of score product acc at (i, j), given the row's
// max m and sum l: 0 past the keys, in a fully masked row, or at i >= T
// (m is -inf there).
__device__ __forceinline__ float prob(const Params& p, float acc, int i, int j,
                                      int limit, float m, float l) {
  if (j >= p.n_time || m <= kNeg) return 0.f;
  const float s = masked(p, i, j, limit) ? kNeg : acc * p.scale;
  return expf(s - m) / l;
}

__device__ __forceinline__ bool keep(const Params& p, int seed, int pid, int i,
                                     int j) {
  return p.rate <= 0.f || nsd::hash_uniform(seed, pid, i, j) >= p.rate;
}

// Key tiles [kt0, kt1) that hold an unmasked key of some row in
// [q0, q0+64): keys below limit and, with a band, in [q0-left, q0+63].
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int limit,
                                          int& kt0, int& kt1) {
  kt0 = 0;
  kt1 = (max(limit, 0) + kTile - 1) / kTile;
  if (p.left >= 0) {
    kt0 = max(q0 - p.left, 0) / kTile;
    kt1 = min(kt1, min(q0 + kTile - 1, p.n_time - 1) / kTile + 1);
  }
}

// Each of the thread's four rows' softmax max m and sum l over key tiles
// [kt0, kt1) (online: the running sum is rescaled when the max grows). Ks is
// scratch for the key tiles.
template <typename T, int DH>
__device__ void row_stats(const Params& p, const float* Qs, float* Ks,
                          const T* base, size_t ld, int kcol, int q0, int kt0,
                          int kt1, int limit, float m[4], float l[4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, DH>(Ks, base, k0, p.n_time, ld, kcol);
    __syncthreads();
    float s[4][4] = {};
    mm_abt<DH>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        s[r][c] = j >= p.n_time ? -INFINITY
                  : masked(p, i, j, limit) ? kNeg
                                           : s[r][c] * p.scale;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += expf(s[r][c] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + row_sum(sum);
      m[r] = m_new;
    }
    __syncthreads();
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    attn_fwd_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ seed_ptr, T* __restrict__ out,
                    Params p) {
  constexpr int LD = DH + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kTile * LD;
  float* Ps = KVs + kTile * LD;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * p.n_time * ld;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  int kt0, kt1;
  key_tiles(p, q0, limit, kt0, kt1);
  const int kcol = qkv_col(p, 1, h, DH), vcol = qkv_col(p, 2, h, DH);

  load_tile<T, DH>(Qs, base, q0, p.n_time, ld, qkv_col(p, 0, h, DH));
  float m[4], l[4];
  row_stats<T, DH>(p, Qs, KVs, base, ld, kcol, q0, kt0, kt1, limit, m, l);

  float o[4][DH / 16] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, DH>(KVs, base, k0, p.n_time, ld, kcol);
    __syncthreads();
    float s[4][4] = {};
    mm_abt<DH>(Qs, KVs, s, ty, tx);
    __syncthreads();
    load_tile<T, DH>(KVs, base, k0, p.n_time, ld, vcol);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        float pr = prob(p, s[r][c], i, j, limit, m[r], l[r]);
        if (p.rate > 0.f) pr = keep(p, seed, pid, i, j) ? pr * p.inv_keep : 0.f;
        Ps[(ty * 4 + r) * kLDP + tx + 16 * c] = nsd::round_to<T>(pr);
      }
    }
    __syncthreads();
    mm_ab<DH>(Ps, KVs, o, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.n_time) continue;
    T* row = out + ((size_t)b * p.n_time + i) * d + h * DH;
#pragma unroll
    for (int g = 0; g < DH / 64; ++g)
      store4<T>(row + g * 64 + tx * 4, o[r][g * 4], o[r][g * 4 + 1],
                o[r][g * 4 + 2], o[r][g * 4 + 3]);
  }
}

// dQ per query tile; stores each row's (max, sum, rowsum(dP * p)) in
// stats [3][B*H][T] for the dK/dV kernel.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ lens,
                       const int32_t* __restrict__ seed_ptr,
                       const T* __restrict__ gout, T* __restrict__ dqkv,
                       float* __restrict__ stats, Params p) {
  constexpr int LD = DH + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kTile * LD;
  float* Ks = Gs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ss = Vs + kTile * LD;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * p.n_time * ld;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  int kt0, kt1;
  key_tiles(p, q0, limit, kt0, kt1);
  const int kcol = qkv_col(p, 1, h, DH), vcol = qkv_col(p, 2, h, DH);

  load_tile<T, DH>(Qs, base, q0, p.n_time, ld, qkv_col(p, 0, h, DH));
  load_tile<T, DH>(Gs, gout + (size_t)b * p.n_time * d, q0, p.n_time, d, h * DH);
  float m[4], l[4];
  row_stats<T, DH>(p, Qs, Ks, base, ld, kcol, q0, kt0, kt1, limit, m, l);

  float dsum[4] = {};   // rowsum(dP * p), per thread, then over the row
  float dq[4][DH / 16] = {};
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * kTile;
      load_tile<T, DH>(Ks, base, k0, p.n_time, ld, kcol);
      load_tile<T, DH>(Vs, base, k0, p.n_time, ld, vcol);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      mm_abt<DH>(Qs, Ks, s, ty, tx);
      mm_abt<DH>(Gs, Vs, dp, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = k0 + tx + 16 * c;
          const float pr = prob(p, s[r][c], i, j, limit, m[r], l[r]);
          float dpr = dp[r][c];
          if (p.rate > 0.f) dpr = keep(p, seed, pid, i, j) ? dpr * p.inv_keep : 0.f;
          if (pass == 0) {
            dsum[r] += dpr * pr;
          } else {
            Ss[(ty * 4 + r) * kLDP + tx + 16 * c] =
                nsd::round_to<T>(pr * (dpr - dsum[r]));
          }
        }
      }
      if (pass == 1) {
        __syncthreads();
        mm_ab<DH>(Ss, Ks, dq, ty, tx);
      }
      __syncthreads();
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dsum[r] = row_sum(dsum[r]);
    }
  }
  const size_t bh = (size_t)b * p.heads + h;
  const size_t plane = (size_t)p.batch * p.heads * p.n_time;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.n_time) continue;
    if (tx == 0) {
      stats[bh * p.n_time + i] = m[r];
      stats[plane + bh * p.n_time + i] = l[r];
      stats[2 * plane + bh * p.n_time + i] = dsum[r];
    }
    T* row = dqkv + ((size_t)b * p.n_time + i) * ld + qkv_col(p, 0, h, DH);
#pragma unroll
    for (int g = 0; g < DH / 64; ++g)
      store4<T>(row + g * 64 + tx * 4, dq[r][g * 4] * p.scale,
                dq[r][g * 4 + 1] * p.scale, dq[r][g * 4 + 2] * p.scale,
                dq[r][g * 4 + 3] * p.scale);
  }
}

// dK and dV per key tile, walking the query tiles that see its keys.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkv_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ seed_ptr,
                        const T* __restrict__ gout, T* __restrict__ dqkv,
                        const float* __restrict__ stats, Params p) {
  constexpr int LD = DH + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* Gs = Qs + kTile * LD;
  float* Ps = Gs + kTile * LD;
  float* Ss = Ps + kTile * kLDP;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * p.n_time * ld;
  const T* gbase = gout + (size_t)b * p.n_time * d;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  const size_t bh = (size_t)b * p.heads + h;
  const size_t plane = (size_t)p.batch * p.heads * p.n_time;
  // query tiles whose rows see an unmasked key of this tile
  int qt0 = 0, qt1 = (p.n_time + kTile - 1) / kTile;
  if (k0 >= limit) qt1 = 0;
  if (p.left >= 0) {
    qt0 = k0 / kTile;
    qt1 = min(qt1, (k0 + kTile - 1 + p.left) / kTile + 1);
  }
  const int qcol = qkv_col(p, 0, h, DH);

  load_tile<T, DH>(Ks, base, k0, p.n_time, ld, qkv_col(p, 1, h, DH));
  load_tile<T, DH>(Vs, base, k0, p.n_time, ld, qkv_col(p, 2, h, DH));
  float dk[4][DH / 16] = {}, dv[4][DH / 16] = {};
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * kTile;
    load_tile<T, DH>(Qs, base, q0, p.n_time, ld, qcol);
    load_tile<T, DH>(Gs, gbase, q0, p.n_time, d, h * DH);
    float m[4], l[4], dsum[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      const bool row = i < p.n_time;
      m[r] = row ? stats[bh * p.n_time + i] : -INFINITY;
      l[r] = row ? stats[plane + bh * p.n_time + i] : 1.f;
      dsum[r] = row ? stats[2 * plane + bh * p.n_time + i] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_abt<DH>(Qs, Ks, s, ty, tx);
    mm_abt<DH>(Gs, Vs, dp, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const float pr = prob(p, s[r][c], i, j, limit, m[r], l[r]);
        float dropped = pr, dpr = dp[r][c];
        if (p.rate > 0.f) {
          const bool kept = keep(p, seed, pid, i, j);
          dropped = kept ? pr * p.inv_keep : 0.f;
          dpr = kept ? dpr * p.inv_keep : 0.f;
        }
        Ps[(ty * 4 + r) * kLDP + tx + 16 * c] = nsd::round_to<T>(dropped);
        Ss[(ty * 4 + r) * kLDP + tx + 16 * c] =
            nsd::round_to<T>(pr * (dpr - dsum[r]));
      }
    }
    __syncthreads();
    mm_atb<DH>(Ps, Gs, dv, ty, tx);
    mm_atb<DH>(Ss, Qs, dk, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty * 4 + r;
    if (j >= p.n_time) continue;
    T* row = dqkv + ((size_t)b * p.n_time + j) * ld;
    T* krow = row + qkv_col(p, 1, h, DH);
    T* vrow = row + qkv_col(p, 2, h, DH);
#pragma unroll
    for (int g = 0; g < DH / 64; ++g) {
      store4<T>(krow + g * 64 + tx * 4, dk[r][g * 4] * p.scale,
                dk[r][g * 4 + 1] * p.scale, dk[r][g * 4 + 2] * p.scale,
                dk[r][g * 4 + 3] * p.scale);
      store4<T>(vrow + g * 64 + tx * 4, dv[r][g * 4], dv[r][g * 4 + 1],
                dv[r][g * 4 + 2], dv[r][g * 4 + 3]);
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Params make_params(int batch, int n_time, int heads, int left, float scale,
                   float rate, float inv_keep, int interleaved) {
  Params p;
  p.batch = batch;
  p.n_time = n_time;
  p.heads = heads;
  p.left = left;
  p.scale = scale;
  p.rate = rate;
  p.inv_keep = inv_keep;
  p.interleaved = interleaved;
  return p;
}

template <typename T, int DH>
cudaError_t launch_fwd_fma(const void* qkv, const void* lens, const void* seed,
                           void* out, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (2 * kTile * (DH + 4) + kTile * kLDP);
  auto kernel = attn_fwd_kernel<T, DH>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_time + kTile - 1) / kTile, p.heads, p.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(seed), static_cast<T*>(out), p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bfloat16 forward and backward on tensor cores. The same kernels, tiles
// and skipped tiles as above (the dQ kernel walks the keys twice, not three
// times: the row sum of dP * p is formed online beside the softmax's max and
// sum), with every product an mma.sync.m16n8k16 of
// bf16 operands into float32 (the TPU kernel's products are bf16 x bf16 into
// float32 too, so only the order of addition differs). Tiles stay bf16 in
// shared memory ([64][dh+8]: the 16-byte pad puts the 8 rows an ldmatrix
// reads on distinct banks), filled by cp.async, double-buffered along the
// walk. 128 threads, four warps of 16 rows each (query rows in the dQ
// kernel, keys in the dK/dV kernel); a warp keeps its score and dP tiles in
// registers as mma accumulators, forms p and dS there, and feeds them, cast
// to bf16, straight back as the A operand of out = P V, dQ = dS K,
// dV = P^T g and dK = dS^T q (the accumulator of two n8 tiles is the A
// fragment of one k16 step). The B operands come from shared memory by
// ldmatrix, transposed (.trans) where the tile is [k][n]. The backward takes
// 104 KB of shared memory at dh=128 (two blocks an SM), 55 KB at 64; the
// forward 85 KB and 45 KB.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;

template <int DH>
constexpr int kTileElems = kTile * (DH + 8);  // a [64][DH+8] bf16 tile

using nsd::cp_async16;
using nsd::cp_async_commit;
using nsd::cp_async_wait;
using nsd::smem_u32;

// Rows [row0, row0+64) of a row-major bf16 matrix (row stride ld), columns
// [col, col+DH), into dst [64][DH+8]; rows >= n_rows are 0.
template <int DH>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0,
                                                int n_rows, size_t ld, int col) {
  constexpr int C8 = DH / 8;
  for (int idx = threadIdx.x; idx < kTile * C8; idx += kTcThreads) {
    const int r = idx / C8, c = (idx % C8) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * (DH + 8) + c, src + (size_t)(ok ? row0 + r : 0) * ld + col + c, ok);
  }
}

using nsd::ldsm_x4;
using nsd::ldsm_x4_t;
using nsd::mma;
using nsd::pack;

// acc[j] (keys 8j..8j+7 of the tile) += a (one k16 step, columns k..k+15 of
// 16 rows) . B[0..64)[k..k+16)^T; B is a [64][DH+8] shared tile.
template <int DH>
__device__ __forceinline__ void mma_bt_k16(float acc[8][4], const uint32_t a[4], const bf16* B,
                                           int k, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    uint32_t b[4];  // n tiles j and j+1, k halves 0 and 1
    ldsm_x4(B + (8 * j + lane % 8 + 8 * (lane / 16)) * LD + k + 8 * ((lane / 8) % 2), b);
    mma(acc[j], a, b[0], b[1]);
    mma(acc[j + 1], a, b[2], b[3]);
  }
}

// acc[j] (keys 8j..8j+7 of the tile) += A[r0..r0+16) . B[0..64)^T, summed
// over DH; A and B are [.][DH+8] shared tiles. Accumulator layout of each
// n8 tile (lane = 4g + t): [0] (row g, col 2t), [1] (g, 2t+1), [2] (g+8,
// 2t), [3] (g+8, 2t+1).
template <int DH>
__device__ __forceinline__ void mma_abt(float acc[8][4], const bf16* A, int r0, const bf16* B,
                                        int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int k = 0; k < DH; k += 16) {
    uint32_t a[4];
    ldsm_x4(A + (r0 + lane % 16) * LD + k + 8 * (lane / 16), a);
    mma_bt_k16<DH>(acc, a, B, k, lane);
  }
}

// mma_abt with A's rows held in registers: qa[k / 16] is the A fragment of
// columns k..k+15 (a_frags).
template <int DH>
__device__ __forceinline__ void mma_abt_regs(float acc[8][4], const uint32_t qa[DH / 16][4],
                                             const bf16* B, int lane) {
#pragma unroll
  for (int k = 0; k < DH; k += 16) mma_bt_k16<DH>(acc, qa[k / 16], B, k, lane);
}

// The A fragments of rows r0..r0+15 of a [64][DH+8] shared tile.
template <int DH>
__device__ __forceinline__ void a_frags(uint32_t qa[DH / 16][4], const bf16* A, int r0,
                                        int lane) {
#pragma unroll
  for (int k = 0; k < DH; k += 16)
    ldsm_x4(A + (r0 + lane % 16) * (DH + 8) + k + 8 * (lane / 16), qa[k / 16]);
}

// acc[j] (columns 8j..8j+7 of DH) += P (16 x 64, as four k16 A fragments
// pa) . X[0..64)[0..DH); X is a [64][DH+8] shared tile read transposed.
template <int DH>
__device__ __forceinline__ void mma_px(float acc[DH / 8][4], const uint32_t pa[4][4],
                                       const bf16* X, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < DH / 8; j += 2) {
      uint32_t b[4];  // k halves 0 and 1 of n tile j, then of n tile j+1
      ldsm_x4_t(X + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 8 * j + 8 * (lane / 16),
                b);
      mma(acc[j], pa[kk], b[0], b[1]);
      mma(acc[j + 1], pa[kk], b[2], b[3]);
    }
  }
}

// The A fragments of a 16 x 64 accumulator tile, rounded to bf16.
__device__ __forceinline__ void to_a(const float c[8][4], uint32_t pa[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    pa[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    pa[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pa[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Sum or max over the 4 lanes (t) that share a row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A warp's 16 x DH accumulator times scale, as bf16 into rows row0.. of dst
// (row stride ld), those below n_time; entry (j, 2e + c) is row row0 + g +
// 8e, column 8j + 2t + c.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld, int row0, int n_time,
                                           const float acc[DH / 8][4], float scale, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = row0 + lane / 4 + 8 * e;
    if (i >= n_time) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)i * ld + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[j][2 * e] * scale, acc[j][2 * e + 1] * scale);
  }
}

// The forward per query tile, in two walks over the key tiles (the TPU
// kernel's p carries the final max and sum when it is rounded to bf16, so an
// online rescaling of out would give other bits): each row's softmax max and
// sum, online, then p, its dropout and out += round(p) V. The Q tile is read
// once and its A fragments stay in registers for both walks; the key tiles
// (and, in the second walk, the value tiles) are double-buffered by cp.async,
// the next tile's copies in flight while this one's products run.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    attn_fwd_tc(const bf16* __restrict__ qkv, const int32_t* __restrict__ lens,
                const int32_t* __restrict__ seed_ptr, bf16* __restrict__ out, Params p) {
  constexpr int TE = kTileElems<DH>;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + TE;      // two buffers
  bf16* Vs = Ks + 2 * TE;  // two buffers
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)b * p.n_time * ld;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  int kt0, kt1;
  key_tiles(p, q0, limit, kt0, kt1);
  const int nt = max(kt1 - kt0, 0), steps = 2 * nt;
  const int kcol = qkv_col(p, 1, h, DH), vcol = qkv_col(p, 2, h, DH);
  const int r0 = warp * 16, row[2] = {q0 + r0 + lane / 4, q0 + r0 + lane / 4 + 8};

  load_tile_async<DH>(Qs, base, q0, p.n_time, ld, qkv_col(p, 0, h, DH));
  // step s: walk s / nt over key tile kt0 + s % nt; the second walk reads V too
  auto issue = [&](int s) {
    const int k0 = (kt0 + s % nt) * kTile, buf = s & 1;
    load_tile_async<DH>(Ks + buf * TE, base, k0, p.n_time, ld, kcol);
    if (s >= nt) load_tile_async<DH>(Vs + buf * TE, base, k0, p.n_time, ld, vcol);
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  uint32_t qa[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DH / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) a_frags<DH>(qa, Qs, r0, lane);
    const int k0 = (kt0 + s % nt) * kTile, buf = s & 1;
    float sc[8][4] = {};
    mma_abt_regs<DH>(sc, qa, Ks + buf * TE, lane);
    if (s < nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            float& v = sc[j][2 * e + c];
            v = key >= p.n_time ? -INFINITY : masked(p, row[e], key, limit) ? kNeg : v * p.scale;
            mx = fmaxf(mx, v);
          }
        }
        const float m_new = fmaxf(m[e], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) sum += expf(sc[j][2 * e + c] - m_new);
        }
        l[e] = l[e] * expf(m[e] - m_new) + quad_sum(sum);
        m[e] = m_new;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r / 2, key = k0 + 8 * j + 2 * (lane % 4) + r % 2;
          float pr = prob(p, sc[j][r], row[e], key, limit, m[e], l[e]);
          if (p.rate > 0.f) pr = keep(p, seed, pid, row[e], key) ? pr * p.inv_keep : 0.f;
          sc[j][r] = pr;
        }
      }
      uint32_t pa[4][4];
      to_a(sc, pa);
      mma_px<DH>(o, pa, Vs + buf * TE, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<DH>(out + (size_t)b * p.n_time * d + h * DH, d, q0 + r0, p.n_time, o, 1.f, lane);
}

template <int DH>
cudaError_t launch_fwd(const void* qkv, const void* lens, const void* seed, void* out,
                       const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * 5 * kTileElems<DH>;
  auto kernel = attn_fwd_tc<DH>;
  NSD_TRY(set_smem(reinterpret_cast<const void*>(kernel), smem));
  const dim3 grid((p.n_time + kTile - 1) / kTile, p.heads, p.batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(seed), static_cast<bf16*>(out), p);
  return cudaGetLastError();
}

// dQ per query tile, in two walks over the key tiles: each row's softmax max
// and sum and rowsum(dP * p), online (the running sums rescaled when the
// max grows, the last divided by the sum at the end), then dS and dQ;
// stores the three statistics in stats [3][B*H][T] for the dK/dV kernel.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    attn_bwd_dq_tc(const bf16* __restrict__ qkv, const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ seed_ptr, const bf16* __restrict__ gout,
                   bf16* __restrict__ dqkv, float* __restrict__ stats, Params p) {
  constexpr int TE = kTileElems<DH>;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Gs = Qs + TE;
  bf16* Ks = Gs + TE;      // two buffers
  bf16* Vs = Ks + 2 * TE;  // two buffers
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)b * p.n_time * ld;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  int kt0, kt1;
  key_tiles(p, q0, limit, kt0, kt1);
  const int nt = max(kt1 - kt0, 0), steps = 2 * nt;
  const int kcol = qkv_col(p, 1, h, DH), vcol = qkv_col(p, 2, h, DH);
  const int r0 = warp * 16, row[2] = {q0 + r0 + lane / 4, q0 + r0 + lane / 4 + 8};

  load_tile_async<DH>(Qs, base, q0, p.n_time, ld, qkv_col(p, 0, h, DH));
  load_tile_async<DH>(Gs, gout + (size_t)b * p.n_time * d, q0, p.n_time, d, h * DH);
  // step s: walk s / nt over key tile kt0 + s % nt
  auto issue = [&](int s) {
    const int k0 = (kt0 + s % nt) * kTile, buf = s & 1;
    load_tile_async<DH>(Ks + buf * TE, base, k0, p.n_time, ld, kcol);
    load_tile_async<DH>(Vs + buf * TE, base, k0, p.n_time, ld, vcol);
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float dq[DH / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int walk = s / nt, k0 = (kt0 + s % nt) * kTile, buf = s & 1;
    const bf16* K = Ks + buf * TE;
    float sc[8][4] = {}, dp[8][4] = {};
    mma_abt<DH>(sc, Qs, r0, K, lane);
    mma_abt<DH>(dp, Gs, r0, Vs + buf * TE, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = row[r / 2], key = k0 + 8 * j + 2 * (lane % 4) + r % 2;
        if (p.rate > 0.f) dp[j][r] = keep(p, seed, pid, i, key) ? dp[j][r] * p.inv_keep : 0.f;
      }
    }
    if (walk == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            float& v = sc[j][2 * e + c];
            v = key >= p.n_time ? -INFINITY : masked(p, row[e], key, limit) ? kNeg : v * p.scale;
            mx = fmaxf(mx, v);
          }
        }
        const float m_new = fmaxf(m[e], quad_max(mx));
        float sum = 0.f, dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = expf(sc[j][2 * e + c] - m_new);
            sum += x;
            dot += dp[j][2 * e + c] * x;
          }
        }
        const float rescale = expf(m[e] - m_new);
        l[e] = l[e] * rescale + quad_sum(sum);
        dsum[e] = dsum[e] * rescale + quad_sum(dot);
        m[e] = m_new;
      }
      if (s == nt - 1) {
        // rowsum(dP * p); 0 in a row whose every key is masked (p = 0)
#pragma unroll
        for (int e = 0; e < 2; ++e) dsum[e] = m[e] <= kNeg ? 0.f : dsum[e] / l[e];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r / 2, key = k0 + 8 * j + 2 * (lane % 4) + r % 2;
          const float pr = prob(p, sc[j][r], row[e], key, limit, m[e], l[e]);
          sc[j][r] = pr * (dp[j][r] - dsum[e]);
        }
      }
      uint32_t pa[4][4];
      to_a(sc, pa);
      mma_px<DH>(dq, pa, K, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const size_t bh = (size_t)b * p.heads + h;
  const size_t plane = (size_t)p.batch * p.heads * p.n_time;
  if (lane % 4 == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (row[e] >= p.n_time) continue;
      stats[bh * p.n_time + row[e]] = m[e];
      stats[plane + bh * p.n_time + row[e]] = l[e];
      stats[2 * plane + bh * p.n_time + row[e]] = dsum[e];
    }
  }
  store_rows<DH>(dqkv + (size_t)b * p.n_time * ld + qkv_col(p, 0, h, DH), ld, q0 + r0,
                 p.n_time, dq, p.scale, lane);
}

// dK and dV per key tile, walking the query tiles that see its keys; each
// warp takes 16 keys and forms S^T and dP^T (keys by queries) directly.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    attn_bwd_dkv_tc(const bf16* __restrict__ qkv, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ seed_ptr, const bf16* __restrict__ gout,
                    bf16* __restrict__ dqkv, const float* __restrict__ stats, Params p) {
  constexpr int TE = kTileElems<DH>;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;      // two buffers
  bf16* Gs = Qs + 2 * TE;  // two buffers
  float* St = reinterpret_cast<float*>(Gs + 2 * TE);  // [2][3][64]: m, l, dsum
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)b * p.n_time * ld;
  const bf16* gbase = gout + (size_t)b * p.n_time * d;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  const size_t bh = (size_t)b * p.heads + h;
  const size_t plane = (size_t)p.batch * p.heads * p.n_time;
  // query tiles whose rows see an unmasked key of this tile
  int qt0 = 0, qt1 = (p.n_time + kTile - 1) / kTile;
  if (k0 >= limit) qt1 = 0;
  if (p.left >= 0) {
    qt0 = k0 / kTile;
    qt1 = min(qt1, (k0 + kTile - 1 + p.left) / kTile + 1);
  }
  const int steps = max(qt1 - qt0, 0);
  const int qcol = qkv_col(p, 0, h, DH);
  const int r0 = warp * 16, key[2] = {k0 + r0 + lane / 4, k0 + r0 + lane / 4 + 8};

  load_tile_async<DH>(Ks, base, k0, p.n_time, ld, qkv_col(p, 1, h, DH));
  load_tile_async<DH>(Vs, base, k0, p.n_time, ld, qkv_col(p, 2, h, DH));
  auto issue = [&](int s) {
    const int q0 = (qt0 + s) * kTile, buf = s & 1;
    load_tile_async<DH>(Qs + buf * TE, base, q0, p.n_time, ld, qcol);
    load_tile_async<DH>(Gs + buf * TE, gbase, q0, p.n_time, d, h * DH);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      const bool ok = i < p.n_time;
      float* st = St + buf * 3 * kTile + threadIdx.x;
      st[0] = ok ? stats[bh * p.n_time + i] : -INFINITY;
      st[kTile] = ok ? stats[plane + bh * p.n_time + i] : 1.f;
      st[2 * kTile] = ok ? stats[2 * plane + bh * p.n_time + i] : 0.f;
    }
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + s) * kTile, buf = s & 1;
    const bf16* Q = Qs + buf * TE;
    const bf16* G = Gs + buf * TE;
    const float* st = St + buf * 3 * kTile;
    float pr[8][4] = {};  // S^T, then p^T
    mma_abt<DH>(pr, Ks, r0, Q, lane);
    uint32_t pa[4][4], kept = 0xffffffffu;  // bit 4j + r: entry (j, r) kept
    {
      float dropped[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qi = 8 * j + 2 * (lane % 4) + r % 2, i = q0 + qi, jj = key[r / 2];
          pr[j][r] = prob(p, pr[j][r], i, jj, limit, st[qi], st[kTile + qi]);
          dropped[j][r] = pr[j][r];
          if (p.rate > 0.f) {
            const bool k = keep(p, seed, pid, i, jj);
            if (!k) kept &= ~(1u << (4 * j + r));
            dropped[j][r] = k ? pr[j][r] * p.inv_keep : 0.f;
          }
        }
      }
      to_a(dropped, pa);
    }
    mma_px<DH>(dv, pa, G, lane);
    {
      float ds[8][4] = {};  // dP^T, then dS^T
      mma_abt<DH>(ds, Vs, r0, G, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qi = 8 * j + 2 * (lane % 4) + r % 2;
          float dpr = ds[j][r];
          if (p.rate > 0.f) dpr = (kept >> (4 * j + r)) & 1u ? dpr * p.inv_keep : 0.f;
          ds[j][r] = pr[j][r] * (dpr - st[2 * kTile + qi]);
        }
      }
      to_a(ds, pa);
    }
    mma_px<DH>(dk, pa, Q, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  bf16* rows = dqkv + (size_t)b * p.n_time * ld;
  store_rows<DH>(rows + qkv_col(p, 1, h, DH), ld, k0 + r0, p.n_time, dk, p.scale, lane);
  store_rows<DH>(rows + qkv_col(p, 2, h, DH), ld, k0 + r0, p.n_time, dv, 1.f, lane);
}

template <int DH>
cudaError_t launch_bwd(const void* qkv, const void* lens, const void* seed, const void* g,
                       void* dqkv, void* stats, const Params& p, cudaStream_t stream) {
  constexpr size_t smem_dq = sizeof(bf16) * 6 * kTileElems<DH>;
  constexpr size_t smem_dkv = smem_dq + sizeof(float) * 2 * 3 * kTile;
  auto dq_kernel = attn_bwd_dq_tc<DH>;
  auto dkv_kernel = attn_bwd_dkv_tc<DH>;
  NSD_TRY(set_smem(reinterpret_cast<const void*>(dq_kernel), smem_dq));
  NSD_TRY(set_smem(reinterpret_cast<const void*>(dkv_kernel), smem_dkv));
  const dim3 grid((p.n_time + kTile - 1) / kTile, p.heads, p.batch);
  dq_kernel<<<grid, kTcThreads, smem_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(seed), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<float*>(stats), p);
  NSD_TRY(cudaGetLastError());
  dkv_kernel<<<grid, kTcThreads, smem_dkv, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(seed), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<const float*>(stats), p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The float32 forward and backward redesigned for the H100 (body "f32"; the
// FMA kernels above stay as body "fma"). Same semantics, still on float32
// FMAs (no TF32), with fewer products and tiles that feed the FMAs better:
//
// - Forward, one walk over the key tiles (online softmax): a block takes
//   64 query rows of one (b, h); for each 64-key tile it forms the scores,
//   grows each row's running max m (the row's partial sums and its output
//   accumulator are rescaled by exp(m_old - m_new)), adds exp(s - m) to the
//   running sum l and the dropped exp(s - m) times V to the output; the
//   output is divided by l at the end, and is 0 where m <= -1e9 (every key
//   masked). Keys at j >= T score -inf, masked keys inside T -1e9, as
//   row_stats above: a tile that holds only masked keys of a row leaves it
//   exp(0) terms that the first unmasked key's rescale (exp(-1e9 - m) = 0)
//   wipes out. Two products, not three. Optionally it stores each row's
//   final (m, l), the residuals of the backward.
// - Backward, 5 products, not 10: a pass forms Delta_i = g_i . out_i, which
//   equals rowsum(dP * p) with the dropout scaling (out = sum_j dropped
//   p_ij v_j); the dK/dV kernel (per 64 keys) walks the query tiles once:
//   S^T, dP^T, p from the forward's (m, l), dV += P^T g, dS = p (dP -
//   Delta), dK += dS^T q, and stores dS; the dQ kernel (per 64 query rows)
//   is then one product, dQ = dS K, over the key tiles the rows see. dS
//   lives in device memory between the two ([B*H][Tp][Tp] float32, Tp = T
//   rounded up to 64: 210 MB at B=64, T'=313, H=8), so S and dP are formed
//   once (the FlashAttention-2 split forms them again for dQ: 7 products).
// - Tiles: 256 threads, each forming a 4 x 4 block of scores and a 4-row
//   block of the output product (the dQ kernel: 128 threads, 8 rows), with
//   128-bit shared loads that a quarter warp reads as one broadcast (the A
//   rows) or 128 contiguous bytes (the B rows, on distinct banks: the row
//   stride DH+4 is 4 mod 32). The forward and the dQ kernel take 99 KB of
//   shared memory at dh=128 (Q, K and V one stage each, p staged over K;
//   dS and K two stages), so two blocks share an SM and one block's loads
//   and stores overlap the other's products; a 64-row forward block also
//   pads T'=313 to 320 rows, not 384 (on an H100 at B=64, T'=313, H=8,
//   dh=128 both beat a 128-row block with 8 x 4 scores a thread and K/V in
//   two stages, one block an SM, and 256 threads beat 128 with 8 x 4
//   scores). The dK/dV kernel
//   (217 KB: K and V resident, q and g in two cp.async stages, the next
//   tile's copies in flight while this one's products run) holds one block
//   an SM.
// No atomics: every sum runs in one fixed order, so reruns are bit-equal.
namespace f32 {

constexpr int kThreads = 256;    // the forward's and the dK/dV kernel's
constexpr int kDqThreads = 128;  // the dQ kernel's
constexpr int kLdS = kTile + 4;  // row stride of a staged [64][64] p / dS tile

// Rows [row0, row0+ROWS) of a row-major float32 matrix (row stride ld),
// columns [col, col+DH), into dst [ROWS][DH+4] by cp.async (NT threads);
// rows >= n_rows are zero-filled.
template <int ROWS, int DH, int NT>
__device__ __forceinline__ void load_async(float* dst, const float* src, int row0, int n_rows,
                                           size_t ld, int col) {
  constexpr int C4 = DH / 4;
  for (int idx = threadIdx.x; idx < ROWS * C4; idx += NT) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const bool ok = row0 + r < n_rows;
    nsd::cp_async16(dst + r * (DH + 4) + c, src + (size_t)(ok ? row0 + r : 0) * ld + col + c,
                    ok);
  }
}

// Row of a thread's i-th product row in a 64-row tile: with NT threads (NT
// / 16 values of ty) and RG = 64 / (NT / 4) groups of rows, rows
// rg * NT/4 + ty*4 + r, i = rg*4 + r.
template <int NT>
__device__ __forceinline__ int tile_row(int i, int ty) {
  return (i / 4) * (NT / 4) + ty * 4 + i % 4;
}

// acc[i][c] += sum_k A[tile_row(i)][k] * B[tx + 16c][k], k < DH (A.B^T of
// two [64][DH+4] tiles).
template <int DH, int NT>
__device__ __forceinline__ void mm_abt(const float* __restrict__ A, const float* __restrict__ B,
                                       float (&acc)[1024 / NT][4], int ty, int tx) {
  constexpr int LD = DH + 4, R = 1024 / NT;
#pragma unroll 2
  for (int k = 0; k < DH; k += 4) {
    float4 a[R], b[4];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + tile_row<NT>(i, ty) * LD + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * LD + k);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[i][c];
        s = fmaf(a[i].x, b[c].x, s);
        s = fmaf(a[i].y, b[c].y, s);
        s = fmaf(a[i].z, b[c].z, s);
        s = fmaf(a[i].w, b[c].w, s);
        acc[i][c] = s;
      }
    }
  }
}

// acc[i][g*4+e] += sum_j P[tile_row(i)][j] * X[j][g*64 + tx*4 + e], j < 64
// (a [64][kLdS] tile times a [64][DH+4] tile).
template <int DH, int NT>
__device__ __forceinline__ void mm_ab(const float* __restrict__ P, const float* __restrict__ X,
                                      float (&acc)[1024 / NT][DH / 16], int ty, int tx) {
  constexpr int LD = DH + 4, R = 1024 / NT;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(P + tile_row<NT>(i, ty) * kLdS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int g = 0; g < DH / 64; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(X + (j + jj) * LD + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float av = comp(a[i], jj);
          acc[i][g * 4 + 0] = fmaf(av, b.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(av, b.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(av, b.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(av, b.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
}

// Stores a thread's block of a 64-row product (rows q0 + tile_row, those
// below T) times scale into the rows of dst (row stride ld), from column
// col.
template <int DH, int NT>
__device__ __forceinline__ void store_rows(float* dst, size_t ld, int col, int q0, int n_time,
                                           const float (&acc)[1024 / NT][DH / 16], float scale,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 1024 / NT; ++i) {
    const int row = q0 + tile_row<NT>(i, ty);
    if (row >= n_time) continue;
    float* d = dst + (size_t)row * ld + col;
#pragma unroll
    for (int g = 0; g < DH / 64; ++g)
      *reinterpret_cast<float4*>(d + g * 64 + tx * 4) =
          make_float4(acc[i][g * 4] * scale, acc[i][g * 4 + 1] * scale,
                      acc[i][g * 4 + 2] * scale, acc[i][g * 4 + 3] * scale);
  }
}

// The forward per 64 query rows; stats (may be null) [2][B*H][T] gets each
// row's final max m and sum l. Q, K and V one stage each ([64][DH+4]); p
// is staged over K once the scores are formed.
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
    attn_fwd_f32(const float* __restrict__ qkv, const int32_t* __restrict__ lens,
                 const int32_t* __restrict__ seed_ptr, float* __restrict__ out,
                 float* __restrict__ stats, Params p) {
  constexpr int NT = kThreads, LD = DH + 4, KT = kTile * LD, R = 1024 / NT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + KT;
  float* Vs = Ks + KT;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const float* base = qkv + (size_t)b * p.n_time * ld;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  int kt0, kt1;
  key_tiles(p, q0, limit, kt0, kt1);
  const int nt = max(kt1 - kt0, 0);
  const int kcol = qkv_col(p, 1, h, DH), vcol = qkv_col(p, 2, h, DH);

  load_async<kTile, DH, NT>(Qs, base, q0, p.n_time, ld, qkv_col(p, 0, h, DH));
  auto fetch = [&](int t) {
    const int k0 = (kt0 + t) * kTile;
    load_async<kTile, DH, NT>(Ks, base, k0, p.n_time, ld, kcol);
    load_async<kTile, DH, NT>(Vs, base, k0, p.n_time, ld, vcol);
  };
  if (nt > 0) fetch(0);
  nsd::cp_async_commit();

  float m[R], l[R], o[R][DH / 16];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this thread's part of the row's sum
#pragma unroll
    for (int e = 0; e < DH / 16; ++e) o[i][e] = 0.f;
  }
  for (int t = 0; t < nt; ++t) {
    nsd::cp_async_wait<0>();
    __syncthreads();
    const int k0 = (kt0 + t) * kTile;
    float s[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    mm_abt<DH, NT>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + tile_row<NT>(i, ty);
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        s[i][c] = j >= p.n_time ? -INFINITY : masked(p, row, j, limit) ? kNeg : s[i][c] * p.scale;
        mx = fmaxf(mx, s[i][c]);
      }
      // every walked tile holds a key below T, so m_new >= -1e9
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float e = expf(s[i][c] - m_new);
        sum += e;
        if (p.rate > 0.f) e = keep(p, seed, pid, row, k0 + tx + 16 * c) ? e * p.inv_keep : 0.f;
        s[i][c] = e;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < DH / 16; ++e) o[i][e] *= alpha;
    }
    __syncthreads();  // every thread's reads of K are done: p takes its place
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ks[tile_row<NT>(i, ty) * kLdS + tx + 16 * c] = s[i][c];
    __syncthreads();
    mm_ab<DH, NT>(Ks, Vs, o, ty, tx);
    if (t + 1 < nt) {
      __syncthreads();  // every thread's reads of p and V are done
      fetch(t + 1);
      nsd::cp_async_commit();
    }
  }
  nsd::cp_async_wait<0>();
  const size_t bh = (size_t)b * p.heads + h;
  const size_t plane = (size_t)p.batch * p.heads * p.n_time;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float sum = row_sum(l[i]);
    const bool dead = m[i] <= kNeg;  // every key masked (or none walked): 0
#pragma unroll
    for (int e = 0; e < DH / 16; ++e) o[i][e] = dead ? 0.f : o[i][e] / sum;
    const int row = q0 + tile_row<NT>(i, ty);
    if (stats != nullptr && tx == 0 && row < p.n_time) {
      stats[bh * p.n_time + row] = m[i];
      stats[plane + bh * p.n_time + row] = sum;
    }
  }
  store_rows<DH, NT>(out + (size_t)b * p.n_time * d, d, h * DH, q0, p.n_time, o, 1.f, ty, tx);
}

// Delta_i = g_i . out_i of every row (b, i, h) into dsum [B*H][T]: DH/4
// lanes a row, a float4 each, summed across the lanes in a fixed order.
template <int DH>
__global__ void __launch_bounds__(256)
    attn_bwd_delta_f32(const float* __restrict__ gout, const float* __restrict__ out,
                       float* __restrict__ dsum, Params p) {
  constexpr int LANES = DH / 4, ROWS = 256 / LANES;
  const int lane = threadIdx.x % LANES;
  const size_t r = (size_t)blockIdx.x * ROWS + threadIdx.x / LANES;  // of [B*T*H]
  const size_t n = (size_t)p.batch * p.n_time * p.heads;
  float dot = 0.f;
  if (r < n) {
    const float4 gv = *reinterpret_cast<const float4*>(gout + r * DH + lane * 4);
    const float4 ov = *reinterpret_cast<const float4*>(out + r * DH + lane * 4);
    dot = fmaf(gv.x, ov.x, dot);
    dot = fmaf(gv.y, ov.y, dot);
    dot = fmaf(gv.z, ov.z, dot);
    dot = fmaf(gv.w, ov.w, dot);
  }
#pragma unroll
  for (int o = LANES / 2; o >= 1; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (r < n && lane == 0) {
    const size_t bi = r / p.heads, h = r % p.heads;
    const size_t b = bi / p.n_time, i = bi % p.n_time;
    dsum[(b * p.heads + h) * p.n_time + i] = dot;
  }
}

// dK and dV per 64 keys, walking the query tiles that see them; each thread
// forms S^T and dP^T (its 4 keys by 4 queries) directly. Stores dS [B*H]
// [Tp][Tp] (row: query, column: key) for every (query tile, key tile) it
// walks, every entry of the 64 x 64 block (0 past T).
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkv_f32(const float* __restrict__ qkv, const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ seed_ptr, const float* __restrict__ gout,
                     const float* __restrict__ stats, const float* __restrict__ dsum,
                     float* __restrict__ ds, float* __restrict__ dqkv, Params p) {
  constexpr int NT = kThreads, LD = DH + 4, KT = kTile * LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + KT;
  float* Qs = Vs + KT;      // two stages
  float* Gs = Qs + 2 * KT;  // two stages
  float* Xs = Gs + 2 * KT;  // P^T, then dS^T [64][kLdS]
  float* St = Xs + kTile * kLdS;  // [2][3][64]: m, l, Delta
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const float* base = qkv + (size_t)b * p.n_time * ld;
  const float* gbase = gout + (size_t)b * p.n_time * d;
  const int limit = min(lens[b], p.n_time);
  const int seed = *seed_ptr, pid = b * p.heads + h;
  const size_t bh = (size_t)b * p.heads + h;
  const size_t plane = (size_t)p.batch * p.heads * p.n_time;
  const int tp = nsd::round_up(p.n_time, kTile);
  // query tiles whose rows see an unmasked key of this tile
  int qt0 = 0, qt1 = tp / kTile;
  if (k0 >= limit) qt1 = 0;
  if (p.left >= 0) {
    qt0 = k0 / kTile;
    qt1 = min(qt1, (k0 + kTile - 1 + p.left) / kTile + 1);
  }
  const int steps = max(qt1 - qt0, 0);
  const int qcol = qkv_col(p, 0, h, DH);

  load_async<kTile, DH, NT>(Ks, base, k0, p.n_time, ld, qkv_col(p, 1, h, DH));
  load_async<kTile, DH, NT>(Vs, base, k0, p.n_time, ld, qkv_col(p, 2, h, DH));
  auto fetch = [&](int s) {
    const int q0 = (qt0 + s) * kTile, buf = s & 1;
    load_async<kTile, DH, NT>(Qs + buf * KT, base, q0, p.n_time, ld, qcol);
    load_async<kTile, DH, NT>(Gs + buf * KT, gbase, q0, p.n_time, d, h * DH);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      const bool ok = i < p.n_time;
      float* st = St + buf * 3 * kTile + threadIdx.x;
      st[0] = ok ? stats[bh * p.n_time + i] : -INFINITY;
      st[kTile] = ok ? stats[plane + bh * p.n_time + i] : 1.f;
      st[2 * kTile] = ok ? dsum[bh * p.n_time + i] : 0.f;
    }
  };
  if (steps > 0) fetch(0);
  nsd::cp_async_commit();

  float dk[4][DH / 16], dv[4][DH / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < DH / 16; ++e) dk[r][e] = dv[r][e] = 0.f;
  for (int s = 0; s < steps; ++s) {
    // tile s has landed, and every thread is done with tile s-1, whose
    // stages the copies of tile s+1 take
    nsd::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) {
      fetch(s + 1);
      nsd::cp_async_commit();
    }
    const int q0 = (qt0 + s) * kTile, buf = s & 1;
    const float* Q = Qs + buf * KT;
    const float* G = Gs + buf * KT;
    const float* st = St + buf * 3 * kTile;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = dp[r][c] = 0.f;
    mm_abt<DH, NT>(Ks, Q, sc, ty, tx);
    mm_abt<DH, NT>(Vs, G, dp, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = k0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = tx + 16 * c, i = q0 + qi;
        const float pr = prob(p, sc[r][c], i, j, limit, st[qi], st[kTile + qi]);
        float dropped = pr, dpr = dp[r][c];
        if (p.rate > 0.f) {
          const bool kept = keep(p, seed, pid, i, j);
          dropped = kept ? pr * p.inv_keep : 0.f;
          dpr = kept ? dpr * p.inv_keep : 0.f;
        }
        Xs[(ty * 4 + r) * kLdS + qi] = dropped;
        sc[r][c] = pr * (dpr - st[2 * kTile + qi]);  // dS^T
      }
    }
    // dS, row i = q0 + tx + 16c, this thread's 4 keys k0 + ty*4..
    float* dsrow = ds + (bh * tp + q0) * tp + k0 + ty * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dsrow + (size_t)(tx + 16 * c) * tp) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    __syncthreads();
    mm_ab<DH, NT>(Xs, G, dv, ty, tx);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Xs[(ty * 4 + r) * kLdS + tx + 16 * c] = sc[r][c];
    __syncthreads();
    mm_ab<DH, NT>(Xs, Q, dk, ty, tx);
  }
  nsd::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty * 4 + r;
    if (j >= p.n_time) continue;
    float* row = dqkv + ((size_t)b * p.n_time + j) * ld;
    float* krow = row + qkv_col(p, 1, h, DH);
    float* vrow = row + qkv_col(p, 2, h, DH);
#pragma unroll
    for (int g = 0; g < DH / 64; ++g) {
      *reinterpret_cast<float4*>(krow + g * 64 + tx * 4) =
          make_float4(dk[r][g * 4] * p.scale, dk[r][g * 4 + 1] * p.scale,
                      dk[r][g * 4 + 2] * p.scale, dk[r][g * 4 + 3] * p.scale);
      *reinterpret_cast<float4*>(vrow + g * 64 + tx * 4) =
          make_float4(dv[r][g * 4], dv[r][g * 4 + 1], dv[r][g * 4 + 2], dv[r][g * 4 + 3]);
    }
  }
}

// dQ = (dS K) * scale per 64 query rows, over the key tiles the rows see
// (each of those blocks of dS was stored by the dK/dV kernel); dS and K
// tiles in two cp.async stages.
template <int DH>
__global__ void __launch_bounds__(kDqThreads, 2)
    attn_bwd_dq_f32(const float* __restrict__ qkv, const int32_t* __restrict__ lens,
                    const float* __restrict__ ds, float* __restrict__ dqkv, Params p) {
  constexpr int NT = kDqThreads, LD = DH + 4, KT = kTile * LD, ST = kTile * kLdS;
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);  // two stages
  float* Ks = Ss + 2 * ST;                      // two stages
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = p.heads * DH;
  const size_t ld = 3 * (size_t)d;
  const float* base = qkv + (size_t)b * p.n_time * ld;
  const int limit = min(lens[b], p.n_time);
  const int tp = nsd::round_up(p.n_time, kTile);
  const float* dsb = ds + ((size_t)b * p.heads + h) * tp * tp + (size_t)q0 * tp;
  int kt0, kt1;
  key_tiles(p, q0, limit, kt0, kt1);
  const int nt = max(kt1 - kt0, 0);
  const int kcol = qkv_col(p, 1, h, DH);
  auto fetch = [&](int t) {
    const int k0 = (kt0 + t) * kTile, buf = t & 1;
    load_async<kTile, kTile, NT>(Ss + buf * ST, dsb, 0, kTile, tp, k0);
    load_async<kTile, DH, NT>(Ks + buf * KT, base, k0, p.n_time, ld, kcol);
  };
  if (nt > 0) fetch(0);
  nsd::cp_async_commit();

  float dq[8][DH / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < DH / 16; ++e) dq[i][e] = 0.f;
  for (int t = 0; t < nt; ++t) {
    nsd::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < nt) {
      fetch(t + 1);
      nsd::cp_async_commit();
    }
    const int buf = t & 1;
    mm_ab<DH, NT>(Ss + buf * ST, Ks + buf * KT, dq, ty, tx);
  }
  nsd::cp_async_wait<0>();
  store_rows<DH, NT>(dqkv + (size_t)b * p.n_time * ld, ld, qkv_col(p, 0, h, DH), q0, p.n_time, dq,
                  p.scale, ty, tx);
}

template <int DH>
cudaError_t launch_fwd(const void* qkv, const void* lens, const void* seed, void* out,
                       void* stats, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * 3 * kTile * (DH + 4);
  auto kernel = attn_fwd_f32<DH>;
  NSD_TRY(set_smem(reinterpret_cast<const void*>(kernel), smem));
  const dim3 grid((p.n_time + kTile - 1) / kTile, p.heads, p.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(seed), static_cast<float*>(out), static_cast<float*>(stats), p);
  return cudaGetLastError();
}

// The backward's three launches: Delta, dK/dV (and dS), dQ. dsum [B*H][T]
// and ds [B*H][Tp][Tp] are scratch.
template <int DH>
cudaError_t launch_bwd(const void* qkv, const void* lens, const void* seed, const void* g,
                       const void* out, const void* stats, void* dsum, void* ds, void* dqkv,
                       const Params& p, cudaStream_t stream) {
  constexpr size_t smem_dkv = sizeof(float) * (6 * kTile * (DH + 4) + kTile * kLdS + 2 * 3 * kTile);
  constexpr size_t smem_dq = sizeof(float) * 2 * (kTile * kLdS + kTile * (DH + 4));
  auto dkv_kernel = attn_bwd_dkv_f32<DH>;
  auto dq_kernel = attn_bwd_dq_f32<DH>;
  NSD_TRY(set_smem(reinterpret_cast<const void*>(dkv_kernel), smem_dkv));
  NSD_TRY(set_smem(reinterpret_cast<const void*>(dq_kernel), smem_dq));
  const size_t rows = (size_t)p.batch * p.n_time * p.heads;
  constexpr int kDeltaRows = 256 / (DH / 4);
  attn_bwd_delta_f32<DH><<<static_cast<unsigned>((rows + kDeltaRows - 1) / kDeltaRows), 256, 0,
                           stream>>>(static_cast<const float*>(g),
                                     static_cast<const float*>(out), static_cast<float*>(dsum),
                                     p);
  NSD_TRY(cudaGetLastError());
  const dim3 grid((p.n_time + kTile - 1) / kTile, p.heads, p.batch);
  dkv_kernel<<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(seed), static_cast<const float*>(g),
      static_cast<const float*>(stats), static_cast<const float*>(dsum),
      static_cast<float*>(ds), static_cast<float*>(dqkv), p);
  NSD_TRY(cudaGetLastError());
  dq_kernel<<<grid, kDqThreads, smem_dq, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int32_t*>(lens),
      static_cast<const float*>(ds), static_cast<float*>(dqkv), p);
  return cudaGetLastError();
}

}  // namespace f32

template <typename T, int DH>
cudaError_t launch_fwd(const void* qkv, const void* lens, const void* seed, void* out,
                       const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return tc::launch_fwd<DH>(qkv, lens, seed, out, p, stream);
  } else {
    return launch_fwd_fma<T, DH>(qkv, lens, seed, out, p, stream);
  }
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* qkv, const void* lens, const void* seed,
                       const void* g, void* dqkv, void* stats, const Params& p,
                       cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return tc::launch_bwd<DH>(qkv, lens, seed, g, dqkv, stats, p, stream);
  } else {
    constexpr size_t smem_dq = sizeof(float) * (4 * kTile * (DH + 4) + kTile * kLDP);
    constexpr size_t smem_dkv =
        sizeof(float) * (4 * kTile * (DH + 4) + 2 * kTile * kLDP);
    auto dq_kernel = attn_bwd_dq_kernel<T, DH>;
    auto dkv_kernel = attn_bwd_dkv_kernel<T, DH>;
    cudaError_t err = set_smem(reinterpret_cast<const void*>(dq_kernel), smem_dq);
    if (err == cudaSuccess)
      err = set_smem(reinterpret_cast<const void*>(dkv_kernel), smem_dkv);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.n_time + kTile - 1) / kTile, p.heads, p.batch);
    dq_kernel<<<grid, kThreads, smem_dq, stream>>>(
        static_cast<const T*>(qkv), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(seed), static_cast<const T*>(g),
        static_cast<T*>(dqkv), static_cast<float*>(stats), p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkv_kernel<<<grid, kThreads, smem_dkv, stream>>>(
        static_cast<const T*>(qkv), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(seed), static_cast<const T*>(g),
        static_cast<T*>(dqkv), static_cast<const float*>(stats), p);
    return cudaGetLastError();
  }
}

bool bad_shape(int batch, int n_time, int heads, int dh) {
  return batch < 1 || n_time < 1 || heads < 1 || (dh != 64 && dh != 128);
}

}  // namespace

extern "C" {

#define NSD_ATTN_ENTRIES(SUFFIX, T)                                            \
  int nsd_attn_fwd_##SUFFIX(const void* qkv, const void* lens,                 \
                            const void* seed, void* out, int batch,            \
                            int n_time, int heads, int dh, int left,           \
                            float scale, float rate, float inv_keep,           \
                            int interleaved, void* stream) {                   \
    if (bad_shape(batch, n_time, heads, dh))                                   \
      return static_cast<int>(cudaErrorInvalidValue);                          \
    const Params p = make_params(batch, n_time, heads, left, scale, rate,      \
                                 inv_keep, interleaved);                       \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);                  \
    return static_cast<int>(                                                   \
        dh == 64 ? launch_fwd<T, 64>(qkv, lens, seed, out, p, s)               \
                 : launch_fwd<T, 128>(qkv, lens, seed, out, p, s));            \
  }                                                                            \
  int nsd_attn_bwd_##SUFFIX(const void* qkv, const void* lens,                 \
                            const void* seed, const void* g, void* dqkv,       \
                            void* stats, int batch, int n_time, int heads,     \
                            int dh, int left, float scale, float rate,         \
                            float inv_keep, int interleaved, void* stream) {   \
    if (bad_shape(batch, n_time, heads, dh))                                   \
      return static_cast<int>(cudaErrorInvalidValue);                          \
    const Params p = make_params(batch, n_time, heads, left, scale, rate,      \
                                 inv_keep, interleaved);                       \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);                  \
    return static_cast<int>(                                                   \
        dh == 64 ? launch_bwd<T, 64>(qkv, lens, seed, g, dqkv, stats, p, s)    \
                 : launch_bwd<T, 128>(qkv, lens, seed, g, dqkv, stats, p, s)); \
  }

NSD_ATTN_ENTRIES(f32, float)
NSD_ATTN_ENTRIES(bf16, __nv_bfloat16)

// The float32 body "f32": the one-walk forward (stats, if not null, gets
// each row's max and sum, [2][B*H][T]) and the backward from the forward's
// out and stats (scratch: dsum [B*H][T] for the rows' g . out, ds
// [B*H][Tp][Tp] for dS, Tp = T rounded up to 64).
int nsd_attn_fwd_online_f32(const void* qkv, const void* lens, const void* seed, void* out,
                            void* stats, int batch, int n_time, int heads, int dh, int left,
                            float scale, float rate, float inv_keep, int interleaved,
                            void* stream) {
  if (bad_shape(batch, n_time, heads, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(batch, n_time, heads, left, scale, rate, inv_keep, interleaved);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dh == 64 ? f32::launch_fwd<64>(qkv, lens, seed, out, stats, p, s)
                                   : f32::launch_fwd<128>(qkv, lens, seed, out, stats, p, s));
}

int nsd_attn_bwd_split_f32(const void* qkv, const void* lens, const void* seed, const void* g,
                           const void* out, const void* stats, void* dsum, void* ds, void* dqkv,
                           int batch, int n_time, int heads, int dh, int left, float scale,
                           float rate, float inv_keep, int interleaved, void* stream) {
  if (bad_shape(batch, n_time, heads, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(batch, n_time, heads, left, scale, rate, inv_keep, interleaved);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dh == 64 ? f32::launch_bwd<64>(qkv, lens, seed, g, out, stats, dsum, ds, dqkv, p, s)
               : f32::launch_bwd<128>(qkv, lens, seed, g, out, stats, dsum, ds, dqkv, p, s));
}

int nsd_attn_dropout_masks(const void* seed, void* out, int bh, int t,
                           float rate, void* stream) {
  if (bh < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  nsd::MaskBufs<1> bufs{{nsd::mask_buf(out, (uint64_t)bh * t, t, t, 0)}};
  return static_cast<int>(nsd::hash_masks(static_cast<const int32_t*>(seed), bufs, rate,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
