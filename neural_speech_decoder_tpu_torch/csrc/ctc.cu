// The CTC loss's forward (alpha) and backward (beta) recursions in log space
// over the extended labels (blank, y1, blank, ..., yU, blank), S = 2U+1
// states, blank id 0:
//   lpz [T, B, S] f32: log_softmax(u)[b, t, z_s], -1e30 on states past a
//                      row's 2*len+1;
//   skip [B, S] f32:   0 where the transition s-2 -> s is allowed, else -1e30;
//   lens [B] int32:    valid frames per row;
//   s_end [B, S] f32:  beta's start row, 0 at the two final states;
//   -> alpha [T, B, S] f32, beta [T, B, S] f32.
//   alpha[0, s] = lpz[0, s] for s <= 1, else -1e30;
//   alpha[t, s] = logsum3(a[s], a[s-1], a[s-2] + skip[s]) + lpz[t, s] for
//                 t < len, and alpha[t] = alpha[t-1] (frozen) for t >= len;
//   beta[t] = s_end at t = len-1, the last beta (-1e30 at first) for t >= len,
//   else beta[t, s] = logsum3(m[s], m[s+1], m[s+2] + skip[s+2]) with
//                     m = beta[t+1] + lpz[min(t+1, T-1)].
// Neighbours outside [0, S) read -1e30.
//
// Replaces the Pallas TPU kernels
// neural_speech_decoder_tpu/ops/pallas/ctc_kernel.py::_alpha_kernel (via
// ctc_loss_tpu -> _forward -> _run_alpha) and ::_beta_kernel (via _ctc_bwd
// -> _run_beta), which walk one grid step per frame with the [B, S] state in
// VMEM. Their semantics are kept exactly: the -1e30 sentinel instead of
// -inf (so an infeasible row's loss is the finite 1e30 and its gradient
// stays finite for the caller's zero_infinity mask), _logsum3's clamp of
// the maximum at -5e29 and its "maximum <= -1e30 gives -1e30" rule,
// alpha's freeze past a row's length, beta's lazy start at len-1 and its
// read of lpz[t+1] clamped at T-1. Built without fast math: the rules
// compare against the sentinel.
//
// What bounds it on an H100: the bytes. The whole work is a few log-adds per
// state and frame (at T=313, B=64, S=129 about 2.6M states, under 0.1
// GFLOP), against one read of lpz and one write of alpha or beta (10 MB
// each), so the floor is a few microseconds; the T dependent steps of each
// row set the latency.
//
// Two bodies compute it, both one block a row (the rows are independent, so
// the TPU's sequential time grid becomes a loop inside the block), the S
// states across the block's threads, one barrier a frame, one launch a
// recursion with no carry across blocks.
//
// The block body (PR 2; any S): a thread takes several states when S
// exceeds 256; the previous frame's states sit in shared memory, two
// buffers that swap each frame; each frame's lpz row (beta: three of its
// entries and a skip) is loaded from global memory after the barrier, on
// the dependent path. On an H100 it takes about 270 ns a frame for alpha
// and 400 ns for beta (T=313, S=129).
//
// The prefetch body (S <= 256, one state a thread in a register): the lpz
// entry of frame t+3 is requested while frame t is computed, so no global
// load waits on the chain; alpha writes each frame's states to one of two
// shared rows with a left pad of two sentinels (s-1 and s-2 below state 0
// read -1e30 with no test); beta writes m = beta + lpz and m + skip of each
// step to shared rows with a right pad of sentinels, so that m[s+1] and
// (m + skip)[s+2] are shared reads; skip and s_end stay in registers. What
// is left on a frame's chain is the barrier, two shared reads and one
// logsum3. Each state's float operations and their order are the block
// body's, so both bodies give the same bits.
//
// Why a barrier a frame: the warp body below (one warp a row, K states a
// lane, shuffles instead of the barrier; bit-equal to the block body) was
// measured beside the prefetch body on the H100 (tools/ctc_ablation.py) and
// lost at S = 129. A lane's K = 5 log-adds do overlap (loads and stores
// left out, a frame takes 1.7x K = 1's, not 5x), but one scheduler issues
// all of them, so that floor alone is no lower than the prefetch body's
// whole frame; and its lpz loads and stores (K scalar accesses a lane at a
// stride of K words) cost more than twice that floor again. At S = 129 the
// prefetch body's frame needs two logsum3 on one of the SM's four
// schedulers (129 threads are five warps), which sets its floor.
//
// NSD_CTC_CUT (tools/ctc_ablation.py; the library is built without it)
// leaves parts of the prefetch and warp bodies out, so that what is left can
// be timed (such a build computes wrong numbers): bit 0 the lpz loads (a
// value made from t instead), bit 1 the per-frame stores (only the last
// frame's states are stored), bit 2 the log-adds (logsum3 becomes the
// maximum of its operands). Loads and stores out is the recursion's serial
// floor. The warp body is built only with NSD_CTC_WARP (the same tool).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float logsum3(float a, float b, float c) {
  const float mx = fmaxf(fmaxf(a, b), c);
  const float mx_safe = fmaxf(mx, kNegInf / 2);
  const float out =
      mx + logf(expf(a - mx_safe) + expf(b - mx_safe) + expf(c - mx_safe));
  return mx <= kNegInf ? kNegInf : out;
}

__global__ void __launch_bounds__(kMaxThreads)
    ctc_alpha_kernel(const float* __restrict__ lpz,
                     const float* __restrict__ skip,
                     const int32_t* __restrict__ lens,
                     float* __restrict__ alpha, int n_time, int batch,
                     int n_states) {
  extern __shared__ float buf[];  // two rows of n_states
  const int b = blockIdx.x;
  const int len = lens[b];
  const float* skip_b = skip + (size_t)b * n_states;
  float* prev = buf;
  float* next = buf + n_states;
  for (int s = threadIdx.x; s < n_states; s += blockDim.x) {
    const float v = s <= 1 ? lpz[(size_t)b * n_states + s] : kNegInf;
    prev[s] = v;
    alpha[(size_t)b * n_states + s] = v;
  }
  __syncthreads();
  for (int t = 1; t < n_time; ++t) {
    const size_t row = ((size_t)t * batch + b) * n_states;
    const bool frozen = t >= len;
    for (int s = threadIdx.x; s < n_states; s += blockDim.x) {
      float v = prev[s];
      if (!frozen) {
        const float a1 = s >= 1 ? prev[s - 1] : kNegInf;
        const float a2 = (s >= 2 ? prev[s - 2] : kNegInf) + skip_b[s];
        v = logsum3(v, a1, a2) + lpz[row + s];
      }
      next[s] = v;
      alpha[row + s] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = next;
    next = tmp;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    ctc_beta_kernel(const float* __restrict__ lpz,
                    const float* __restrict__ skip,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ s_end, float* __restrict__ beta,
                    int n_time, int batch, int n_states) {
  extern __shared__ float buf[];  // two rows of n_states
  const int b = blockIdx.x;
  const int len = lens[b];
  const float* skip_b = skip + (size_t)b * n_states;
  const float* send_b = s_end + (size_t)b * n_states;
  float* prev = buf;  // beta of the later frame, t+1
  float* next = buf + n_states;
  for (int s = threadIdx.x; s < n_states; s += blockDim.x) prev[s] = kNegInf;
  __syncthreads();
  for (int t = n_time - 1; t >= 0; --t) {
    const int t_next = min(t + 1, n_time - 1);
    const float* lpz_next = lpz + ((size_t)t_next * batch + b) * n_states;
    const size_t row = ((size_t)t * batch + b) * n_states;
    for (int s = threadIdx.x; s < n_states; s += blockDim.x) {
      float v;
      if (t == len - 1) {
        v = send_b[s];
      } else if (t >= len) {
        v = prev[s];
      } else {
        const float m0 = prev[s] + lpz_next[s];
        const float m1 = s + 1 < n_states ? prev[s + 1] + lpz_next[s + 1]
                                          : kNegInf;
        const float m2 = s + 2 < n_states
                             ? prev[s + 2] + lpz_next[s + 2] + skip_b[s + 2]
                             : kNegInf;
        v = logsum3(m0, m1, m2);
      }
      next[s] = v;
      beta[row + s] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = next;
    next = tmp;
  }
}

int block_threads(int n_states) {
  const int warps = (n_states + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

cudaError_t smem_ok(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// --------------------------------------------------------- prefetch body

#ifndef NSD_CTC_CUT
#define NSD_CTC_CUT 0
#endif
constexpr bool kCutLoad = (NSD_CTC_CUT & 1) != 0;
constexpr bool kCutStore = (NSD_CTC_CUT & 2) != 0;
constexpr bool kCutMath = (NSD_CTC_CUT & 4) != 0;

// logsum3, or with NSD_CTC_CUT bit 2 the maximum of its operands.
__device__ __forceinline__ float cut_logsum3(float a, float b, float c) {
  return kCutMath ? fmaxf(fmaxf(a, b), c) : logsum3(a, b, c);
}

constexpr int kPrefetchStates = 256;  // one state a thread, S <= 256

// lpz of state s at frame f for a row: the value the recursion adds, or
// with NSD_CTC_CUT bit 0 a value made from f instead of a load.
__device__ __forceinline__ float lpz_at(const float* lp, size_t frame, int f, bool live) {
  if (kCutLoad) return -1.f - 0.125f * (f & 7);
  return live ? __ldg(lp + (size_t)f * frame) : 0.f;
}

// alpha: thread s keeps state s in a register; frame t's row is written to
// one of two shared rows (a left pad of two sentinels makes s-1 and s-2
// read -1e30 below state 0), one barrier a frame, and lpz of frame t+3 is
// requested while frame t is computed.
__global__ void __launch_bounds__(kPrefetchStates)
    ctc_alpha_prefetch(const float* __restrict__ lpz, const float* __restrict__ skip,
                       const int32_t* __restrict__ lens, float* __restrict__ alpha,
                       int n_time, int batch, int n_states) {
  extern __shared__ float rows[];  // two rows of 2 + blockDim.x
  const int s = threadIdx.x, width = 2 + blockDim.x;
  const bool live = s < n_states;
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t frame = (size_t)batch * n_states;
  const float* lp = lpz + (size_t)b * n_states + s;
  float* out = alpha + (size_t)b * n_states + s;
  const float sk = live ? skip[(size_t)b * n_states + s] : kNegInf;
  float a = live && s <= 1 ? lp[0] : kNegInf;
  if (s < 2) rows[s] = rows[width + s] = kNegInf;
  rows[2 + s] = a;
  if (live && !kCutStore) out[0] = a;
  float l1 = 1 < n_time ? lpz_at(lp, frame, 1, live) : 0.f;
  float l2 = 2 < n_time ? lpz_at(lp, frame, 2, live) : 0.f;
  float l3 = 3 < n_time ? lpz_at(lp, frame, 3, live) : 0.f;
  __syncthreads();
  for (int t = 1; t < n_time; ++t) {
    const float cur = l1;
    l1 = l2;
    l2 = l3;
    l3 = t + 3 < n_time ? lpz_at(lp, frame, t + 3, live) : 0.f;
    const float* prev = rows + ((t - 1) & 1) * width + 2;
    if (t < len) a = cut_logsum3(a, prev[s - 1], prev[s - 2] + sk) + cur;
    rows[(t & 1) * width + 2 + s] = a;
    if (live && !kCutStore) out[(size_t)t * frame] = a;
    __syncthreads();
  }
  if (live && kCutStore) out[(size_t)(n_time - 1) * frame] = a;
}

// beta, steps i = 0..T-1 over frames t = T-1-i: thread s keeps beta[s] in a
// register and writes m = beta + lpz[min(t+1, T-1)] and m + skip to shared
// rows (a right pad of sentinels beyond S), so that after one barrier a step
// it reads m[s+1] and (m + skip)[s+2] there; the lpz row of step i+3 is
// requested while step i is computed.
__global__ void __launch_bounds__(kPrefetchStates)
    ctc_beta_prefetch(const float* __restrict__ lpz, const float* __restrict__ skip,
                      const int32_t* __restrict__ lens, const float* __restrict__ s_end,
                      float* __restrict__ beta, int n_time, int batch, int n_states) {
  extern __shared__ float rows[];  // [2 steps][m, m + skip][blockDim.x + 2]
  const int s = threadIdx.x, width = blockDim.x + 2;
  const bool live = s < n_states;
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t frame = (size_t)batch * n_states;
  const float* lp = lpz + (size_t)b * n_states + s;
  float* out = beta + (size_t)b * n_states + s;
  const float sk = live ? skip[(size_t)b * n_states + s] : kNegInf;
  const float se = live ? s_end[(size_t)b * n_states + s] : kNegInf;
  auto row_of = [n_time](int i) { return min(n_time - i, n_time - 1); };
  for (int i = s; i < 4 * width; i += blockDim.x) rows[i] = kNegInf;
  float v = kNegInf;
  float l0 = lpz_at(lp, frame, row_of(0), live);
  float l1 = 1 < n_time ? lpz_at(lp, frame, row_of(1), live) : 0.f;
  float l2 = 2 < n_time ? lpz_at(lp, frame, row_of(2), live) : 0.f;
  __syncthreads();
  for (int i = 0; i < n_time; ++i) {
    const int t = n_time - 1 - i;
    const float cur = l0;
    l0 = l1;
    l1 = l2;
    l2 = i + 3 < n_time ? lpz_at(lp, frame, row_of(i + 3), live) : 0.f;
    float* m = rows + (i & 1) * 2 * width;
    float* ms = m + width;
    const float m0 = v + cur;
    if (live) {
      m[s] = m0;
      ms[s] = m0 + sk;
    }
    __syncthreads();
    if (t == len - 1) {
      v = se;
    } else if (t < len) {
      v = cut_logsum3(m0, m[s + 1], ms[s + 2]);
    }
    if (live && !kCutStore) out[(size_t)t * frame] = v;
  }
  if (live && kCutStore) out[0] = v;
}

cudaError_t prefetch_body(bool is_beta, const void* lpz, const void* skip, const void* lens,
                          const void* s_end, void* out, int n_time, int batch, int n_states,
                          cudaStream_t stream) {
  if (n_time < 1 || batch < 1 || n_states < 1 || n_states > kPrefetchStates) {
    return cudaErrorInvalidValue;
  }
  const int threads = (n_states + 31) / 32 * 32;
  if (is_beta) {
    ctc_beta_prefetch<<<batch, threads, 4 * (threads + 2) * sizeof(float), stream>>>(
        static_cast<const float*>(lpz), static_cast<const float*>(skip),
        static_cast<const int32_t*>(lens), static_cast<const float*>(s_end),
        static_cast<float*>(out), n_time, batch, n_states);
  } else {
    ctc_alpha_prefetch<<<batch, threads, 2 * (threads + 2) * sizeof(float), stream>>>(
        static_cast<const float*>(lpz), static_cast<const float*>(skip),
        static_cast<const int32_t*>(lens), static_cast<float*>(out), n_time, batch, n_states);
  }
  return cudaGetLastError();
}


// ------------------------------------------------------------- warp body
#ifdef NSD_CTC_WARP

// One warp a row, no block barrier: lane l keeps states [lK, (l+1)K) in
// registers (K = ceil(S/32) <= 8); s-1 and s-2 of its first states come from
// the lane below by two shuffles (beta: s+1 and s+2 of its last states from
// the lane above), and the lpz entries of kWarpAhead frames are in flight in
// a ring of registers, refilled kWarpAhead frames ahead of use (the frame
// loop unrolled by kWarpAhead, so the ring's slots are fixed registers).
constexpr int kWarpAhead = 4;
constexpr int kWarpMaxK = 8;  // S <= 256
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(32)
    ctc_alpha_warp(const float* __restrict__ lpz, const float* __restrict__ skip,
                   const int32_t* __restrict__ lens, float* __restrict__ alpha, int n_time,
                   int batch, int n_states) {
  const int lane = threadIdx.x, b = blockIdx.x, s0 = lane * K;
  const int len = lens[b];
  const size_t frame = (size_t)batch * n_states;
  const float* lp = lpz + (size_t)b * n_states + s0;
  float* out = alpha + (size_t)b * n_states + s0;
  bool live[K];
  float a[K], sk[K], ring[kWarpAhead][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    live[j] = s0 + j < n_states;
    sk[j] = live[j] ? skip[(size_t)b * n_states + s0 + j] : kNegInf;
    a[j] = live[j] && s0 + j <= 1 ? lp[j] : kNegInf;
    if (live[j] && !kCutStore) out[j] = a[j];
  }
  // frame f >= 1 sits in slot (f - 1) % kWarpAhead
#pragma unroll
  for (int d = 0; d < kWarpAhead; ++d) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ring[d][j] = 1 + d < n_time ? lpz_at(lp + j, frame, 1 + d, live[j]) : 0.f;
    }
  }
  for (int t0 = 1; t0 < n_time; t0 += kWarpAhead) {
#pragma unroll
    for (int d = 0; d < kWarpAhead; ++d) {
      const int t = t0 + d;
      if (t >= n_time) break;
      float cur[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        cur[j] = ring[d][j];
        ring[d][j] = t + kWarpAhead < n_time ? lpz_at(lp + j, frame, t + kWarpAhead, live[j])
                                             : 0.f;
      }
      if (t < len) {
        // the lane below's last two states (K = 1: the two lanes below)
        const float up1 = __shfl_up_sync(kFull, a[K - 1], 1);
        float up2;
        if constexpr (K >= 2) {
          up2 = __shfl_up_sync(kFull, a[K - 2], 1);
        } else {
          up2 = __shfl_up_sync(kFull, a[0], 2);
        }
        float next[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = s0 + j;
          const float a1 = j >= 1 ? a[j >= 1 ? j - 1 : 0] : (s >= 1 ? up1 : kNegInf);
          const float a2 =
              j >= 2 ? a[j >= 2 ? j - 2 : 0] : (s >= 2 ? (j == 1 ? up1 : up2) : kNegInf);
          next[j] = cut_logsum3(a[j], a1, a2 + sk[j]) + cur[j];
        }
#pragma unroll
        for (int j = 0; j < K; ++j) a[j] = next[j];
      }
      if (!kCutStore) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (live[j]) out[(size_t)t * frame + j] = a[j];
        }
      }
    }
  }
  if (kCutStore) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (live[j]) out[(size_t)(n_time - 1) * frame + j] = a[j];
    }
  }
}

// beta, steps i = 0..T-1 over frames t = T-1-i, step i reading the lpz row
// min(T-i, T-1) from slot i % kWarpAhead: m = beta + lpz and m + skip in
// registers, m[s+1] and (m + skip)[s+2] of a lane's last states from the
// lane above (K = 1: the two lanes above).
template <int K>
__global__ void __launch_bounds__(32)
    ctc_beta_warp(const float* __restrict__ lpz, const float* __restrict__ skip,
                  const int32_t* __restrict__ lens, const float* __restrict__ s_end,
                  float* __restrict__ beta, int n_time, int batch, int n_states) {
  const int lane = threadIdx.x, b = blockIdx.x, s0 = lane * K;
  const int len = lens[b];
  const size_t frame = (size_t)batch * n_states;
  const float* lp = lpz + (size_t)b * n_states + s0;
  float* out = beta + (size_t)b * n_states + s0;
  auto row_of = [n_time](int i) { return min(n_time - i, n_time - 1); };
  bool live[K];
  float v[K], sk[K], se[K], ring[kWarpAhead][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    live[j] = s0 + j < n_states;
    sk[j] = live[j] ? skip[(size_t)b * n_states + s0 + j] : kNegInf;
    se[j] = live[j] ? s_end[(size_t)b * n_states + s0 + j] : kNegInf;
    v[j] = kNegInf;
  }
#pragma unroll
  for (int d = 0; d < kWarpAhead; ++d) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ring[d][j] = d < n_time ? lpz_at(lp + j, frame, row_of(d), live[j]) : 0.f;
    }
  }
  for (int i0 = 0; i0 < n_time; i0 += kWarpAhead) {
#pragma unroll
    for (int d = 0; d < kWarpAhead; ++d) {
      const int i = i0 + d, t = n_time - 1 - i;
      if (i >= n_time) break;
      float m[K], ms[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        m[j] = v[j] + ring[d][j];
        ms[j] = m[j] + sk[j];
        ring[d][j] = i + kWarpAhead < n_time
                         ? lpz_at(lp + j, frame, row_of(i + kWarpAhead), live[j])
                         : 0.f;
      }
      if (t == len - 1) {
#pragma unroll
        for (int j = 0; j < K; ++j) v[j] = se[j];
      } else if (t < len) {
        const float dn_m = __shfl_down_sync(kFull, m[0], 1);
        const float dn_ms0 = __shfl_down_sync(kFull, ms[0], 1);
        float dn_ms1;
        if constexpr (K >= 2) {
          dn_ms1 = __shfl_down_sync(kFull, ms[1], 1);
        } else {
          dn_ms1 = __shfl_down_sync(kFull, ms[0], 2);
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = s0 + j;
          const float m1 = s + 1 < n_states ? (j + 1 < K ? m[j + 1 < K ? j + 1 : 0] : dn_m)
                                            : kNegInf;
          const float m2 = s + 2 < n_states
                               ? (j + 2 < K ? ms[j + 2 < K ? j + 2 : 0]
                                            : (j + 2 == K ? dn_ms0 : dn_ms1))
                               : kNegInf;
          v[j] = cut_logsum3(m[j], m1, m2);
        }
      }
      if (!kCutStore) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (live[j]) out[(size_t)t * frame + j] = v[j];
        }
      }
    }
  }
  if (kCutStore) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (live[j]) out[j] = v[j];
    }
  }
}

// The body with K = k states a lane (1 <= k <= kWarpMaxK).
template <int K>
cudaError_t launch_warp_k(int k, bool is_beta, const void* lpz, const void* skip,
                          const void* lens, const void* s_end, void* out, int n_time,
                          int batch, int n_states, cudaStream_t stream) {
  if constexpr (K < kWarpMaxK) {
    if (k > K) {
      return launch_warp_k<K + 1>(k, is_beta, lpz, skip, lens, s_end, out, n_time, batch,
                                  n_states, stream);
    }
  }
  if (is_beta) {
    ctc_beta_warp<K><<<batch, 32, 0, stream>>>(
        static_cast<const float*>(lpz), static_cast<const float*>(skip),
        static_cast<const int32_t*>(lens), static_cast<const float*>(s_end),
        static_cast<float*>(out), n_time, batch, n_states);
  } else {
    ctc_alpha_warp<K><<<batch, 32, 0, stream>>>(
        static_cast<const float*>(lpz), static_cast<const float*>(skip),
        static_cast<const int32_t*>(lens), static_cast<float*>(out), n_time, batch, n_states);
  }
  return cudaGetLastError();
}

cudaError_t warp_body(bool is_beta, const void* lpz, const void* skip, const void* lens,
                      const void* s_end, void* out, int n_time, int batch, int n_states,
                      cudaStream_t stream) {
  if (n_time < 1 || batch < 1 || n_states < 1 || n_states > 32 * kWarpMaxK) {
    return cudaErrorInvalidValue;
  }
  return launch_warp_k<1>((n_states + 31) / 32, is_beta, lpz, skip, lens, s_end, out, n_time,
                          batch, n_states, stream);
}

#endif  // NSD_CTC_WARP

}  // namespace

extern "C" {

int nsd_ctc_alpha(const void* lpz, const void* skip, const void* lens,
                  void* alpha, int n_time, int batch, int n_states,
                  void* stream) {
  if (n_time < 1 || batch < 1 || n_states < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * sizeof(float) * n_states;
  cudaError_t err = smem_ok(reinterpret_cast<const void*>(ctc_alpha_kernel),
                            smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_alpha_kernel<<<batch, block_threads(n_states), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const float*>(skip),
      static_cast<const int32_t*>(lens), static_cast<float*>(alpha), n_time,
      batch, n_states);
  return static_cast<int>(cudaGetLastError());
}

int nsd_ctc_beta(const void* lpz, const void* skip, const void* lens,
                 const void* s_end, void* beta, int n_time, int batch,
                 int n_states, void* stream) {
  if (n_time < 1 || batch < 1 || n_states < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * sizeof(float) * n_states;
  cudaError_t err = smem_ok(reinterpret_cast<const void*>(ctc_beta_kernel),
                            smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_beta_kernel<<<batch, block_threads(n_states), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const float*>(skip),
      static_cast<const int32_t*>(lens), static_cast<const float*>(s_end),
      static_cast<float*>(beta), n_time, batch, n_states);
  return static_cast<int>(cudaGetLastError());
}

int nsd_ctc_alpha_prefetch(const void* lpz, const void* skip, const void* lens,
                           void* alpha, int n_time, int batch, int n_states,
                           void* stream) {
  return static_cast<int>(prefetch_body(false, lpz, skip, lens, nullptr, alpha, n_time,
                                    batch, n_states, static_cast<cudaStream_t>(stream)));
}

int nsd_ctc_beta_prefetch(const void* lpz, const void* skip, const void* lens,
                          const void* s_end, void* beta, int n_time, int batch,
                          int n_states, void* stream) {
  return static_cast<int>(prefetch_body(true, lpz, skip, lens, s_end, beta, n_time, batch,
                                    n_states, static_cast<cudaStream_t>(stream)));
}

#ifdef NSD_CTC_WARP
int nsd_ctc_alpha_warp(const void* lpz, const void* skip, const void* lens, void* alpha,
                       int n_time, int batch, int n_states, void* stream) {
  return static_cast<int>(warp_body(false, lpz, skip, lens, nullptr, alpha, n_time, batch,
                                    n_states, static_cast<cudaStream_t>(stream)));
}

int nsd_ctc_beta_warp(const void* lpz, const void* skip, const void* lens, const void* s_end,
                      void* beta, int n_time, int batch, int n_states, void* stream) {
  return static_cast<int>(warp_body(true, lpz, skip, lens, s_end, beta, n_time, batch, n_states,
                                    static_cast<cudaStream_t>(stream)));
}
#endif  // NSD_CTC_WARP

}  // extern "C"
