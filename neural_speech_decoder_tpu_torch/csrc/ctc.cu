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
// Design: the rows are independent, so the TPU's sequential time grid
// becomes a loop inside one block per row: the S states go across the
// block's threads (a thread takes several when S exceeds the block), and
// the previous frame's states sit in shared memory, two buffers that swap
// each frame, with one barrier per frame. One launch per recursion, with no
// carry across blocks.
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

}  // extern "C"
