// Forward time scan of one (bi)directional GRU layer from precomputed input
// projections, for inference and for training:
//   xp [L, D, B, 3H] (b_ih already added, natural time order for both
//   directions), w_hh [D, H, 3H], b_hh [D, 3H] f32  ->  ys [L, D, B, H],
//   and for training also gates [L, D, B, 4H] = (r, z, n, hp_n) in xp's type,
//   what the backward (gru_scan_bwd.cu) reads instead of recomputing them.
// Gate order r, z, n (torch nn.GRU). Each step, for every direction:
//   hp = h @ W_hh + b_hh
//   r = sigmoid(x_r + hp_r);  z = sigmoid(x_z + hp_z)
//   n = tanh(x_n + r * hp_n)         (b_hh's n part sits inside r * (.))
//   h' = (1 - z) * n + z * h
// with h0 = 0. Direction 1 walks time in reverse through the kernel's
// indexing and writes its states back in natural order: no flip copies.
//
// Replaces the Pallas TPU kernels
// neural_speech_decoder_tpu/ops/pallas/gru_scan.py::_fwd_kernel (reached via
// gru_sequence -> _forward(with_gates=False)) and ::_fwd_gates_kernel
// (_gru_sequence_fwd -> _forward(with_gates=True)), which keep W_hh resident
// in VMEM for a whole direction and carry h in a float32 VMEM scratch. Both
// are one step kernel here, templated on whether it also writes the gates;
// everything else is shared, so the two give ys bit for bit alike.
//
// Numerics, as in the TPU kernel: the carry h is float32 across steps; the
// product takes h rounded to the weight's type (bf16 when xp is bf16) and
// accumulates in float32; the gate math is float32; ys has xp's type. The
// JAX package's lax.scan twin (models/gru.py::_gru_layer) instead rounds the
// carry itself to the compute type each step, so at bf16 the two differ by
// that rounding; this kernel and its plain version follow the TPU kernel.
//
// What bounds it on an H100: W_hh is 12 MB per direction in f32 (6 MB in
// bf16), far more than one SM's 227 KB of shared memory, and every step
// needs the whole previous h of all blocks. The step's product is
// 2*D*B*H*3H flops (805 MFLOP at D=2, B=64, H=1024) for one pass over W_hh,
// i.e. about 2*B flops per weight byte read in f32: below the tensor cores'
// ridge, above that of the FP32 FMA units. This version does its product on
// FP32 FMAs, so a step is bound by FMA throughput and by streaming W_hh out
// of L2, plus one launch per step.
//
// Design (the floor design): the host function loops over the L steps on
// the caller's stream and launches one step kernel per step, so the launch
// boundary is the grid-wide barrier between steps. A step's grid covers both
// directions, all hidden units and all batch rows: one block per
// (32 hidden units, direction, 32 batch rows). A block computes the r, z and
// n pre-activations of its 32 units for its 32 rows over the full H
// contraction. Its 512 threads form two parts that each take half of the
// contraction (so that an SM holds 16 warps instead of 8) and add their sums
// through shared memory at the end. A part stages 32-row chunks of h
// (rounded to the weight type) and of the three matching 32-column slices of
// W_hh in shared memory, with the next chunk's loads in flight in registers
// during the current chunk's products; each thread keeps 4 rows x 3 gates
// in registers. Both directions' W_hh
// (24 MB in f32) stay in the 50 MB L2 across steps. The float32 carry
// ping-pongs between two [D, B, H] buffers that the caller allocates; step 0
// reads no carry.
#include "common.cuh"

namespace {

constexpr int kUnits = 32;     // hidden units per block
constexpr int kRowsB = 32;     // batch rows per block
constexpr int kK = 32;         // contraction chunk staged in shared memory
constexpr int kLanes = 256;    // per part: 32 unit lanes x 8 row lanes
constexpr int kSplit = 2;      // parts of the contraction, threadIdx.y

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.f / (1.f + expf(-v));
}

template <typename T, bool kGates>
__global__ void __launch_bounds__(kLanes * kSplit)
    gru_step_kernel(const T* __restrict__ xp, const T* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ h_prev,
                    float* __restrict__ h_next, T* __restrict__ ys,
                    T* __restrict__ gates, int step, int n_steps, int n_dirs,
                    int batch, int hidden) {
  // hs is stored k-major so that a thread's 4 batch rows are one 16-byte
  // load (the same address for the whole warp: a broadcast).
  __shared__ __align__(16) float hs_parts[kSplit][kK][kRowsB + 4];
  __shared__ float ws_parts[kSplit][kK][3 * kUnits];
  __shared__ float partial[kLanes][13];  // part 1's sums, padded row
  constexpr int kHLoads = kRowsB * kK / kLanes;     // 4 per thread
  constexpr int kWLoads = kK * 3 * kUnits / kLanes;  // 12 per thread
  const int lane = threadIdx.x;
  const int part = threadIdx.y;
  auto& hs = hs_parts[part];
  auto& ws = ws_parts[part];
  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.z * kRowsB;
  const int tj = lane % kUnits;
  const int tb = lane / kUnits;  // rows 4*tb .. 4*tb+3
  const int three_h = 3 * hidden;
  const int t = d == 0 ? step : n_steps - 1 - step;
  const float* hp_d = h_prev + (size_t)d * batch * hidden;
  const T* w_d = w + (size_t)d * hidden * three_h;

  float acc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = 0.f;
    acc[i][1] = 0.f;
    acc[i][2] = 0.f;
  }
  if (step > 0) {
    // The next chunk's loads are started into registers before the current
    // chunk's products, so their latency overlaps the arithmetic.
    float h_reg[kHLoads];
    float w_reg[kWLoads];
    auto load_chunk = [&](int k0) {
#pragma unroll
      for (int u = 0; u < kHLoads; ++u) {
        const int i = lane + u * kLanes;
        const int bb = b0 + i / kK;
        const int k = k0 + i % kK;
        h_reg[u] = (bb < batch && k < hidden)
                       ? nsd::round_to<T>(hp_d[(size_t)bb * hidden + k])
                       : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = lane + u * kLanes;
        const int c = i % (3 * kUnits);
        const int g = c / kUnits;
        const int j = j0 + c - g * kUnits;
        const int k = k0 + i / (3 * kUnits);
        w_reg[u] = (k < hidden && j < hidden)
                       ? nsd::to_f32(w_d[(size_t)k * three_h + g * hidden + j])
                       : 0.f;
      }
    };
    // part p sums k in [p * k_span, (p + 1) * k_span); loads past H are 0
    const int k_span = (hidden + kSplit * kK - 1) / (kSplit * kK) * kK;
    const int k_lo = part * k_span;
    load_chunk(k_lo);
    for (int k0 = k_lo; k0 < k_lo + k_span; k0 += kK) {
#pragma unroll
      for (int u = 0; u < kHLoads; ++u) {
        const int i = lane + u * kLanes;
        hs[i % kK][i / kK] = h_reg[u];
      }
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = lane + u * kLanes;
        ws[i / (3 * kUnits)][i % (3 * kUnits)] = w_reg[u];
      }
      __syncthreads();
      if (k0 + kK < k_lo + k_span) load_chunk(k0 + kK);
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[kk][4 * tb]);
        const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
        const float wr = ws[kk][tj];
        const float wz = ws[kk][kUnits + tj];
        const float wn = ws[kk][2 * kUnits + tj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(h4[i], wr, acc[i][0]);
          acc[i][1] = fmaf(h4[i], wz, acc[i][1]);
          acc[i][2] = fmaf(h4[i], wn, acc[i][2]);
        }
      }
      __syncthreads();
    }
  }

  if (part == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      partial[lane][3 * i] = acc[i][0];
      partial[lane][3 * i + 1] = acc[i][1];
      partial[lane][3 * i + 2] = acc[i][2];
    }
  }
  __syncthreads();
  if (part == 1) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] += partial[lane][3 * i];
    acc[i][1] += partial[lane][3 * i + 1];
    acc[i][2] += partial[lane][3 * i + 2];
  }
  const int j = j0 + tj;
  if (j >= hidden) return;
  const float* b_d = bias + (size_t)d * three_h;
  const float b_r = b_d[j];
  const float b_z = b_d[hidden + j];
  const float b_n = b_d[2 * hidden + j];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bb = b0 + 4 * tb + i;
    if (bb < batch) {
      const T* x = xp + (((size_t)t * n_dirs + d) * batch + bb) * three_h;
      const float hp_r = acc[i][0] + b_r;
      const float hp_z = acc[i][1] + b_z;
      const float hp_n = acc[i][2] + b_n;
      const float r = sigmoid_f32(nsd::to_f32(x[j]) + hp_r);
      const float z = sigmoid_f32(nsd::to_f32(x[hidden + j]) + hp_z);
      const float n = tanhf(nsd::to_f32(x[2 * hidden + j]) + r * hp_n);
      const float h_old = step > 0 ? hp_d[(size_t)bb * hidden + j] : 0.f;
      const float h = (1.f - z) * n + z * h_old;
      h_next[((size_t)d * batch + bb) * hidden + j] = h;
      ys[(((size_t)t * n_dirs + d) * batch + bb) * hidden + j] =
          nsd::from_f32<T>(h);
      if (kGates) {
        T* g = gates + (((size_t)t * n_dirs + d) * batch + bb) * 4 * hidden;
        g[j] = nsd::from_f32<T>(r);
        g[hidden + j] = nsd::from_f32<T>(z);
        g[2 * hidden + j] = nsd::from_f32<T>(n);
        g[3 * hidden + j] = nsd::from_f32<T>(hp_n);
      }
    }
  }
}

// gates == nullptr: the inference kernel; otherwise the training kernel.
template <typename T>
cudaError_t run_scan(const void* xp, const void* w, const void* bias,
                     void* ys, void* gates, void* carry, int n_steps,
                     int n_dirs, int batch, int hidden, cudaStream_t stream) {
  if (n_steps < 1 || n_dirs < 1 || n_dirs > 2 || batch < 1 || hidden < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((hidden + kUnits - 1) / kUnits, n_dirs,
                  (batch + kRowsB - 1) / kRowsB);
  float* h0 = static_cast<float*>(carry);
  float* h1 = h0 + (size_t)n_dirs * batch * hidden;
  for (int s = 0; s < n_steps; ++s) {
    const float* h_prev = (s & 1) ? h1 : h0;
    float* h_next = (s & 1) ? h0 : h1;
    if (gates == nullptr) {
      gru_step_kernel<T, false><<<grid, dim3(kLanes, kSplit), 0, stream>>>(
          static_cast<const T*>(xp), static_cast<const T*>(w),
          static_cast<const float*>(bias), h_prev, h_next,
          static_cast<T*>(ys), nullptr, s, n_steps, n_dirs, batch, hidden);
    } else {
      gru_step_kernel<T, true><<<grid, dim3(kLanes, kSplit), 0, stream>>>(
          static_cast<const T*>(xp), static_cast<const T*>(w),
          static_cast<const float*>(bias), h_prev, h_next,
          static_cast<T*>(ys), static_cast<T*>(gates), s, n_steps, n_dirs,
          batch, hidden);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int nsd_gru_scan_f32(const void* xp, const void* w, const void* bias,
                     void* ys, void* carry, int n_steps, int n_dirs,
                     int batch, int hidden, void* stream) {
  return static_cast<int>(run_scan<float>(
      xp, w, bias, ys, nullptr, carry, n_steps, n_dirs, batch, hidden,
      static_cast<cudaStream_t>(stream)));
}

int nsd_gru_scan_bf16(const void* xp, const void* w, const void* bias,
                      void* ys, void* carry, int n_steps, int n_dirs,
                      int batch, int hidden, void* stream) {
  return static_cast<int>(run_scan<__nv_bfloat16>(
      xp, w, bias, ys, nullptr, carry, n_steps, n_dirs, batch, hidden,
      static_cast<cudaStream_t>(stream)));
}

int nsd_gru_scan_gates_f32(const void* xp, const void* w, const void* bias,
                           void* ys, void* gates, void* carry, int n_steps,
                           int n_dirs, int batch, int hidden, void* stream) {
  if (gates == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_scan<float>(
      xp, w, bias, ys, gates, carry, n_steps, n_dirs, batch, hidden,
      static_cast<cudaStream_t>(stream)));
}

int nsd_gru_scan_gates_bf16(const void* xp, const void* w, const void* bias,
                            void* ys, void* gates, void* carry, int n_steps,
                            int n_dirs, int batch, int hidden, void* stream) {
  if (gates == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_scan<__nv_bfloat16>(
      xp, w, bias, ys, gates, carry, n_steps, n_dirs, batch, hidden,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
