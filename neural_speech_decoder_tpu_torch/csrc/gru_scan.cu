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
// ridge, above that of the FP32 FMA units. The step body does its product on
// FP32 FMAs, so a step is bound by FMA throughput and by streaming W_hh out
// of L2, plus one launch per step; the persistent bodies keep W_hh in shared
// memory across the blocks, so a step streams only h.
//
// Two bodies. The persistent body runs every scan whose slice fits, in
// bfloat16 and in float32 (an instantiation of each); the step body (the
// floor design) runs the shapes that the persistent body cannot hold, and
// the step arm of an A/B. The caller (ops/kernels/gru_scan.py::scan_plan)
// chooses from the shape and dtype before the launch.
//
// Step body: the host function loops over the L steps on the caller's
// stream and launches one step kernel per step, so the launch boundary is
// the grid-wide barrier between steps. A step's grid covers both
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
//
// Persistent body (bf16): one cooperative launch a layer, at most one block
// an SM, walks all L steps. A block owns U hidden units (a multiple of 8) of
// one direction and all three gates of them; its slice of W_hh, [H, 3U]
// bf16 (96 KB at H=1024, U=16), is loaded into shared memory once,
// transposed to [3U][H] so that ldmatrix reads it as mma's B operand, and
// stays there for the whole walk. Each step the block copies h_{t-1}, all
// B rows of its direction, out of L2 into shared memory (cp.async.cg, in
// four column chunks, the first chunk's products starting while the rest
// arrive) and forms its [B, 3U] pre-activations on mma.sync m16n8k16
// (bf16 x bf16 -> float32: the TPU kernel's product, in another order). A
// warp owns one 16-row tile and 8 units, and its r, z and n accumulators
// hold the same (row, unit) elements, so the gate math runs on them in
// registers and the float32 carry of those elements never leaves the
// thread. ys[t] is round_to<bf16>(h_t), exactly the next step's product
// input, so the next step reads h_{t-1} from ys (direction 0 at ys[t-1],
// direction 1 at ys[t+1]) and no carry buffer exists. The blocks of a
// direction meet at a barrier on a counter between steps (a release
// arrival and an acquire wait; the directions do not wait for each other).
// Per step a block reads 2*B*H bytes of h from L2 (128 KB at B=64, H=1024,
// 16.8 MB over 128 blocks) for 2*B*H*3U flops: the L2 traffic and the
// barrier set the pace, not the tensor cores.
//
// Persistent body (float32): the same launch, blocks, units and barrier,
// the TPU kernel's float32 product on FP32 FMAs (no TF32). The slice of W_hh,
// [H, 3U] float32 (192 KB at H=1024, U=16), is transposed into shared memory
// once, [3U][H]; ys[t] is h_t exactly, so again the next step reads h_{t-1}
// from ys and no carry buffer exists. A warp owns a tile of 8 rows x 16 units
// (16 x 8 where U % 16 != 0) and all three gates, and streams its own rows
// of h_{t-1} out of L2 through a ring of its own (four 32-column chunks,
// cp.async.cg, three in flight), so that warps meet only at the barrier
// between steps: a block-wide barrier a chunk kept them in lockstep and
// all asking shared memory for their operands at once. Lane 8 a + kg sums
// an 8-row x 12-column tile (4 units x 3 gates) over the 16-byte piece kg of
// every chunk: 20 shared loads for 384 FMAs, the eight lanes of a piece
// reading 128 contiguous bytes; shared memory feeds registers 128 bytes a
// cycle, which a smaller tile (4 loads per 12 FMAs) made the bound. The
// eight partial sums of a row then meet in a butterfly that leaves each lane
// one row of its 4 units (nsd::reduce_rows8), the elements whose gate math
// and float32 carry it keeps; ys and the gates go out as 16-byte stores. Per
// step a block reads 4*B*H bytes of h (256 KB at B=64, H=1024) for 2*B*H*3U
// flops (6.3 MFLOP, 12.4 us at the FP32 peak).
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The persistent bf16 body.

using bf16 = __nv_bfloat16;
constexpr int kChunks = 4;  // column chunks of h per step

using nsd::round_up;

// Dynamic shared memory of the persistent forward: W's slice [3U][Hp+8] and
// h [16*ceil(B/16)][Hp+8], bf16, Hp = H rounded up to 16 (the 8-element pad
// puts the 8 rows an ldmatrix reads on distinct banks).
__host__ __device__ constexpr int fwd_smem_bytes(int units, int batch, int hidden) {
  return 2 * (3 * units + round_up(batch, 16)) * (round_up(hidden, 16) + 8);
}

template <bool kGates>
__global__ void __launch_bounds__(256, 1)
    gru_fwd_persistent(const bf16* __restrict__ xp, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ ys,
                       bf16* __restrict__ gates, unsigned* __restrict__ sync,
                       int n_steps, int n_dirs, int batch, int hidden, int units) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_blk = (hidden + units - 1) / units;  // blocks of a direction
  const int d = blockIdx.x / n_blk;
  const int j0 = (blockIdx.x % n_blk) * units;
  const int hp = round_up(hidden, 16);
  const int ld = hp + 8;
  const int rows = round_up(batch, 16);
  const int three_h = 3 * hidden;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [3U][ld]
  bf16* hs = ws + 3 * units * ld;                 // [rows][ld]
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;

  // W's slice, transposed: ws[g*U + u][k] = W[d][k][g*H + j0 + u], zero
  // past H (k) and past the last unit; hs zero, of which the rows past B
  // and the columns past H stay so.
  for (int i = tid; i < 3 * units * hp; i += n_thr) {
    const int n = i % (3 * units), k = i / (3 * units);
    const int g = n / units, j = j0 + n % units;
    ws[n * ld + k] = k < hidden && j < hidden
                         ? w[((size_t)d * hidden + k) * three_h + g * hidden + j]
                         : __float2bfloat16(0.f);
  }
  for (int i = tid; i < rows * ld; i += n_thr) hs[i] = __float2bfloat16(0.f);

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ug = warp % (units / 8);  // the warp's 8 units
  const int mt = warp / (units / 8);  // and its 16 rows
  const int jj = j0 + 8 * ug + 2 * (lane % 4);  // units jj, jj+1 of the thread
  const bool j_ok = jj < hidden;                // hidden % 8 == 0: both or neither
  int bb[2];
  bool b_ok[2];
  for (int e = 0; e < 2; ++e) {
    bb[e] = 16 * mt + lane / 4 + 8 * e;
    b_ok[e] = j_ok && bb[e] < batch;
  }
  float bias_g[3][2] = {};
  if (j_ok) {
    for (int g = 0; g < 3; ++g) {
      bias_g[g][0] = bias[(size_t)d * three_h + g * hidden + jj];
      bias_g[g][1] = bias[(size_t)d * three_h + g * hidden + jj + 1];
    }
  }
  // column chunks of h: kChunks of kc columns (a multiple of 16), the last
  // ones possibly empty
  const int kc = round_up((hp + kChunks - 1) / kChunks, 16);
  float carry[4] = {0.f, 0.f, 0.f, 0.f};  // f32 h of (row bb[e/2], unit jj + e%2)
  // a step's inputs x_r, x_z, x_n of the thread's elements, independent of
  // the other blocks: loaded before the barrier that precedes their step
  float2 x[3][2];
  auto load_x = [&](int s) {
    const int t = d == 0 ? s : n_steps - 1 - s;
    for (int e = 0; e < 2; ++e) {
      const bf16* xr = xp + (((size_t)t * n_dirs + d) * batch + bb[e]) * three_h + jj;
      for (int g = 0; g < 3; ++g) {
        x[g][e] = b_ok[e] ? __bfloat1622float2(
                                *reinterpret_cast<const __nv_bfloat162*>(xr + g * hidden))
                          : make_float2(0.f, 0.f);
      }
    }
  };
  load_x(0);
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int t = d == 0 ? s : n_steps - 1 - s;
    float acc[3][4] = {};
    if (s > 0) {
      const int tp = d == 0 ? s - 1 : n_steps - s;  // scan position s-1
      const bf16* hsrc = ys + ((size_t)tp * n_dirs + d) * batch * hidden;
      const int pieces = kc / 8;
      for (int c = 0; c < kChunks; ++c) {
        const int k0 = c * kc;
        for (int i = tid; i < batch * pieces; i += n_thr) {
          const int b = i / pieces, k = k0 + 8 * (i % pieces);
          if (!nsd::kCutLoad && k < hidden) {
            nsd::cp_async16(hs + b * ld + k, hsrc + (size_t)b * hidden + k, true);
          }
        }
        nsd::cp_async_commit();
      }
      for (int c = 0; c < kChunks; ++c) {
        nsd::cp_async_wait_upto(kChunks - 1 - c);
        __syncthreads();
        const int k_end = min(hp, (c + 1) * kc);
        for (int k = c * kc; k < k_end; k += 16) {
          uint32_t a[4];
          nsd::ldsm_x4(hs + (16 * mt + lane % 16) * ld + k + 8 * (lane / 16), a);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            uint32_t b[2];
            nsd::ldsm_x2(ws + (g * units + 8 * ug + lane % 8) * ld + k + 8 * ((lane / 8) % 2), b);
            if (!nsd::kCutMma) nsd::mma(acc[g], a, b[0], b[1]);
          }
        }
      }
    }
    for (int e = 0; e < 2; ++e) {
      if (!b_ok[e]) continue;
      const size_t row = ((size_t)t * n_dirs + d) * batch + bb[e];
      float h2[2], gate[4][2];
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * e + q;
        float hp_g[3];
        for (int g = 0; g < 3; ++g) hp_g[g] = acc[g][i] + bias_g[g][q];
        const float xr = q ? x[0][e].y : x[0][e].x;
        const float xz = q ? x[1][e].y : x[1][e].x;
        const float xn = q ? x[2][e].y : x[2][e].x;
        const float r = sigmoid_f32(xr + hp_g[0]);
        const float z = sigmoid_f32(xz + hp_g[1]);
        const float n = tanhf(xn + r * hp_g[2]);
        const float h = (1.f - z) * n + z * carry[i];
        carry[i] = h;
        h2[q] = h;
        gate[0][q] = r;
        gate[1][q] = z;
        gate[2][q] = n;
        gate[3][q] = hp_g[2];
      }
      *reinterpret_cast<__nv_bfloat162*>(ys + row * hidden + jj) =
          __floats2bfloat162_rn(h2[0], h2[1]);
      if (kGates) {
        bf16* gr = gates + row * 4 * hidden + jj;
        for (int g = 0; g < 4; ++g) {
          *reinterpret_cast<__nv_bfloat162*>(gr + g * hidden) =
              __floats2bfloat162_rn(gate[g][0], gate[g][1]);
        }
      }
    }
    if (s + 1 < n_steps) {
      load_x(s + 1);
      if (!nsd::kCutBarrier) nsd::group_barrier(sync + d, (unsigned)(s + 1) * n_blk);
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent float32 body.

constexpr int kKc32 = 32;             // columns of h a chunk holds
constexpr int kPieces32 = kKc32 / 4;  // 16-byte pieces of a chunk row: the k groups
constexpr int kStages32 = 4;          // chunks of a warp's ring

// A warp's tile of the float32 persistent forward: 8 rows x 16 units where
// U % 16 == 0, else 16 rows x 8 units. Each warp streams its own rows
// through a ring of its own, [kStages32][rows of its tile][kKc32].
__host__ __device__ constexpr int warp_rows_f32(int units) { return units % 16 ? 16 : 8; }

// Dynamic shared memory of the persistent float32 forward: W's slice
// [3U][Hp] (Hp = H rounded up to kKc32) and the warps' rings, float32.
__host__ __device__ constexpr int fwd_smem_bytes_f32(int units, int batch, int hidden) {
  return 4 * (3 * units * round_up(hidden, kKc32) +
              round_up(batch, 16) / 16 * (units / 8) * kStages32 * warp_rows_f32(units) * kKc32);
}

template <bool kGates, int kRowsW>
__global__ void __launch_bounds__(256, 1)
    gru_fwd_persistent_f32(const float* __restrict__ xp, const float* __restrict__ w,
                           const float* __restrict__ bias, float* __restrict__ ys,
                           float* __restrict__ gates, unsigned* __restrict__ sync,
                           int n_steps, int n_dirs, int batch, int hidden, int units) {
  constexpr int kUnitsW = 128 / kRowsW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_blk = (hidden + units - 1) / units;  // blocks of a direction
  const int d = blockIdx.x / n_blk;
  const int j0 = (blockIdx.x % n_blk) * units;
  const int hp = round_up(hidden, kKc32);
  const int three_h = 3 * hidden;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [3U][hp]
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;

  // W's slice, transposed: row n = g*U + u of ws holds W[d][k][g*H + j0 + u]
  // over k, zero past H and past the last unit
  for (int i = tid; i < 3 * units * hp; i += n_thr) {
    const int n = i % (3 * units), k = i / (3 * units);
    const int g = n / units, j = j0 + n % units;
    ws[n * hp + k] =
        k < hidden && j < hidden ? w[((size_t)d * hidden + k) * three_h + g * hidden + j] : 0.f;
  }

  // A warp's tile: kRowsW rows (rt) x kUnitsW units (ut) x the 3 gates.
  // Lane 8 a + kg sums 8 rows kRowsW rt + 8 rh + i (i < 8) against 4 units
  // kUnitsW ut + 4 uq + v (v < 4) of each gate over piece kg of every chunk
  // (rh, uq from a): an 8 x 12 tile, 20 16-byte shared loads for 384 FMAs
  // (the eight lanes of a k group read 128 contiguous bytes). reduce_rows8
  // then leaves the lane row kRowsW rt + 8 rh + kg of its 4 units: its
  // elements v. Warps meet only at the barrier between steps.
  const int lane = tid % 32, warp = tid / 32;
  const int ut = warp % (units / kUnitsW), rt = warp / (units / kUnitsW);
  const int kg = lane % 8, rh = lane / 8 % (kRowsW / 8), uq = lane / 8 / (kRowsW / 8);
  const int row = kRowsW * rt + 8 * rh + kg;   // the lane's row after the sum
  const int j4 = j0 + kUnitsW * ut + 4 * uq;  // and its first unit
  const bool ok = row < batch && j4 < hidden;  // hidden % 8 == 0: all 4 units or none
  float bias_g[3][4];
  for (int gt = 0; gt < 3; ++gt) {
    for (int v = 0; v < 4; ++v) {
      bias_g[gt][v] = j4 < hidden ? bias[(size_t)d * three_h + gt * hidden + j4 + v] : 0.f;
    }
  }
  float carry[4] = {0.f, 0.f, 0.f, 0.f};  // h of the lane's elements
  // a step's x_r, x_z, x_n of the lane's elements, independent of the other
  // blocks: loaded before the barrier that precedes their step
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x[3];
  auto load_x = [&](int s) {
    const int t = d == 0 ? s : n_steps - 1 - s;
    const float* xr = xp + (((size_t)t * n_dirs + d) * batch + row) * three_h + j4;
    for (int gt = 0; gt < 3; ++gt) {
      x[gt] = ok ? *reinterpret_cast<const float4*>(xr + gt * hidden) : zero4;
    }
  };
  // the rings zero, of which the rows past B stay so
  for (int i = 3 * units * hp + tid; i < fwd_smem_bytes_f32(units, batch, hidden) / 4;
       i += n_thr) {
    ws[i] = 0.f;
  }
  load_x(0);
  __syncthreads();
  const int n_chunks = hp / kKc32;
  const int tile_rows = batch - kRowsW * rt;  // rows of the warp's tile below B
  float* ring = reinterpret_cast<float*>(smem_raw) + 3 * units * hp +
                warp * kStages32 * kRowsW * kKc32;  // [kStages32][kRowsW][kKc32]
  const float* h_lane = ring + 8 * rh * kKc32 + 4 * kg;
  const float* w_lane = ws + (kUnitsW * ut + 4 * uq) * hp + 4 * kg;

  for (int s = 0; s < n_steps; ++s) {
    const int t = d == 0 ? s : n_steps - 1 - s;
    float acc[8][12] = {};  // [i][4 gate + v], the lane's piece of the sum
    if (s > 0) {
      const int tp = d == 0 ? s - 1 : n_steps - s;  // scan position s-1
      const float* hsrc =
          ys + (((size_t)tp * n_dirs + d) * batch + kRowsW * rt) * hidden;  // the tile's rows
      // the warp's rows of chunk c: lane + 32 f is row (lane + 32 f) / 8,
      // piece lane % 8 (zero past H; rows past B are not read)
      auto load = [&](int c) {
        float* dst = ring + (c % kStages32) * kRowsW * kKc32;
#pragma unroll
        for (int f = 0; f < kRowsW / 4; ++f) {
          const int r = (lane + 32 * f) / kPieces32, k = c * kKc32 + 4 * kg;
          if (!nsd::kCutLoad && r < tile_rows) {
            nsd::cp_async16(dst + r * kKc32 + 4 * kg,
                            hsrc + (size_t)r * hidden + (k < hidden ? k : 0), k < hidden);
          }
        }
      };
      for (int c = 0; c < kStages32 - 1; ++c) {
        if (c < n_chunks) load(c);
        nsd::cp_async_commit();
      }
      for (int c = 0; c < n_chunks; ++c) {
        nsd::cp_async_wait<kStages32 - 2>();
        __syncwarp();
        if (c + kStages32 - 1 < n_chunks) load(c + kStages32 - 1);
        nsd::cp_async_commit();
        {
          const float* hs = h_lane + (c % kStages32) * kRowsW * kKc32;
          float4 wv[12];
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              wv[4 * gt + v] = *reinterpret_cast<const float4*>(
                  w_lane + (gt * units + v) * hp + c * kKc32);
            }
          }
          if (nsd::kCutMma) continue;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 hv = *reinterpret_cast<const float4*>(hs + i * kKc32);
#pragma unroll
            for (int n = 0; n < 12; ++n) {
              float a = acc[i][n];
              a = fmaf(hv.x, wv[n].x, a);
              a = fmaf(hv.y, wv[n].y, a);
              a = fmaf(hv.z, wv[n].z, a);
              acc[i][n] = fmaf(hv.w, wv[n].w, a);
            }
          }
        }
      }
    }
    float sum[12];  // the lane's row: [4 gate + v]
    nsd::reduce_rows8(acc, sum);
    if (ok) {
      const size_t row_i = ((size_t)t * n_dirs + d) * batch + row;
      float h[4], gate[4][4];
      const float xs[3][4] = {{x[0].x, x[0].y, x[0].z, x[0].w},
                              {x[1].x, x[1].y, x[1].z, x[1].w},
                              {x[2].x, x[2].y, x[2].z, x[2].w}};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float hp_r = sum[v] + bias_g[0][v];
        const float hp_z = sum[4 + v] + bias_g[1][v];
        const float hp_n = sum[8 + v] + bias_g[2][v];
        const float r = sigmoid_f32(xs[0][v] + hp_r);
        const float z = sigmoid_f32(xs[1][v] + hp_z);
        const float n = tanhf(xs[2][v] + r * hp_n);
        h[v] = (1.f - z) * n + z * carry[v];
        carry[v] = h[v];
        gate[0][v] = r;
        gate[1][v] = z;
        gate[2][v] = n;
        gate[3][v] = hp_n;
      }
      *reinterpret_cast<float4*>(ys + row_i * hidden + j4) = make_float4(h[0], h[1], h[2], h[3]);
      if (kGates) {
        float* gr = gates + row_i * 4 * hidden + j4;
        for (int gt = 0; gt < 4; ++gt) {
          *reinterpret_cast<float4*>(gr + gt * hidden) =
              make_float4(gate[gt][0], gate[gt][1], gate[gt][2], gate[gt][3]);
        }
      }
    }
    if (s + 1 < n_steps) {
      load_x(s + 1);
      if (!nsd::kCutBarrier) nsd::group_barrier(sync + d, (unsigned)(s + 1) * n_blk);
    }
  }
}

// Checks a persistent launch's arguments against the kernel's arithmetic
// (smem_want: the dtype's fwd_smem_bytes).
cudaError_t check_persistent(int n_dirs, int batch, int hidden, int units, int threads,
                             int smem, int smem_want) {
  if (n_dirs < 1 || n_dirs > 2 || batch < 1 || hidden < 8 || hidden % 8 || units < 8 ||
      units % 8 || threads != 32 * (round_up(batch, 16) / 16) * (units / 8) ||
      threads > 256 || smem != smem_want) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// T: bf16 (gru_fwd_persistent) or float (gru_fwd_persistent_f32).
template <typename T, bool kGates>
cudaError_t run_persistent(const void* xp, const void* w, const void* bias, void* ys,
                           void* gates, void* sync, int n_steps, int n_dirs, int batch,
                           int hidden, int units, int threads, int smem,
                           cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (n_steps < 1) return cudaErrorInvalidValue;
  NSD_TRY(check_persistent(n_dirs, batch, hidden, units, threads, smem,
                           kF32 ? fwd_smem_bytes_f32(units, batch, hidden)
                                : fwd_smem_bytes(units, batch, hidden)));
  const void* kernel =
      !kF32            ? reinterpret_cast<const void*>(&gru_fwd_persistent<kGates>)
      : units % 16 == 0 ? reinterpret_cast<const void*>(&gru_fwd_persistent_f32<kGates, 8>)
                        : reinterpret_cast<const void*>(&gru_fwd_persistent_f32<kGates, 16>);
  const int blocks = n_dirs * ((hidden + units - 1) / units);
  if (nsd::coresident_blocks(kernel, threads, smem) < blocks) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  NSD_TRY(cudaMemsetAsync(sync, 0, 2 * sizeof(unsigned), stream));
  const T* xp_ = static_cast<const T*>(xp);
  const T* w_ = static_cast<const T*>(w);
  const float* bias_ = static_cast<const float*>(bias);
  T* ys_ = static_cast<T*>(ys);
  T* gates_ = static_cast<T*>(gates);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  void* args[] = {&xp_, &w_, &bias_, &ys_, &gates_, &sync_,
                  &n_steps, &n_dirs, &batch, &hidden, &units};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args,
                                     (size_t)smem, stream);
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

// The persistent bf16 body (gates == nullptr: the inference scan). sync is
// two unsigned counters, zeroed here on the stream. units, threads and smem
// come from the caller's plan and are checked against the kernel's own
// arithmetic; a grid that the card cannot hold at once returns
// cudaErrorCooperativeLaunchTooLarge and launches nothing.
int nsd_gru_scan_persistent_bf16(const void* xp, const void* w, const void* bias,
                                 void* ys, void* gates, void* sync, int n_steps,
                                 int n_dirs, int batch, int hidden, int units,
                                 int threads, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      gates == nullptr
          ? run_persistent<bf16, false>(xp, w, bias, ys, nullptr, sync, n_steps, n_dirs,
                                        batch, hidden, units, threads, smem, st)
          : run_persistent<bf16, true>(xp, w, bias, ys, gates, sync, n_steps, n_dirs, batch,
                                       hidden, units, threads, smem, st));
}

// The persistent float32 body, with the bf16 entry's arguments in float32.
int nsd_gru_scan_persistent_f32(const void* xp, const void* w, const void* bias,
                                void* ys, void* gates, void* sync, int n_steps,
                                int n_dirs, int batch, int hidden, int units,
                                int threads, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      gates == nullptr
          ? run_persistent<float, false>(xp, w, bias, ys, nullptr, sync, n_steps, n_dirs,
                                         batch, hidden, units, threads, smem, st)
          : run_persistent<float, true>(xp, w, bias, ys, gates, sync, n_steps, n_dirs,
                                        batch, hidden, units, threads, smem, st));
}

// The card's SM count and the shared memory one block may opt in to.
int nsd_device_limits(int* n_sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(err);
}

}  // extern "C"
