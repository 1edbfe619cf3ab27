// Backward time scan of one (bi)directional GRU layer, from the gates that
// the training forward (gru_scan.cu, gates variant) stored:
//   gates [L, D, B, 4H] = (r, z, n, hp_n), ys [L, D, B, H], dys [L, D, B, H],
//   wt [D, 3H, H] (W_hh transposed, in the gates' type)
//   ->  dxp [L, D, B, 3H] and dhp_n [L, D, B, H] in the gates' type,
//       dW_hh [D, H, 3H] f32, db_hh [D, 3H] f32.
// dhp = (da_r, da_z, dhp_n) is read as dxp's r and z thirds beside dhp_n.
// Each step, walking scan positions s = L-1 .. 0 (time t = s for direction
// 0, t = L-1-s for direction 1), with h_prev the state at scan position
// s-1 (zero at s = 0) and the f32 carry dh (zero at s = L-1):
//   dh_tot = dh + dys[t]
//   dz = dh_tot (h_prev - n);  dn = dh_tot (1 - z);  da_n = dn (1 - n^2)
//   da_z = dz z (1 - z);       da_r = da_n hp_n r (1 - r)
//   dxp[t] = (da_r, da_z, da_n);  dhp_n[t] = da_n r               (rounded)
//   dhp[t] = (da_r, da_z, dhp_n[t])
//   dh <- dh_tot z + dhp[t] @ W_hh^T                 (f32 accumulation)
//   dW_hh += h_prev^T dhp[t];  db_hh += sum_b dhp[t]
//
// Replaces the Pallas TPU kernel
// neural_speech_decoder_tpu/ops/pallas/gru_scan.py::_bwd_kernel (reached via
// _gru_sequence_bwd -> _backward), which walks time in reverse with W_hh^T
// resident in VMEM, carries dh in a f32 VMEM scratch and accumulates dW_hh
// and db_hh in VMEM-resident f32 output blocks at every step.
//
// Numerics, as in the TPU kernel: the gates are read in their stored type
// and widened to f32; dhp and dxp are rounded to the gates' type; the
// product dhp @ W^T takes both in the gates' type with f32 accumulation;
// dW_hh and db_hh sum the rounded dhp (and h_prev, which is ys) in f32.
//
// What bounds it on an H100: each step's product is 2*D*B*3H*H flops (805
// MFLOP at D=2, B=64, H=1024), as in the forward, and dW_hh is as many
// again over the whole sequence (252 GFLOP a layer). On the TPU dW_hh is
// read and written in VMEM every step; here a per-step read-modify-write of
// the 24 MB f32 dW_hh beside the 12-24 MB W^T would overfill the 50 MB L2,
// and blocks cannot carry a sum from one step's launch to the next.
//
// Design: two parts, both the port of _bwd_kernel.
//   1. One step kernel per scan position, launched in reverse from a host
//      loop on the caller's stream (the launch is the grid-wide barrier).
//      A block owns 32 hidden units x 32 batch rows of one direction. It
//      first forms dh for its elements from the previous launch's dhp row
//      (the full 3H contraction, staged in shared memory in 32-long chunks
//      with the next chunk's loads in flight, split over four thread parts
//      that add their sums through shared memory), then does that step's
//      gate math for the same elements and writes dxp, dhp_n and dh_tot z
//      (the f32 carry, read back by the same thread next launch). dxp and
//      dhp_n are kept for every step, so no buffer is overwritten while
//      read, and dhp's r and z thirds are not stored twice.
//   2. One contraction kernel forms dW_hh = sum over the L*B rows of
//      h_prev^T dhp, with db_hh as one extra row of ones in h_prev: a plain
//      tiled f32-FMA GEMM, 64 x 64 outputs per block, 4 x 4 per thread,
//      16-row chunks in shared memory with the next chunk in registers.
#include "common.cuh"

namespace {

// step kernel
constexpr int kUnits = 32;   // hidden units per block
constexpr int kRowsB = 32;   // batch rows per block
constexpr int kK = 32;       // contraction chunk staged in shared memory
constexpr int kLanes = 256;  // per part: 32 unit lanes x 8 row lanes
constexpr int kSplit = 4;    // parts of the 3H contraction, threadIdx.y

// contraction kernel
constexpr int kTile = 64;    // outputs per block along each side
constexpr int kR = 16;       // rows of the L*B sum staged per chunk
constexpr int kGemmThreads = 256;

__device__ __forceinline__ int time_of(int d, int s, int n_steps) {
  return d == 0 ? s : n_steps - 1 - s;
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kSplit)
    gru_bwd_step_kernel(const T* __restrict__ gates, const T* __restrict__ ys,
                        const T* __restrict__ dys, const T* __restrict__ wt,
                        T* __restrict__ dxp, T* __restrict__ dhpn,
                        float* __restrict__ dhz, int step, int n_steps,
                        int n_dirs, int batch, int hidden) {
  __shared__ __align__(16) float hs_parts[kSplit][kK][kRowsB + 4];
  __shared__ float ws_parts[kSplit][kK][kUnits];
  __shared__ float partial[kSplit - 1][kLanes][4];
  constexpr int kHLoads = kRowsB * kK / kLanes;  // 4 per thread
  constexpr int kWLoads = kK * kUnits / kLanes;  // 4 per thread
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
  const int t = time_of(d, step, n_steps);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (step < n_steps - 1) {
    // dhp of the later scan position (written by the previous launch): its
    // r and z thirds in dxp, its n third in dhpn
    const int t_next = time_of(d, step + 1, n_steps);
    const size_t row_next = ((size_t)t_next * n_dirs + d) * batch;
    const T* x_d = dxp + row_next * three_h;
    const T* n_d = dhpn + row_next * hidden;
    const T* w_d = wt + (size_t)d * three_h * hidden;
    float h_reg[kHLoads];
    float w_reg[kWLoads];
    auto load_chunk = [&](int c0) {
      const int two_h = 2 * hidden;
      if (c0 + kK <= two_h || c0 >= two_h) {
        // the chunk lies in one buffer: one base and row stride
        const bool rz = c0 < two_h;
        const T* src = rz ? x_d + c0 : n_d + (c0 - two_h);
        const int stride = rz ? three_h : hidden;
        const int width = rz ? kK : three_h - c0;  // columns before 3H
#pragma unroll
        for (int u = 0; u < kHLoads; ++u) {
          const int i = lane + u * kLanes;
          const int bb = b0 + i / kK;
          const int cc = i % kK;
          h_reg[u] = (bb < batch && cc < width)
                         ? nsd::to_f32(src[(size_t)bb * stride + cc])
                         : 0.f;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kHLoads; ++u) {
          const int i = lane + u * kLanes;
          const int bb = b0 + i / kK;
          const int c = c0 + i % kK;
          h_reg[u] = (bb < batch && c < three_h)
                         ? nsd::to_f32(c < two_h
                                           ? x_d[(size_t)bb * three_h + c]
                                           : n_d[(size_t)bb * hidden + c - two_h])
                         : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = lane + u * kLanes;
        const int j = j0 + i % kUnits;
        const int c = c0 + i / kUnits;
        w_reg[u] = (c < three_h && j < hidden)
                       ? nsd::to_f32(w_d[(size_t)c * hidden + j])
                       : 0.f;
      }
    };
    // part p sums c in [p * c_span, (p + 1) * c_span); loads past 3H are 0
    const int c_span = (three_h + kSplit * kK - 1) / (kSplit * kK) * kK;
    const int c_lo = part * c_span;
    load_chunk(c_lo);
    for (int c0 = c_lo; c0 < c_lo + c_span; c0 += kK) {
#pragma unroll
      for (int u = 0; u < kHLoads; ++u) {
        const int i = lane + u * kLanes;
        hs[i % kK][i / kK] = h_reg[u];
      }
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = lane + u * kLanes;
        ws[i / kUnits][i % kUnits] = w_reg[u];
      }
      __syncthreads();
      if (c0 + kK < c_lo + c_span) load_chunk(c0 + kK);
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[kk][4 * tb]);
        const float wv = ws[kk][tj];
        acc[0] = fmaf(hv.x, wv, acc[0]);
        acc[1] = fmaf(hv.y, wv, acc[1]);
        acc[2] = fmaf(hv.z, wv, acc[2]);
        acc[3] = fmaf(hv.w, wv, acc[3]);
      }
      __syncthreads();
    }
  }
  if (part > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) partial[part - 1][lane][i] = acc[i];
  }
  __syncthreads();
  if (part > 0) return;
#pragma unroll
  for (int p = 0; p < kSplit - 1; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += partial[p][lane][i];
  }

  const int j = j0 + tj;
  if (j >= hidden) return;
  const int t_prev = step > 0 ? time_of(d, step - 1, n_steps) : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bb = b0 + 4 * tb + i;
    if (bb >= batch) continue;
    const size_t row = ((size_t)t * n_dirs + d) * batch + bb;
    const size_t carry = ((size_t)d * batch + bb) * hidden + j;
    const float dh = step < n_steps - 1 ? dhz[carry] + acc[i] : 0.f;
    const float dh_tot = dh + nsd::to_f32(dys[row * hidden + j]);
    const T* g = gates + row * 4 * hidden;
    const float r = nsd::to_f32(g[j]);
    const float z = nsd::to_f32(g[hidden + j]);
    const float n = nsd::to_f32(g[2 * hidden + j]);
    const float hp_n = nsd::to_f32(g[3 * hidden + j]);
    const float h_prev =
        step > 0
            ? nsd::to_f32(
                  ys[(((size_t)t_prev * n_dirs + d) * batch + bb) * hidden + j])
            : 0.f;
    const float dz = dh_tot * (h_prev - n);
    const float dn = dh_tot * (1.f - z);
    const float da_n = dn * (1.f - n * n);
    const float dr = da_n * hp_n;
    const float da_z = dz * z * (1.f - z);
    const float da_r = dr * r * (1.f - r);
    const float dhp_n = da_n * r;
    T* gx = dxp + row * three_h;
    gx[j] = nsd::from_f32<T>(da_r);
    gx[hidden + j] = nsd::from_f32<T>(da_z);
    gx[2 * hidden + j] = nsd::from_f32<T>(da_n);
    dhpn[row * hidden + j] = nsd::from_f32<T>(dhp_n);
    dhz[carry] = dh_tot * z;
  }
}

// dw[d, i, c] = sum over rows (t, b) of h_prev[t, d, b, i] * dhp[t, d, b, c]
// for i < H, and db[d, c] = the same sum with h_prev replaced by 1 (i == H);
// dhp's columns [0, 2H) are dxp's, [2H, 3H) are dhpn's.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    gru_bwd_dw_kernel(const T* __restrict__ ys, const T* __restrict__ dxp,
                      const T* __restrict__ dhpn,
                      float* __restrict__ dw, float* __restrict__ db,
                      int n_steps, int n_dirs, int batch, int hidden) {
  __shared__ __align__(16) float as[kR][kTile];
  __shared__ __align__(16) float bs[kR][kTile];
  constexpr int kLoads = kR * kTile / kGemmThreads;  // 4 per operand
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns c0 + 4 tx .. + 3
  const int ty = tid / 16;  // rows    i0 + 4 ty .. + 3
  const int c0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int d = blockIdx.z;
  const int three_h = 3 * hidden;
  const int n_rows = n_steps * batch;
  // time of the first scan position, where h_prev is 0
  const int t_first = d == 0 ? 0 : n_steps - 1;

  // a tile of columns that lies in one of dxp and dhpn reads it by one base
  // and row stride, one that spans 2H element by element
  const int two_h = 2 * hidden;
  const bool one_buffer = c0 + kTile <= two_h || c0 >= two_h;
  const T* b_src = c0 < two_h ? dxp + c0 : dhpn + (c0 - two_h);
  const int b_stride = c0 < two_h ? three_h : hidden;

  float a_reg[kLoads];
  float b_reg[kLoads];
  auto load_chunk = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kGemmThreads;
      const int rr = r0 + e / kTile;
      const int col = e % kTile;
      const int t = rr / batch;
      const int bb = rr - t * batch;
      const int i = i0 + col;
      float a = 0.f;
      if (rr < n_rows && i <= hidden) {
        if (i == hidden) {
          a = 1.f;
        } else if (t != t_first) {
          const int tp = d == 0 ? t - 1 : t + 1;  // scan position s-1
          a = nsd::to_f32(
              ys[(((size_t)tp * n_dirs + d) * batch + bb) * hidden + i]);
        }
      }
      a_reg[u] = a;
      const int c = c0 + col;
      const size_t row = ((size_t)t * n_dirs + d) * batch + bb;
      float bv = 0.f;
      if (rr < n_rows && c < three_h) {
        bv = nsd::to_f32(one_buffer ? b_src[row * b_stride + col]
                         : c < two_h ? dxp[row * three_h + c]
                                     : dhpn[row * hidden + c - two_h]);
      }
      b_reg[u] = bv;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }
  load_chunk(0);
  for (int r0 = 0; r0 < n_rows; r0 += kR) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kGemmThreads;
      as[e / kTile][e % kTile] = a_reg[u];
      bs[e / kTile][e % kTile] = b_reg[u];
    }
    __syncthreads();
    if (r0 + kR < n_rows) load_chunk(r0 + kR);
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    if (i > hidden) break;
    float* out = i < hidden ? dw + ((size_t)d * hidden + i) * three_h
                            : db + (size_t)d * three_h;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + 4 * tx + b;
      if (c < three_h) out[c] = acc[a][b];
    }
  }
}

template <typename T>
cudaError_t run_bwd(const void* gates, const void* wt, const void* ys,
                    const void* dys, void* dxp, void* dhpn, void* dw, void* db,
                    void* dhz, int n_steps, int n_dirs, int batch, int hidden,
                    cudaStream_t stream) {
  if (n_steps < 1 || n_dirs < 1 || n_dirs > 2 || batch < 1 || hidden < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((hidden + kUnits - 1) / kUnits, n_dirs,
                  (batch + kRowsB - 1) / kRowsB);
  for (int s = n_steps - 1; s >= 0; --s) {
    gru_bwd_step_kernel<T><<<grid, dim3(kLanes, kSplit), 0, stream>>>(
        static_cast<const T*>(gates), static_cast<const T*>(ys),
        static_cast<const T*>(dys), static_cast<const T*>(wt),
        static_cast<T*>(dxp), static_cast<T*>(dhpn), static_cast<float*>(dhz),
        s, n_steps, n_dirs, batch, hidden);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_dw((3 * hidden + kTile - 1) / kTile,
                     (hidden + 1 + kTile - 1) / kTile, n_dirs);
  gru_bwd_dw_kernel<T><<<grid_dw, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(ys), static_cast<const T*>(dxp),
      static_cast<const T*>(dhpn), static_cast<float*>(dw),
      static_cast<float*>(db), n_steps, n_dirs, batch, hidden);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nsd_gru_bwd_f32(const void* gates, const void* wt, const void* ys,
                    const void* dys, void* dxp, void* dhpn, void* dw, void* db,
                    void* dhz, int n_steps, int n_dirs, int batch, int hidden,
                    void* stream) {
  return static_cast<int>(run_bwd<float>(
      gates, wt, ys, dys, dxp, dhpn, dw, db, dhz, n_steps, n_dirs, batch,
      hidden, static_cast<cudaStream_t>(stream)));
}

int nsd_gru_bwd_bf16(const void* gates, const void* wt, const void* ys,
                     const void* dys, void* dxp, void* dhpn, void* dw,
                     void* db, void* dhz, int n_steps, int n_dirs, int batch,
                     int hidden, void* stream) {
  return static_cast<int>(run_bwd<__nv_bfloat16>(
      gates, wt, ys, dys, dxp, dhpn, dw, db, dhz, n_steps, n_dirs, batch,
      hidden, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
