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
// Two bodies, as in gru_scan.cu: the step body for float32 (and the bf16
// shapes the persistent body cannot hold), the persistent body for every
// other bf16 scan; the caller (ops/kernels/gru_scan.py::scan_plan) chooses.
// Each is two parts, the recurrence and the dW_hh / db_hh contraction.
//
// Step body:
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
//
// Persistent body (bf16):
//   1. One cooperative launch walks scan positions L-1 .. 0, at most one
//      block an SM. A block owns U hidden units of one direction and holds
//      W_hh's rows of them, [U, 3H] bf16 (96 KB at U=16, H=1024), in shared
//      memory for the whole walk: they are mma's B operand of
//      dhp @ W^T restricted to its units. Each step it streams the full
//      dhp row of the later scan position, [B, 3H] bf16 (dxp's r and z
//      thirds beside dhp_n, written by all blocks of its direction before
//      the last barrier), out of L2 through a four-stage cp.async.cg ring
//      of 128-column chunks, and forms its [B, U] product on mma.sync
//      m16n8k16 (bf16 x bf16 -> float32), in two accumulator sets that
//      take the k-steps in turns (a shorter dependent chain), added in a
//      fixed order. A warp owns one 16-row tile and 8
//      units; the accumulator elements are the (row, unit) elements whose
//      gate math the same thread does next, so the f32 carry dh_tot z stays
//      in its registers, and so does the thread's share of db_hh (the
//      rounded dhp of its elements summed in step order; at the end summed
//      over the lanes and row tiles of each unit in a fixed order). The
//      next step's gates, ys and dys are loaded before the barrier. The
//      blocks of a direction meet at a counter barrier between steps
//      (release arrival, acquire wait). Per step a block reads 6*B*H bytes
//      from L2 (384 KB at B=64, H=1024): that traffic and the barrier set
//      the pace.
//   2. The dW_hh contraction on tensor cores: dW_hh[d] = sum over the rows
//      (t, b) of h_prev^T dhp, where h_prev of direction 0 at time t is
//      ys[t-1] and of direction 1 ys[t+1] (zero at the first scan
//      position), so direction 0 takes ys[0:L-1] against dhp[1:L] and
//      direction 1 ys[1:L] against dhp[0:L-1]. 252 GFLOP a layer at the
//      recipe's shapes. Where H % 256 == 0 and B divides or is divided by
//      64 (the recipe's H=1024, B=64), gemm_sm90.cuh's TMA ring and wgmma
//      (gru_bwd_dw_sm90, 128 x 256 outputs a block) read the two shifted
//      views through rank-3 tensor maps; every other shape runs the step
//      body's contraction kernel (gru_bwd_dw_kernel<bf16>, exact bf16
//      products summed in float32 on FMAs) without its db_hh row. Each
//      block sums all its rows in order (no split, no atomics).
#include "common.cuh"
#include "gemm_sm90.cuh"

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
// for i < H, and db[d, c] = the same sum with h_prev replaced by 1 (i == H;
// skipped when db is null); dhp's columns [0, 2H) are dxp's, [2H, 3H) are
// dhpn's.
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
    if (i > hidden || (i == hidden && db == nullptr)) break;
    float* out = i < hidden ? dw + ((size_t)d * hidden + i) * three_h
                            : db + (size_t)d * three_h;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + 4 * tx + b;
      if (c < three_h) out[c] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent bf16 body.

using bf16 = __nv_bfloat16;
constexpr int kKc = 128;    // columns of dhp per ring stage
constexpr int kStages = 4;  // ring stages

using nsd::round_up;

// Dynamic shared memory of the persistent recurrence: W's rows [U][3H'+8]
// (3H' = 3H rounded up to kKc) and the ring [kStages][16*ceil(B/16)][kKc+8],
// bf16.
__host__ __device__ constexpr int bwd_smem_bytes(int units, int batch, int hidden) {
  return 2 * (units * (round_up(3 * hidden, kKc) + 8) +
              kStages * round_up(batch, 16) * (kKc + 8));
}

__global__ void __launch_bounds__(256, 1)
    gru_bwd_persistent(const bf16* __restrict__ gates, const bf16* __restrict__ w,
                       const bf16* __restrict__ ys, const bf16* __restrict__ dys,
                       bf16* __restrict__ dxp, bf16* __restrict__ dhpn,
                       float* __restrict__ db, unsigned* __restrict__ sync, int n_steps,
                       int n_dirs, int batch, int hidden, int units) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_blk = (hidden + units - 1) / units;
  const int d = blockIdx.x / n_blk;
  const int j0 = (blockIdx.x % n_blk) * units;
  const int three_h = 3 * hidden, two_h = 2 * hidden;
  const int kp = round_up(three_h, kKc);
  const int ldw = kp + 8;
  const int lda = kKc + 8;
  const int rows = round_up(batch, 16);
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [U][ldw]
  bf16* ring = ws + units * ldw;                  // [kStages][rows][lda]
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;

  // ws[u][c] = W[d][j0 + u][c], zero past 3H and past the last unit; the
  // ring zero, of which the rows past B stay so
  for (int i = tid; i < units * kp; i += n_thr) {
    const int u = i / kp, c = i % kp, j = j0 + u;
    ws[u * ldw + c] = j < hidden && c < three_h ? w[((size_t)d * hidden + j) * three_h + c]
                                                : __float2bfloat16(0.f);
  }
  for (int i = tid; i < kStages * rows * lda; i += n_thr) ring[i] = __float2bfloat16(0.f);

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ug = warp % (units / 8);
  const int mt = warp / (units / 8);
  const int jj = j0 + 8 * ug + 2 * (lane % 4);  // units jj, jj+1 of the thread
  int bb[2];
  bool b_ok[2];
  for (int e = 0; e < 2; ++e) {
    bb[e] = 16 * mt + lane / 4 + 8 * e;
    b_ok[e] = jj < hidden && bb[e] < batch;
  }
  const int n_chunks = kp / kKc;
  const int pieces = kKc / 8;
  float dhz[4] = {0.f, 0.f, 0.f, 0.f};  // f32 dh_tot z of (row bb[e/2], unit jj + e%2)
  __syncthreads();

  auto pair = [](const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  };
  // a step's inputs of the thread's elements, independent of the other
  // blocks: loaded before the barrier that precedes their step
  float2 dy[2], g4[2][4], hprev[2];
  auto load_inputs = [&](int s) {
    const int t = time_of(d, s, n_steps);
    const int tp = s > 0 ? time_of(d, s - 1, n_steps) : 0;
    const float2 zero = make_float2(0.f, 0.f);
    for (int e = 0; e < 2; ++e) {
      const size_t row = ((size_t)t * n_dirs + d) * batch + bb[e];
      dy[e] = b_ok[e] ? pair(dys + row * hidden + jj) : zero;
      for (int g = 0; g < 4; ++g) {
        g4[e][g] = b_ok[e] ? pair(gates + row * 4 * hidden + g * hidden + jj) : zero;
      }
      hprev[e] = b_ok[e] && s > 0
                     ? pair(ys + (((size_t)tp * n_dirs + d) * batch + bb[e]) * hidden + jj)
                     : zero;
    }
  };
  // db_hh of the thread's units over its rows, summed in step order from
  // the rounded dhp (gates r, z, n; units jj, jj+1)
  float dbs[3][2] = {};
  load_inputs(n_steps - 1);
  for (int s = n_steps - 1; s >= 0; --s) {
    const int t = time_of(d, s, n_steps);
    // the product in kSets accumulator sets (k-steps in turns), added in a
    // fixed order after: a warp's mma chain kSets times shorter
    constexpr int kSets = 2;
    float acc[kSets][4] = {};
    if (s < n_steps - 1) {
      const size_t row_next = ((size_t)time_of(d, s + 1, n_steps) * n_dirs + d) * batch;
      const bf16* x_src = dxp + row_next * three_h;
      const bf16* n_src = dhpn + row_next * hidden;
      auto load = [&](int c) {
        bf16* dst = ring + (c % kStages) * rows * lda;
        for (int i = tid; i < batch * pieces; i += n_thr) {
          const int b = i / pieces, cc = 8 * (i % pieces), col = c * kKc + cc;
          const bf16* src = col < two_h     ? x_src + (size_t)b * three_h + col
                            : col < three_h ? n_src + (size_t)b * hidden + col - two_h
                                            : x_src;
          if (!nsd::kCutLoad) nsd::cp_async16(dst + b * lda + cc, src, col < three_h);
        }
      };
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < n_chunks) load(c);
        nsd::cp_async_commit();
      }
      for (int c = 0; c < n_chunks; ++c) {
        nsd::cp_async_wait<kStages - 2>();
        __syncthreads();
        if (c + kStages - 1 < n_chunks) load(c + kStages - 1);
        nsd::cp_async_commit();
        const bf16* a_tile = ring + (c % kStages) * rows * lda;
#pragma unroll
        for (int k = 0; k < kKc; k += 16) {
          uint32_t a[4], b[2];
          nsd::ldsm_x4(a_tile + (16 * mt + lane % 16) * lda + k + 8 * (lane / 16), a);
          nsd::ldsm_x2(ws + (8 * ug + lane % 8) * ldw + c * kKc + k + 8 * ((lane / 8) % 2), b);
          if (!nsd::kCutMma) nsd::mma(acc[(k / 16) % kSets], a, b[0], b[1]);
        }
      }
      nsd::cp_async_wait<0>();
    }
    for (int e = 0; e < 2; ++e) {
      if (!b_ok[e]) continue;
      float out[4][2];  // da_r, da_z, da_n, dhp_n of units jj, jj+1
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * e + q;
        float prod = acc[0][i];
#pragma unroll
        for (int u = 1; u < kSets; ++u) prod += acc[u][i];
        const float dh = s < n_steps - 1 ? dhz[i] + prod : 0.f;
        const float dh_tot = dh + (q ? dy[e].y : dy[e].x);
        const float r = q ? g4[e][0].y : g4[e][0].x;
        const float z = q ? g4[e][1].y : g4[e][1].x;
        const float n = q ? g4[e][2].y : g4[e][2].x;
        const float hp_n = q ? g4[e][3].y : g4[e][3].x;
        const float h_prev = q ? hprev[e].y : hprev[e].x;
        const float dz = dh_tot * (h_prev - n);
        const float dn = dh_tot * (1.f - z);
        const float da_n = dn * (1.f - n * n);
        const float dr = da_n * hp_n;
        out[1][q] = dz * z * (1.f - z);
        out[0][q] = dr * r * (1.f - r);
        out[2][q] = da_n;
        out[3][q] = da_n * r;
        dhz[i] = dh_tot * z;
      }
      const size_t row = ((size_t)t * n_dirs + d) * batch + bb[e];
      for (int g = 0; g < 3; ++g) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(out[g][0], out[g][1]);
        *reinterpret_cast<__nv_bfloat162*>(dxp + row * three_h + g * hidden + jj) = v;
      }
      const __nv_bfloat162 v_n = __floats2bfloat162_rn(out[3][0], out[3][1]);
      *reinterpret_cast<__nv_bfloat162*>(dhpn + row * hidden + jj) = v_n;
      // dhp = (da_r, da_z, dhp_n) as stored
      for (int q = 0; q < 2; ++q) {
        dbs[0][q] += nsd::round_to<bf16>(out[0][q]);
        dbs[1][q] += nsd::round_to<bf16>(out[1][q]);
        dbs[2][q] += nsd::round_to<bf16>(out[3][q]);
      }
    }
    if (s > 0) {
      load_inputs(s - 1);
      if (!nsd::kCutBarrier) nsd::group_barrier(sync + d, (unsigned)(n_steps - s) * n_blk);
    }
  }
  // db_hh: the thread's sums over the 8 lanes of its unit pair (a fixed
  // tree), then over the row tiles in order
  for (int g = 0; g < 3; ++g) {
    for (int q = 0; q < 2; ++q) {
      for (int m = 4; m < 32; m *= 2) dbs[g][q] += __shfl_xor_sync(0xffffffffu, dbs[g][q], m);
    }
  }
  __syncthreads();
  float* db_part = reinterpret_cast<float*>(ring);  // [row tiles][3][U]
  if (lane < 4) {
    for (int g = 0; g < 3; ++g) {
      for (int q = 0; q < 2; ++q) {
        db_part[(mt * 3 + g) * units + 8 * ug + 2 * lane + q] = dbs[g][q];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * units; i += n_thr) {
    const int g = i / units, j = j0 + i % units;
    if (j >= hidden) continue;
    float sum = 0.f;
    for (int m = 0; m < rows / 16; ++m) sum += db_part[(m * 3 + g) * units + i % units];
    db[(size_t)d * three_h + g * hidden + j] = sum;
  }
}

// The contraction on TMA + wgmma (gemm_sm90.cuh's pipeline, its tn
// layout): a producer warpgroup loads 64-row stages of h_prev [rows][128 of
// H] and dhp [rows][256 of 3H] through rank-3 tensor maps over the shifted
// [L-1, B, .] views of a direction (so the time offset of part 2 and the
// D-strided rows cost no copy; dhp's columns come from dxp's map below 2H and
// dhpn's above), two consumer warpgroups run m64n256k16 into float32 and
// store dW. A stage's 64 rows are (b, t) boxes: 64 rows of one step when
// B % 64 == 0, else 64 / B steps of all B rows. Each output sums its rows
// in one fixed order in one block. Takes H % 256 == 0 and B % 64 == 0 or
// 64 % B == 0; gru_bwd_dw_kernel<bf16> takes every other shape.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

namespace sm90 = nsd::sm90;

struct DwMaps {
  CUtensorMap h, dx, dn;  // h_prev, dxp's r and z thirds, dhpn
};

__global__ void __launch_bounds__(sm90::kThreads, 1)
    gru_bwd_dw_sm90(const __grid_constant__ DwMaps maps0, const __grid_constant__ DwMaps maps1,
                    float* __restrict__ dw, int hidden, int k_tiles, int b_boxes, int t_box) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = nsd::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + sm90::kStages * sm90::kStageBytes;
  const uint32_t empty = full + sm90::kStages * 8;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n0 = blockIdx.x * sm90::kBN, m0 = blockIdx.y * sm90::kBM, d = blockIdx.z;
  const DwMaps& maps = d == 0 ? maps0 : maps1;
  const int two_h = 2 * hidden, three_h = 3 * hidden;
  if (threadIdx.x == 0) {
    for (int s = 0; s < sm90::kStages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % sm90::kStages;
        if (kt >= sm90::kStages) {
          sm90::mbar_wait(empty + 8 * s, ((kt / sm90::kStages) - 1) & 1);
        }
        const uint32_t bar = full + 8 * s;
        const uint32_t a = ring + s * sm90::kStageBytes, b = a + sm90::kABytes;
        const int b0 = (kt % b_boxes) * 64, t0 = (kt / b_boxes) * t_box;
        sm90::mbar_expect_tx(bar, sm90::kStageBytes);
        tma_load3(a, &maps.h, m0, b0, t0, bar);
        tma_load3(a + sm90::kBox, &maps.h, m0 + 64, b0, t0, bar);
#pragma unroll
        for (int j = 0; j < sm90::kBN / 64; ++j) {
          const int n = n0 + 64 * j;
          if (n < two_h) {
            tma_load3(b + j * sm90::kBox, &maps.dx, n, b0, t0, bar);
          } else {
            tma_load3(b + j * sm90::kBox, &maps.dn, n - two_h, b0, t0, bar);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % sm90::kStages;
      sm90::mbar_wait(full + 8 * s, (kt / sm90::kStages) & 1);
      const uint32_t a = ring + s * sm90::kStageBytes + c * sm90::kBox;
      const uint32_t b = ring + s * sm90::kStageBytes + sm90::kABytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < sm90::kBK / 16; ++kk) {
        sm90::wgmma_m64n256k16<1, 1>(acc, sm90::smem_desc(a + kk * 2048, sm90::kBox, 1024),
                                     sm90::smem_desc(b + kk * 2048, sm90::kBox, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (tid == 0) sm90::mbar_arrive(empty + 8 * s);
    }
    // acc[4j + r]: row warp*16 + lane/4 + 8*(r/2), column 8j + 2*(lane%4) + r%2
    const int warp = tid / 32, lane = tid % 32;
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
    float* out = dw + (size_t)d * hidden * three_h;
#pragma unroll
    for (int j = 0; j < sm90::kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * three_h + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The rank-3 tensor map of a bf16 [L', B, inner] view whose rows are
// row_stride elements apart and whose steps are step_stride elements apart,
// read in boxes of [t_box][b_box][64], swizzled by 128 bytes, zero outside.
bool make_map3(CUtensorMap* map, const void* p, int inner, int batch, int steps,
               size_t row_stride, size_t step_stride, int b_box, int t_box) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(batch),
                              static_cast<cuuint64_t>(steps)};
  const cuuint64_t strides[2] = {row_stride * 2, step_stride * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(b_box), static_cast<cuuint32_t>(t_box)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the TMA + wgmma contraction takes this shape.
bool dw_sm90_takes(int n_steps, int batch, int hidden) {
  return n_steps > 1 && hidden % 256 == 0 && (batch % 64 == 0 || 64 % batch == 0) &&
         sm90::encode_tiled() != nullptr;
}

cudaError_t run_dw_sm90(const bf16* ys, const bf16* dxp, const bf16* dhpn, float* dw,
                        int n_steps, int n_dirs, int batch, int hidden, cudaStream_t stream) {
  const int b_box = batch < 64 ? batch : 64, t_box = batch < 64 ? 64 / batch : 1;
  const int b_boxes = batch < 64 ? 1 : batch / 64;
  const int steps = n_steps - 1;  // rows with a previous state
  const int k_tiles = b_boxes * ((steps + t_box - 1) / t_box);
  const size_t h = hidden;
  const size_t step_h = (size_t)n_dirs * batch * h;  // [L, D, B, H]: one time step
  DwMaps maps[2];
  for (int d = 0; d < n_dirs; ++d) {
    // direction 0 pairs ys[t-1] with dhp[t] for t = 1 .. L-1, direction 1
    // ys[t+1] with dhp[t] for t = 0 .. L-2
    const size_t t_h = d == 0 ? 0 : 1, t_g = d == 0 ? 1 : 0;
    const bf16* h_base = ys + t_h * step_h + d * batch * h;
    const bf16* x_base = dxp + t_g * 3 * step_h + d * batch * 3 * h;
    const bf16* n_base = dhpn + t_g * step_h + d * batch * h;
    if (!make_map3(&maps[d].h, h_base, hidden, batch, steps, h, step_h, b_box, t_box) ||
        !make_map3(&maps[d].dx, x_base, 2 * hidden, batch, steps, 3 * h, 3 * step_h, b_box,
                   t_box) ||
        !make_map3(&maps[d].dn, n_base, hidden, batch, steps, h, step_h, b_box, t_box)) {
      return cudaErrorInvalidValue;
    }
  }
  if (n_dirs == 1) maps[1] = maps[0];
  NSD_TRY(cudaFuncSetAttribute(gru_bwd_dw_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sm90::kSmemBytes)));
  const dim3 grid(3 * hidden / sm90::kBN, hidden / sm90::kBM, n_dirs);
  gru_bwd_dw_sm90<<<grid, sm90::kThreads, sm90::kSmemBytes, stream>>>(
      maps[0], maps[1], dw, hidden, k_tiles, b_boxes, t_box);
  return cudaGetLastError();
}

cudaError_t check_persistent(int n_dirs, int batch, int hidden, int units, int threads,
                             int smem) {
  if (n_dirs < 1 || n_dirs > 2 || batch < 1 || hidden < 8 || hidden % 8 || units < 8 ||
      units % 8 || threads != 32 * (round_up(batch, 16) / 16) * (units / 8) ||
      threads > 256 || smem != bwd_smem_bytes(units, batch, hidden)) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

cudaError_t run_dw(const void* ys, const void* dxp, const void* dhpn, void* dw, int n_steps,
                   int n_dirs, int batch, int hidden, cudaStream_t stream) {
  if (n_steps < 1 || n_dirs < 1 || n_dirs > 2 || batch < 1 || hidden < 8 || hidden % 8) {
    return cudaErrorInvalidValue;
  }
  if (dw_sm90_takes(n_steps, batch, hidden)) {
    return run_dw_sm90(static_cast<const bf16*>(ys), static_cast<const bf16*>(dxp),
                       static_cast<const bf16*>(dhpn), static_cast<float*>(dw), n_steps,
                       n_dirs, batch, hidden, stream);
  }
  const dim3 grid((3 * hidden + kTile - 1) / kTile, (hidden + kTile - 1) / kTile, n_dirs);
  gru_bwd_dw_kernel<bf16><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const bf16*>(ys), static_cast<const bf16*>(dxp),
      static_cast<const bf16*>(dhpn), static_cast<float*>(dw), nullptr, n_steps, n_dirs,
      batch, hidden);
  return cudaGetLastError();
}

cudaError_t run_bwd_persistent(const void* gates, const void* w, const void* ys,
                               const void* dys, void* dxp, void* dhpn, void* dw, void* db,
                               void* sync, int n_steps, int n_dirs, int batch, int hidden,
                               int units, int threads, int smem, cudaStream_t stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  NSD_TRY(check_persistent(n_dirs, batch, hidden, units, threads, smem));
  const void* kernel = reinterpret_cast<const void*>(&gru_bwd_persistent);
  const int blocks = n_dirs * ((hidden + units - 1) / units);
  if (nsd::coresident_blocks(kernel, threads, smem) < blocks) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  NSD_TRY(cudaMemsetAsync(sync, 0, 2 * sizeof(unsigned), stream));
  const bf16* gates_ = static_cast<const bf16*>(gates);
  const bf16* w_ = static_cast<const bf16*>(w);
  const bf16* ys_ = static_cast<const bf16*>(ys);
  const bf16* dys_ = static_cast<const bf16*>(dys);
  bf16* dxp_ = static_cast<bf16*>(dxp);
  bf16* dhpn_ = static_cast<bf16*>(dhpn);
  unsigned* sync_ = static_cast<unsigned*>(sync);
  float* db_ = static_cast<float*>(db);
  void* args[] = {&gates_, &w_, &ys_, &dys_, &dxp_, &dhpn_, &db_, &sync_,
                  &n_steps, &n_dirs, &batch, &hidden, &units};
  NSD_TRY(cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args,
                                      (size_t)smem, stream));
  return run_dw(ys, dxp, dhpn, dw, n_steps, n_dirs, batch, hidden, stream);
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

// The persistent bf16 body: the recurrence (w is W_hh [D, H, 3H] in bf16,
// not transposed), then the contraction. sync is two unsigned counters,
// zeroed here on the stream; units, threads and smem come from the caller's
// plan and are checked against the kernel's arithmetic; a grid that the card
// cannot hold at once returns cudaErrorCooperativeLaunchTooLarge.
int nsd_gru_bwd_persistent_bf16(const void* gates, const void* w, const void* ys,
                                const void* dys, void* dxp, void* dhpn, void* dw, void* db,
                                void* sync, int n_steps, int n_dirs, int batch, int hidden,
                                int units, int threads, int smem, void* stream) {
  return static_cast<int>(run_bwd_persistent(
      gates, w, ys, dys, dxp, dhpn, dw, db, sync, n_steps, n_dirs, batch, hidden, units,
      threads, smem, static_cast<cudaStream_t>(stream)));
}

// The dW_hh contraction alone (bf16 ys [L, D, B, H], dxp [L, D, B, 3H], dhpn
// [L, D, B, H] -> float32 dw [D, H, 3H]); hidden % 8 == 0.
int nsd_gru_dw_bf16(const void* ys, const void* dxp, const void* dhpn, void* dw, int n_steps,
                    int n_dirs, int batch, int hidden, void* stream) {
  return static_cast<int>(run_dw(ys, dxp, dhpn, dw, n_steps, n_dirs, batch, hidden,
                                 static_cast<cudaStream_t>(stream)));
}


}  // extern "C"
