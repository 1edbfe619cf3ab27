// The GRU's input-projection product and the two products of its backward,
// in one of three layouts:
//   nn: out [rows, cols] = a [rows, red] . b [red, cols] + bias   (forward)
//   nt: out [rows, cols] = a [rows, red] . b [cols, red]^T        (dX = g . W^T)
//   tn: out [rows, cols] = a [red, rows]^T . b [red, cols]        (dW = x^T . g)
// Three bodies. nsd_matmul_sm90_bf16: bfloat16 on gemm_sm90.cuh (TMA and
// wgmma), for operands whose base pointers are 16-byte aligned and whose
// contiguous extents and cols are multiples of 8 (what TMA takes);
// nsd_matmul_pipelined_f32: float32 on gemm_f32.cuh (a two-stage SIMT tile
// fed by cp.async and register prefetch), for 16-byte aligned operands whose
// contiguous extents are multiples of 4; the caller
// (ops/kernels/matmul.py::matmul_body) sends every other product to
// nsd_matmul_{f32,bf16}, the tile of gemm_tile.cuh (float32 FMAs, or bf16
// wmma with float32 accumulators).
// a, b and out share one storage type T (float32 or bfloat16); every sum is
// accumulated in float32, the float32 bias [cols] (nn only; may be null) is
// added to the float32 sum, and the result is rounded once to T. The
// transposed layouts read their operands where they lie (Tr<>), so no
// transposed copy is made. The ragged edge (rows, cols or red not a
// multiple of the tile) is masked in the tile loads and the stores. tn sums
// over the long axis (red = B*L = 20032 rows): the sm90 and the pipelined
// float32 bodies in one range per output tile; the tile body where
// gemm_splits cuts it into ranges adds their float32 partial sums in order
// (split_sum). No atomics: a rerun gives the same bits.
//
// Replaces the Pallas TPU kernel of
// neural_speech_decoder_tpu/ops/pallas/matmul.py (_make_kernel, reached
// through tiled_matmul from projection_matmul and its custom VJP). The TPU
// kernel zero-pads the rows to its (512, 2048, 512) VMEM tile and needs the
// other dims to be multiples of 128; here a block's tile is 128 x 256 (sm90)
// or 128 x 128 of the output and nothing is padded in memory.
//
// What bounds it on an H100: the operations. At the GRU baseline's shapes
// (rows, cols, red) = (20032, 6144, 2048) and its two backward layouts each
// product is 504.1 GFLOP: 0.510 ms at the bf16 tensor-core peak of 989
// TFLOP/s, 7.524 ms on float32 FMAs at 67 TFLOP/s; its bf16 bytes (82.0 MB
// of A, 25.2 MB of B, 246.1 MB of bf16 output at most) take 0.105 ms. The
// bf16 body keeps the tensor cores fed from a 4-stage TMA ring (see
// gemm_sm90.cuh); float32 stays on FMAs (wgmma's float32 is TF32, which
// would change the numbers), in two stages whose next slab is in flight
// during the FMAs (gemm_f32.cuh); the tile of gemm_tile.cuh (one stage, no
// cp.async, TMA or wgmma) stays for operands neither can read.
#include <stdint.h>

#include "common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using nsd::Mat;
using nsd::Tr;

enum Kind { kNN = 0, kNT = 1, kTN = 2 };

// out = T(acc + bias[n]) (bias may be null): the float32 bias added to the
// float32 sum, one rounding.
template <typename T>
struct BiasRound {
  const float* bias;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    out[(size_t)m * ld + n] = nsd::from_f32<T>(bias ? acc + bias[n] : acc);
  }
};

// K ranges the product is cut into: only tn sums over a long axis.
int splits_of(int kind, int rows, int cols, int red) {
  return kind == kTN ? nsd::gemm_splits(rows, cols, red) : 1;
}

template <typename T>
cudaError_t matmul(int kind, const T* a, const T* b, const float* bias, T* out, float* ws,
                   int rows, int cols, int red, cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  const BiasRound<T> store{bias, out, cols};
  if (kind == kNN)
    return nsd::gemm(bf16, rows, cols, red, 1, Mat<T, T>{a, red}, Mat<T, T>{b, cols}, store,
                     st);
  if (kind == kNT)
    return nsd::gemm(bf16, rows, cols, red, 1, Mat<T, T>{a, red}, Tr<Mat<T, T>>{{b, red}},
                     store, st);
  const Tr<Mat<T, T>> at{{a, rows}};
  const Mat<T, T> bm{b, cols};
  if (splits_of(kind, rows, cols, red) == 1)
    return nsd::gemm(bf16, rows, cols, red, 1, at, bm, store, st);
  return nsd::gemm_split_sum<T>(bf16, rows, cols, red, at, bm, ws, out, st);
}

bool bad_args(int kind, int rows, int cols, int red, const void* bias) {
  return kind < kNN || kind > kTN || rows < 1 || cols < 1 || red < 1 ||
         (bias != nullptr && kind != kNN) || (rows + nsd::kGemmTile - 1) / nsd::kGemmTile > 65535;
}

}  // namespace

extern "C" {

// Bytes of float32 workspace a product takes (the split partial sums of tn).
long long nsd_matmul_workspace(int kind, int rows, int cols, int red) {
  const int s = splits_of(kind, rows, cols, red);
  return s > 1 ? (long long)s * rows * cols * (long long)sizeof(float) : 0;
}

#define NSD_MATMUL_ENTRY(SUFFIX, T)                                                        \
  int nsd_matmul_##SUFFIX(const void* a, const void* b, const void* bias, void* out,       \
                          void* ws, int kind, int rows, int cols, int red, void* stream) { \
    if (bad_args(kind, rows, cols, red, bias))                                             \
      return static_cast<int>(cudaErrorInvalidValue);                                      \
    return static_cast<int>(matmul<T>(kind, static_cast<const T*>(a),                      \
                                      static_cast<const T*>(b),                            \
                                      static_cast<const float*>(bias), static_cast<T*>(out), \
                                      static_cast<float*>(ws), rows, cols, red,            \
                                      static_cast<cudaStream_t>(stream)));                 \
  }

NSD_MATMUL_ENTRY(f32, float)
NSD_MATMUL_ENTRY(bf16, __nv_bfloat16)

// The bf16 product on gemm_sm90.cuh (the bias, then StoreBf16), in one K
// range; the same arguments but no workspace.
int nsd_matmul_sm90_bf16(const void* a, const void* b, const void* bias, void* out, int kind,
                         int rows, int cols, int red, void* stream) {
  if (bad_args(kind, rows, cols, red, bias)) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const bf* pa = static_cast<const bf*>(a);
  const bf* pb = static_cast<const bf*>(b);
  const float* pbias = static_cast<const float*>(bias);
  bf* po = static_cast<bf*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorInvalidValue);
  const nsd::sm90::StoreBf16 store{po, cols};
  cudaError_t err;
  if (kind == kNN)
    err = nsd::sm90::gemm<false, true>(pa, pb, pbias, store, rows, cols, red, 1, st);
  else if (kind == kNT)
    err = nsd::sm90::gemm<false, false>(pa, pb, pbias, store, rows, cols, red, 1, st);
  else
    err = nsd::sm90::gemm<true, true>(pa, pb, pbias, store, rows, cols, red, 1, st);
  return static_cast<int>(err);
}

// The float32 product on gemm_f32.cuh; the same arguments as the sm90 entry.
int nsd_matmul_pipelined_f32(const void* a, const void* b, const void* bias, void* out,
                             int kind, int rows, int cols, int red, void* stream) {
  if (bad_args(kind, rows, cols, red, bias)) return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pbias = static_cast<const float*>(bias);
  float* po = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // A (k, m) and B (k, n): k-major (true) or m/n-major (false)
  if (kind == kNN)
    err = nsd::f32::gemm<false, true>(pa, red, pb, cols, pbias, po, rows, cols, red, st);
  else if (kind == kNT)
    err = nsd::f32::gemm<false, false>(pa, red, pb, red, pbias, po, rows, cols, red, st);
  else
    err = nsd::f32::gemm<true, true>(pa, rows, pb, cols, pbias, po, rows, cols, red, st);
  return static_cast<int>(err);
}

}  // extern "C"
