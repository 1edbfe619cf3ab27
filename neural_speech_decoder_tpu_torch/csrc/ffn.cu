// The Conformer's half-step feed-forward module, its backward and the
// dropout masks they draw.
//
//   x [B, T, D] (float32 or bfloat16, the compute type cdt), scale, bias [D]
//   f32, W1 [D, F] cdt, b1 [F] f32, W2 [F, D] cdt, b2 [D] f32, seed [1]
//   int32; per row (b, t):
//     xn = cdt((x - mean) * rstd * scale + bias)    (float32 statistics)
//     s  = cdt(xn . W1 + b1)                          (float32 accumulation)
//     h  = cdt(s * sigmoid(s))                        (SiLU in float32 on s)
//     dropout site 0: h = keep0 ? cdt(h * cdt(1/(1-rate))) : 0
//     o  = h . W2 + b2;  dropout site 1: o = keep1 ? o * 1/(1-rate) : 0
//     out = cdt(o)
//   keep0 at (b, t, f) is uniform2d(seed, b, t, f) >= rate and keep1 at
//   (b, t, d) is uniform2d(seed, b + B, t, d) >= rate (hashrng.cuh). Site 0
//   scales by the inverse keep rate rounded to cdt, as the TPU kernel's cdt
//   multiply by a weak-typed constant does (1/0.7 -> 1.4296875 in bf16).
//   The backward takes g [B, T, D] and recomputes the forward, then
//     gm = keep1 ? g * inv : 0; db2 = sum gm; dW2 = cdt(hq^T . cdt(gm));
//     dh = cdt(gm) . W2^T, through site 0 (f32 inv); ds = dh * SiLU'(s);
//     db1 = sum ds; dW1 = cdt(xn^T . cdt(ds)); dxn = cdt(ds) . W1^T;
//     dscale = sum dxn * xhat; dbias = sum dxn; dx = the norm's backward.
//   dW1, dW2 are in cdt (the TPU kernel returns them in the cast weights'
//   type); the vector gradients are float32; dx is in x's type.
//
// Replaces the Pallas TPU kernels of
// neural_speech_decoder_tpu/ops/pallas/ffn_kernel.py: _fwd_kernel (via
// fused_ffn -> _ffn_fwd), _bwd_kernel (via _ffn_bwd) and the dropout_masks
// test hook, with their interpret-mode dropout bits (the compiled TPU path's
// hardware PRNG cannot be reproduced off the TPU).
//
// What bounds it on an H100: the operations. At B=64, T'=313, D=1024,
// F=2048 each product is 84 GFLOP: the forward has 2 (0.17 ms at the bf16
// tensor-core peak, 2.5 ms on float32 FMAs), the backward 5 (the recompute,
// dW2, dh, dW1, dxn). The TPU kernel keeps a batch row's [T, F]
// intermediate and both weights in VMEM and runs one program per row; a
// block here has 227 KB of shared memory and the card 132 SMs, so the module
// is cut at its products instead: the layer-norm statistics, the first
// product with the norm applied as its A tile is loaded and bias, SiLU and
// dropout in its epilogue (h [B*T, F] goes to device memory), the second
// product with bias and dropout in its epilogue. The backward's dW products
// (K = B*T rows) are cut into K ranges summed in a fixed order, and the
// vector gradients are column sums in a fixed order: no atomics, so a run
// repeats bit for bit (csrc/gemm_tile.cuh, csrc/rowops.cuh).
//
// Two bodies in each direction, and a third backward. The tile body (the
// float32 forward, and any shape the others cannot read) runs the products
// on gemm_tile.cuh, whose loaders apply the norm and round gm and ds to cdt
// as the tiles load. The sm90 body (bf16, D
// and F multiples of 8) runs every product on gemm_sm90.cuh's TMA ring into
// wgmma, which reads bf16 arrays where they lie and applies nothing as it
// loads: so each operand is written once as the bf16 array the loader would
// have given, the same bits (xn = cdt(LN(x)) by a row pass beside the norm's
// statistics, gq = cdt(gm) beside the float32 gm that db2 sums, dsq =
// cdt(ds) beside the float32 ds that db1 sums; 41-82 MB each at the
// recipe's shapes, against 168 GFLOP of forward and 420 of backward
// products). Both sm90 directions share the front, ffn_front_sm90 (xn, s
// and the dropped h); the forward's second product stores bias + one
// rounding at rate 0 and float32 sums for a dropout pass otherwise. The dW
// products take the K-range counts of the caller's plan
// (ops/kernels/ffn.py::bwd_plan), their partial sums added in order.
//
// The f32 backward (float32, D and F multiples of 4) is the sm90 body's
// stages with every product on gemm_f32.cuh's pipelined FP32 FMA tile (two
// cp.async stages, 8 x 8 outputs a thread; no TF32, which would change the
// numbers), which reads float32 arrays where they lie: xn = LN(x) written
// once by a row pass (LnLoad's values, 82 MB at the recipe), s with b1 in
// the tile's store, h by a pass; cdt being float32, gm and ds are the
// products' operands as they are (no copies); the element math (SiLU,
// dropout site 0, SiLU') in the sm90 body's passes, 4 columns a thread.
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

struct Shape {
  int b, t, d, f;
  float rate, inv, inv_h;  // inv_h: the inverse keep rate rounded to cdt
  __host__ __device__ int m() const { return b * t; }
};

__device__ __forceinline__ bool keep(const int32_t* seed, int salt, int row, int col,
                                     float rate) {
  return nsd::hash_uniform(*seed, salt, row, col) >= rate;
}

// The first product's epilogue: s = cdt(acc + b1), h = cdt(SiLU(s)), dropout
// site 0; stores h (and, in the backward's recompute, s).
template <typename T>
struct Lin1Epi {
  const float* b1;
  const int32_t* seed;
  T* h;
  T* s_out;
  int n_time, ld;
  float rate, inv_h;
  // h of element (m, n) from its rounded pre-activation s
  __device__ __forceinline__ float h_of(int m, int n, float s) const {
    float hv = nsd::round_to<T>(s * nsd::sigmoid(s));
    if (rate > 0.f) {
      const int bb = m / n_time;
      hv = keep(seed, bb, m - bb * n_time, n, rate) ? nsd::round_to<T>(hv * inv_h) : 0.f;
    }
    return hv;
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    const float s = nsd::round_to<T>(acc + b1[n]);
    h[(size_t)m * ld + n] = nsd::from_f32<T>(h_of(m, n, s));
    if (s_out) s_out[(size_t)m * ld + n] = nsd::from_f32<T>(s);
  }
};

// The second product's epilogue: o = acc + b2, dropout site 1, out = cdt(o).
template <typename T>
struct Lin2Epi {
  const float* b2;
  const int32_t* seed;
  T* out;
  int n_time, batch, ld;
  float rate, inv;
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    float o = acc + b2[n];
    if (rate > 0.f) {
      const int bb = m / n_time;
      o = keep(seed, bb + batch, m - bb * n_time, n, rate) ? o * inv : 0.f;
    }
    out[(size_t)m * ld + n] = nsd::from_f32<T>(o);
  }
};

// dh = acc through dropout site 0 (float32 inv), then ds = dh * SiLU'(s)
// with s the rounded pre-activation; stored in float32.
template <typename T>
struct DsEpi {
  const T* s;
  const int32_t* seed;
  float* ds;
  int n_time, ld;
  float rate, inv;
  // ds of element (m, n) from dh = acc and the rounded pre-activation sc
  __device__ __forceinline__ float value(int m, int n, float acc, float sc) const {
    float dh = acc;
    if (rate > 0.f) {
      const int bb = m / n_time;
      dh = keep(seed, bb, m - bb * n_time, n, rate) ? dh * inv : 0.f;
    }
    const float sig = nsd::sigmoid(sc);
    return dh * sig * (1.f + sc * (1.f - sig));
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc, int) const {
    ds[(size_t)m * ld + n] = value(m, n, acc, nsd::to_f32(s[(size_t)m * ld + n]));
  }
};

// The operand bodies (sm90, f32) keep their products' epilogues to plain
// stores (an sm90 epilogue runs on the two consumer warpgroups of one block
// an SM, behind the main loop, where SiLU, the dropout hash and the loads of
// s cost more than the product) and apply Lin1Epi's and DsEpi's element
// math in passes over the stored arrays at full occupancy, 16 bytes of T a
// thread (nsd::each_cols: 8 bf16 or 4 float32 columns).

// h = Lin1Epi's h of the stored s.
template <typename T>
struct SiluDropPass {
  static constexpr int kCols = 16 / sizeof(T);
  Lin1Epi<T> e;
  __device__ __forceinline__ void operator()(int m, int n) const {
    const size_t i = (size_t)m * e.ld + n;
    float v[kCols];
    nsd::load_raw<kCols>(e.s_out + i, v);
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = e.h_of(m, n + k, v[k]);
    nsd::store_raw<kCols>(e.h + i, v);
  }
};

// ds = DsEpi's ds of the stored dh (in place in e.ds), and in bf16 dsq =
// cdt(ds) (float32's cdt(ds) is ds itself).
template <typename T>
struct DsPass {
  static constexpr int kCols = 16 / sizeof(T);
  DsEpi<T> e;
  T* dsq;
  __device__ __forceinline__ void operator()(int m, int n) const {
    const size_t i = (size_t)m * e.ld + n;
    float v[kCols], sv[kCols];
    nsd::load_raw<kCols>(e.ds + i, v);
    nsd::load_raw<kCols>(e.s + i, sv);
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = e.value(m, n + k, v[k], sv[k]);
    nsd::store_raw<kCols>(e.ds + i, v);
    if constexpr (sizeof(T) == 2) nsd::store_raw<kCols>(dsq + i, v);
  }
};

// The pieces of the workspace (pointers from base, or sizes from nullptr).
// splits: the sm90 or f32 backward's larger dW range count, 1 for the sm90
// forward, or 0 for the tile body.
template <typename T>
struct Work {
  float2* stats;
  T* h;       // the dropped h that W2 multiplies
  T* s;       // sm90 and backward: the rounded pre-activation
  float* gm;  // backward: g through site 1; later dxn
  float* ds;
  float* split;
  float* part;
  float* o;          // the sm90 forward: h . W2 + b2 in float32 (rate > 0)
  T *xn, *gq, *dsq;  // the operand bodies' cdt(LN(x)); the sm90 backward's cdt(gm), cdt(ds)
  size_t bytes;
  Work(const Shape& p, bool bwd, char* base, int splits = 0) {
    Carve c;
    c.base = base;
    const size_t m = p.m();
    stats = c.take<float2>(m);
    h = c.take<T>(m * p.f);
    s = nullptr;
    gm = ds = split = part = o = nullptr;
    xn = gq = dsq = nullptr;
    if (!bwd && splits > 0) {
      xn = c.take<T>(m * p.d);
      s = c.take<T>(m * p.f);
      o = c.take<float>(m * p.d);
    }
    if (bwd) {
      s = c.take<T>(m * p.f);
      gm = c.take<float>(m * p.d);
      ds = c.take<float>(m * p.f);
      const int tile = nsd::gemm_splits(p.d, p.f, p.m()) > nsd::gemm_splits(p.f, p.d, p.m())
                           ? nsd::gemm_splits(p.d, p.f, p.m())
                           : nsd::gemm_splits(p.f, p.d, p.m());
      const int sp = splits > 0 ? (splits > 1 ? splits : 0) : tile;
      split = c.take<float>((size_t)sp * p.d * p.f);
      part = c.take<float>((size_t)nsd::kColChunks * (p.f > p.d ? p.f : p.d));
      if (splits > 0) {
        xn = c.take<T>(m * p.d);
        if (sizeof(T) == 2) {  // float32's are gm and ds themselves
          gq = c.take<T>(m * p.d);
          dsq = c.take<T>(m * p.f);
        }
      }
    }
    bytes = c.off;
  }
};

template <typename T>
cudaError_t ffn_fwd(const T* x, const float* scale, const float* bias, const T* w1,
                    const float* b1, const T* w2, const float* b2, const int32_t* seed,
                    T* out, char* ws, const Shape& p, cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  Work<T> w(p, false, ws);
  const int M = p.m();
  NSD_TRY(nsd::ln_stats(x, w.stats, M, p.d, st));
  NSD_TRY(nsd::gemm(bf16, M, p.f, p.d, 1, LnLoad<T>{x, w.stats, scale, bias, p.d},
                    Mat<T, T>{w1, p.f},
                    Lin1Epi<T>{b1, seed, w.h, nullptr, p.t, p.f, p.rate, p.inv_h}, st));
  return nsd::gemm(bf16, M, p.d, p.f, 1, Mat<T, T>{w.h, p.f}, Mat<T, T>{w2, p.d},
                   Lin2Epi<T>{b2, seed, out, p.t, p.b, p.d, p.rate, p.inv}, st);
}

template <typename T>
cudaError_t ffn_bwd(const T* x, const float* scale, const float* bias, const T* w1,
                    const float* b1, const T* w2, const int32_t* seed, const T* g, T* dx,
                    float* dscale, float* dbias, T* dw1, float* db1, T* dw2, float* db2,
                    char* ws, const Shape& p, cudaStream_t st) {
  constexpr bool bf16 = sizeof(T) == 2;
  Work<T> w(p, true, ws);
  const int M = p.m();
  const LnLoad<T> xn{x, w.stats, scale, bias, p.d};
  // the forward again, keeping s and the dropped h
  NSD_TRY(nsd::ln_stats(x, w.stats, M, p.d, st));
  NSD_TRY(nsd::gemm(bf16, M, p.f, p.d, 1, xn, Mat<T, T>{w1, p.f},
                    Lin1Epi<T>{b1, seed, w.h, w.s, p.t, p.f, p.rate, p.inv_h}, st));
  // through the output dropout; db2, dW2 = hq^T . cdt(gm)
  NSD_TRY(nsd::mask_grad(g, seed, w.gm, static_cast<T*>(nullptr), p.b, p.t, p.d, p.b,
                         p.rate, p.inv, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.gm, p.d}, w.part, db2, M, p.d, st));
  const Mat<float, T> gq{w.gm, p.d};
  NSD_TRY(nsd::gemm_split_sum<T>(bf16, p.f, p.d, M, Tr<Mat<T, T>>{{w.h, p.f}}, gq,
                                 w.split, dw2, st));
  // dh = cdt(gm) . W2^T -> ds; db1; dW1 = xn^T . cdt(ds)
  NSD_TRY(nsd::gemm(bf16, M, p.f, p.d, 1, gq, Tr<Mat<T, T>>{{w2, p.d}},
                    DsEpi<T>{w.s, seed, w.ds, p.t, p.f, p.rate, p.inv}, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.ds, p.f}, w.part, db1, M, p.f, st));
  const Mat<float, T> dsq{w.ds, p.f};
  NSD_TRY(nsd::gemm_split_sum<T>(bf16, p.d, p.f, M, Tr<LnLoad<T>>{xn}, dsq, w.split, dw1,
                                 st));
  // dxn = cdt(ds) . W1^T (into gm's room), then the norm's backward
  float* dxn = w.gm;
  NSD_TRY(nsd::gemm(bf16, M, p.d, p.f, 1, dsq, Tr<Mat<T, T>>{{w1, p.f}},
                    nsd::StoreF32{dxn, p.d}, st));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<T>{dxn, x, w.stats, p.d}, w.part, dscale, M, p.d,
                      st));
  NSD_TRY(nsd::colsum(nsd::Elem{dxn, p.d}, w.part, dbias, M, p.d, st));
  return nsd::ln_bwd(dxn, x, w.stats, scale, dx, M, p.d, st);
}

// The front of both sm90 bodies (bf16): xn = cdt(LN(x)) by a row pass, s =
// cdt(xn . W1 + b1) on gemm_sm90.cuh (bias + one rounding in its store), and
// h = cdt(SiLU(s)) through dropout site 0 by a pass (Lin1Epi's values).
cudaError_t ffn_front_sm90(const bf16* x, const float* scale, const float* bias,
                           const bf16* w1, const float* b1, const int32_t* seed,
                           const Work<bf16>& w, const Shape& p, cudaStream_t st) {
  const int M = p.m();
  NSD_TRY((nsd::ln_apply<bf16, false>(x, w.stats, scale, bias, w.xn, M, p.d, st)));
  NSD_TRY((sm90::gemm<false, true>(w.xn, w1, b1, sm90::StoreBf16{w.s, p.f}, M, p.f, p.d, 1,
                                   st)));
  const Lin1Epi<bf16> lin1{b1, seed, w.h, w.s, p.t, p.f, p.rate, p.inv_h};
  return nsd::each_cols(SiluDropPass<bf16>{lin1}, M, p.f, st);
}

// The forward's sm90 body (bf16): the front, then o = h . W2 + b2 on
// gemm_sm90.cuh. At rate 0 the product's store adds the bias and rounds once
// (Lin2Epi's value); otherwise it stores o in float32 and a pass applies
// dropout site 1 and rounds (the hash in an epilogue would run on one block
// an SM behind the main loop).
cudaError_t ffn_fwd_sm90(const bf16* x, const float* scale, const float* bias, const bf16* w1,
                         const float* b1, const bf16* w2, const float* b2, const int32_t* seed,
                         bf16* out, char* ws, const Shape& p, cudaStream_t st) {
  Work<bf16> w(p, false, ws, 1);
  const int M = p.m();
  NSD_TRY(ffn_front_sm90(x, scale, bias, w1, b1, seed, w, p, st));
  if (p.rate <= 0.f)
    return sm90::gemm<false, true>(w.h, w2, b2, sm90::StoreBf16{out, p.d}, M, p.d, p.f, 1, st);
  NSD_TRY((sm90::gemm<false, true>(w.h, w2, b2, nsd::StoreF32{w.o, p.d}, M, p.d, p.f, 1, st)));
  return nsd::each_cols(nsd::DropRoundPass{w.o, seed, out, p.t, p.b, p.d, p.rate, p.inv}, M,
                        p.d, st);
}

// The backward's sm90 body (bf16): ffn_bwd's stages, every product on
// gemm_sm90.cuh reading bf16 operands written once (see the header); s2 and
// s1 are the K ranges of dW2 and dW1.
cudaError_t ffn_bwd_sm90(const bf16* x, const float* scale, const float* bias, const bf16* w1,
                         const float* b1, const bf16* w2, const int32_t* seed, const bf16* g,
                         bf16* dx, float* dscale, float* dbias, bf16* dw1, float* db1,
                         bf16* dw2, float* db2, char* ws, const Shape& p, int s2, int s1,
                         cudaStream_t st) {
  Work<bf16> w(p, true, ws, s2 > s1 ? s2 : s1);
  const int M = p.m();
  // the forward again, keeping xn, s and the dropped h
  NSD_TRY(ffn_front_sm90(x, scale, bias, w1, b1, seed, w, p, st));
  // through the output dropout (gm, and gq = cdt(gm)); db2; dW2 = hq^T . gq
  NSD_TRY(nsd::mask_grad(g, seed, w.gm, w.gq, p.b, p.t, p.d, p.b, p.rate, p.inv, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.gm, p.d}, w.part, db2, M, p.d, st));
  NSD_TRY(sm90::gemm_tn_split(w.h, w.gq, dw2, p.f, p.d, M, s2, w.split, st));
  // dh = gq . W2^T (into ds's room) -> ds and dsq = cdt(ds); db1; dW1 = xn^T . dsq
  NSD_TRY((sm90::gemm<false, false>(w.gq, w2, nullptr, nsd::StoreF32{w.ds, p.f}, M, p.f, p.d,
                                    1, st)));
  NSD_TRY(nsd::each_cols(DsPass<bf16>{{w.s, seed, w.ds, p.t, p.f, p.rate, p.inv}, w.dsq}, M, p.f,
                         st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.ds, p.f}, w.part, db1, M, p.f, st));
  NSD_TRY(sm90::gemm_tn_split(w.xn, w.dsq, dw1, p.d, p.f, M, s1, w.split, st));
  // dxn = dsq . W1^T (into gm's room), then the norm's backward
  float* dxn = w.gm;
  NSD_TRY((sm90::gemm<false, false>(w.dsq, w1, nullptr, nsd::StoreF32{dxn, p.d}, M, p.d, p.f,
                                    1, st)));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<bf16>{dxn, x, w.stats, p.d}, w.part, dscale, M, p.d,
                      st));
  NSD_TRY(nsd::colsum(nsd::Elem{dxn, p.d}, w.part, dbias, M, p.d, st));
  return nsd::ln_bwd(dxn, x, w.stats, scale, dx, M, p.d, st);
}

// The backward's f32 body (float32): ffn_bwd's stages, every product on
// gemm_f32.cuh reading float32 arrays where they lie (see the header); s2
// and s1 are the K ranges of dW2 and dW1.
cudaError_t ffn_bwd_f32(const float* x, const float* scale, const float* bias, const float* w1,
                        const float* b1, const float* w2, const int32_t* seed, const float* g,
                        float* dx, float* dscale, float* dbias, float* dw1, float* db1,
                        float* dw2, float* db2, char* ws, const Shape& p, int s2, int s1,
                        cudaStream_t st) {
  Work<float> w(p, true, ws, s2 > s1 ? s2 : s1);
  const int M = p.m(), D = p.d, F = p.f;
  // the forward again: xn by a row pass, s = xn . W1 + b1 (nn), h by a pass
  NSD_TRY((nsd::ln_apply<float, false>(x, w.stats, scale, bias, w.xn, M, D, st)));
  NSD_TRY((f32::gemm<false, true>(w.xn, D, w1, F, b1, w.s, M, F, D, st)));
  const Lin1Epi<float> lin1{b1, seed, w.h, w.s, p.t, F, p.rate, p.inv_h};
  NSD_TRY(nsd::each_cols(SiluDropPass<float>{lin1}, M, F, st));
  // through the output dropout; db2; dW2 = h^T . gm (tn)
  NSD_TRY(nsd::mask_grad(g, seed, w.gm, static_cast<float*>(nullptr), p.b, p.t, D, p.b, p.rate,
                         p.inv, st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.gm, D}, w.part, db2, M, D, st));
  NSD_TRY(f32::gemm_tn_split(w.h, w.gm, dw2, F, D, M, s2, w.split, st));
  // dh = gm . W2^T (nt, into ds's room) -> ds; db1; dW1 = xn^T . ds (tn)
  NSD_TRY((f32::gemm<false, false>(w.gm, D, w2, D, nullptr, w.ds, M, F, D, st)));
  NSD_TRY(nsd::each_cols(DsPass<float>{{w.s, seed, w.ds, p.t, F, p.rate, p.inv}, nullptr}, M, F,
                         st));
  NSD_TRY(nsd::colsum(nsd::Elem{w.ds, F}, w.part, db1, M, F, st));
  NSD_TRY(f32::gemm_tn_split(w.xn, w.ds, dw1, D, F, M, s1, w.split, st));
  // dxn = ds . W1^T (nt, into gm's room), then the norm's backward
  float* dxn = w.gm;
  NSD_TRY((f32::gemm<false, false>(w.ds, F, w1, F, nullptr, dxn, M, D, F, st)));
  NSD_TRY(nsd::colsum(nsd::ElemTimesXhat<float>{dxn, x, w.stats, D}, w.part, dscale, M, D,
                      st));
  NSD_TRY(nsd::colsum(nsd::Elem{dxn, D}, w.part, dbias, M, D, st));
  return nsd::ln_bwd(dxn, x, w.stats, scale, dx, M, D, st);
}

__global__ void ffn_masks_kernel(const int32_t* __restrict__ seed, uint8_t* __restrict__ m1,
                                 uint8_t* __restrict__ m2, int batch, int n_time, int d,
                                 int f, float rate) {
  const size_t n1 = (size_t)batch * n_time * f, n2 = (size_t)batch * n_time * d;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n1 + n2;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool first = i < n1;
    const size_t j = first ? i : i - n1;
    const int w = first ? f : d;
    const int col = j % w;
    const int m = j / w;
    const int bb = m / n_time;
    const uint8_t k = keep(seed, first ? bb : bb + batch, m - bb * n_time, col, rate);
    (first ? m1 : m2)[j] = k;
  }
}

bool bad_shape(int b, int t, int d, int f) { return b < 1 || t < 1 || d < 1 || f < 1; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Shape make_shape(int b, int t, int d, int f, float rate, float inv, float inv_h) {
  Shape p;
  p.b = b;
  p.t = t;
  p.d = d;
  p.f = f;
  p.rate = rate;
  p.inv = inv;
  p.inv_h = inv_h;
  return p;
}

}  // namespace

extern "C" {

// Bytes of workspace the forward (bwd = 0) or backward (bwd = 1) takes.
long long nsd_ffn_workspace(int b, int t, int d, int f, int bf16, int bwd) {
  const Shape p = make_shape(b, t, d, f, 0.f, 1.f, 1.f);
  return static_cast<long long>(bf16 ? Work<__nv_bfloat16>(p, bwd, nullptr).bytes
                                     : Work<float>(p, bwd, nullptr).bytes);
}

#define NSD_FFN_ENTRIES(SUFFIX, T)                                                     \
  int nsd_ffn_fwd_##SUFFIX(const void* x, const void* scale, const void* bias,         \
                           const void* w1, const void* b1, const void* w2,             \
                           const void* b2, const void* seed, void* out, void* ws,      \
                           int b, int t, int d, int f, float rate, float inv,          \
                           float inv_h, void* stream) {                                \
    if (bad_shape(b, t, d, f)) return static_cast<int>(cudaErrorInvalidValue);         \
    return static_cast<int>(ffn_fwd<T>(                                                \
        static_cast<const T*>(x), static_cast<const float*>(scale),                    \
        static_cast<const float*>(bias), static_cast<const T*>(w1),                    \
        static_cast<const float*>(b1), static_cast<const T*>(w2),                      \
        static_cast<const float*>(b2), static_cast<const int32_t*>(seed),              \
        static_cast<T*>(out), static_cast<char*>(ws),                                  \
        make_shape(b, t, d, f, rate, inv, inv_h), static_cast<cudaStream_t>(stream))); \
  }                                                                                    \
  int nsd_ffn_bwd_##SUFFIX(const void* x, const void* scale, const void* bias,         \
                           const void* w1, const void* b1, const void* w2,             \
                           const void* seed, const void* g, void* dx, void* dscale,    \
                           void* dbias, void* dw1, void* db1, void* dw2, void* db2,    \
                           void* ws, int b, int t, int d, int f, float rate,           \
                           float inv, float inv_h, void* stream) {                     \
    if (bad_shape(b, t, d, f)) return static_cast<int>(cudaErrorInvalidValue);         \
    return static_cast<int>(ffn_bwd<T>(                                                \
        static_cast<const T*>(x), static_cast<const float*>(scale),                    \
        static_cast<const float*>(bias), static_cast<const T*>(w1),                    \
        static_cast<const float*>(b1), static_cast<const T*>(w2),                      \
        static_cast<const int32_t*>(seed), static_cast<const T*>(g),                   \
        static_cast<T*>(dx), static_cast<float*>(dscale), static_cast<float*>(dbias),  \
        static_cast<T*>(dw1), static_cast<float*>(db1), static_cast<T*>(dw2),          \
        static_cast<float*>(db2), static_cast<char*>(ws),                              \
        make_shape(b, t, d, f, rate, inv, inv_h), static_cast<cudaStream_t>(stream))); \
  }

NSD_FFN_ENTRIES(tile_f32, float)
NSD_FFN_ENTRIES(tile_bf16, __nv_bfloat16)

// Bytes of workspace the sm90 forward takes.
long long nsd_ffn_fwd_sm90_workspace(int b, int t, int d, int f) {
  const Shape p = make_shape(b, t, d, f, 0.f, 1.f, 1.f);
  return static_cast<long long>(Work<bf16>(p, false, nullptr, 1).bytes);
}

// The bf16 forward on gemm_sm90.cuh: nsd_ffn_fwd_tile_bf16's arguments. D
// and F multiples of 8, x, W1, W2 and out 16-byte aligned:
// cudaErrorInvalidValue otherwise.
int nsd_ffn_fwd_sm90(const void* x, const void* scale, const void* bias, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* seed,
                     void* out, void* ws, int b, int t, int d, int f, float rate, float inv,
                     float inv_h, void* stream) {
  if (bad_shape(b, t, d, f) || d % 8 || f % 8 || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn_fwd_sm90(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const int32_t*>(seed), static_cast<bf16*>(out),
      static_cast<char*>(ws), make_shape(b, t, d, f, rate, inv, inv_h),
      static_cast<cudaStream_t>(stream)));
}

// Bytes of workspace the sm90 backward takes with s2 and s1 K ranges.
long long nsd_ffn_bwd_sm90_workspace(int b, int t, int d, int f, int s2, int s1) {
  const Shape p = make_shape(b, t, d, f, 0.f, 1.f, 1.f);
  return static_cast<long long>(Work<bf16>(p, true, nullptr, s2 > s1 ? s2 : s1).bytes);
}

// The bf16 backward on gemm_sm90.cuh: nsd_ffn_bwd_tile_bf16's arguments,
// and the K ranges of dW2 (s2) and dW1 (s1). D and F multiples of 8, W1 and
// W2 16-byte aligned: cudaErrorInvalidValue otherwise.
int nsd_ffn_bwd_sm90(const void* x, const void* scale, const void* bias, const void* w1,
                     const void* b1, const void* w2, const void* seed, const void* g, void* dx,
                     void* dscale, void* dbias, void* dw1, void* db1, void* dw2, void* db2,
                     void* ws, int b, int t, int d, int f, int s2, int s1, float rate,
                     float inv, float inv_h, void* stream) {
  if (bad_shape(b, t, d, f) || d % 8 || f % 8 || s2 < 1 || s1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn_bwd_sm90(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const int32_t*>(seed), static_cast<const bf16*>(g), static_cast<bf16*>(dx),
      static_cast<float*>(dscale), static_cast<float*>(dbias), static_cast<bf16*>(dw1),
      static_cast<float*>(db1), static_cast<bf16*>(dw2), static_cast<float*>(db2),
      static_cast<char*>(ws), make_shape(b, t, d, f, rate, inv, inv_h), s2, s1,
      static_cast<cudaStream_t>(stream)));
}

// Bytes of workspace the f32 backward takes with s2 and s1 K ranges.
long long nsd_ffn_bwd_f32_workspace(int b, int t, int d, int f, int s2, int s1) {
  const Shape p = make_shape(b, t, d, f, 0.f, 1.f, 1.f);
  return static_cast<long long>(Work<float>(p, true, nullptr, s2 > s1 ? s2 : s1).bytes);
}

// The float32 backward on gemm_f32.cuh: nsd_ffn_bwd_tile_f32's arguments,
// and the K ranges of dW2 (s2) and dW1 (s1). D and F multiples of 4, W1,
// W2, dW1 and dW2 16-byte aligned: cudaErrorInvalidValue otherwise.
int nsd_ffn_bwd_f32(const void* x, const void* scale, const void* bias, const void* w1,
                    const void* b1, const void* w2, const void* seed, const void* g,
                    void* dx, void* dscale, void* dbias, void* dw1, void* db1, void* dw2,
                    void* db2, void* ws, int b, int t, int d, int f, int s2, int s1,
                    float rate, float inv, float inv_h, void* stream) {
  if (bad_shape(b, t, d, f) || d % 4 || f % 4 || s2 < 1 || s1 < 1 || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(dw1) || !aligned16(dw2))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn_bwd_f32(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const int32_t*>(seed), static_cast<const float*>(g), static_cast<float*>(dx),
      static_cast<float*>(dscale), static_cast<float*>(dbias), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2),
      static_cast<char*>(ws), make_shape(b, t, d, f, rate, inv, inv_h), s2, s1,
      static_cast<cudaStream_t>(stream)));
}

int nsd_ffn_dropout_masks(const void* seed, void* m1, void* m2, int b, int t, int d, int f,
                          float rate, void* stream) {
  if (bad_shape(b, t, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t want = ((size_t)b * t * (d + f) + 255) / 256;
  ffn_masks_kernel<<<(unsigned)(want < 65535 ? want : 65535), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seed), static_cast<uint8_t*>(m1),
      static_cast<uint8_t*>(m2), b, t, d, f, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
