// Adam with L2 (torch.optim.Adam's weight_decay) over many float32 leaves in
// one launch, updating p, m and v in place:
//   g' = g + l2 * p
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + (1 - b2) * g' * g'
//   p' = p - lr * (m' * c1) / (sqrt(v' * c2) + eps)       (eps outside the sqrt)
// with c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t) for the update's count t,
// computed by the caller in float32. Every operation is rounded once, in the
// order written (the _rn intrinsics keep the compiler from contracting a
// product and a sum into an FMA), so the kernel gives the plain PyTorch
// version's numbers.
//
// Replaces the Pallas TPU kernel of
// neural_speech_decoder_tpu/ops/pallas/adam_kernel.py (_kernel, reached
// through adam_leaf from fused_adam_update), which runs one launch per leaf
// over [rows, 128] blocks and leaves a leaf whose size is not a multiple of
// 128 to the jnp twin. Here every leaf, of any size, takes the kernel.
//
// What bounds it on an H100: the bytes. Each element reads g, p, m, v and
// writes p, m, v once: 28 bytes for ~15 float32 operations. The GRU
// baseline's 133,845,033 parameters move 3.748 GB, 1.119 ms at 3.35 TB/s.
// The design: one launch for up to kMaxLeaves leaves, whose pointers and
// sizes travel by value in the kernel's parameters (the caller's .grad
// storage is new every step, so no table is kept on the device); each block
// takes 4096 consecutive elements of one leaf, each thread four 16-byte
// loads per array where the leaf's four pointers are 16-byte aligned, and
// element by element at a leaf's ragged end or where they are not.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 48;
constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kBlockElems = (long long)kThreads * kVecPerThread * 4;

struct Leaves {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];  // leaf k owns blocks [start[k], start[k+1])
  int vec[kMaxLeaves];              // 1 where all four pointers are 16-byte aligned
  int count;
};

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, l2;  // omb = 1 - b, rounded to float
};

__device__ __forceinline__ void adam1(float g, float& p, float& m, float& v, const Hyper& h) {
  g = __fadd_rn(g, __fmul_rn(h.l2, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.c2)), h.eps);
  p = __fsub_rn(p, __fmul_rn(h.lr, __fdiv_rn(__fmul_rn(m, h.c1), den)));
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const Leaves L, const Hyper h) {
  // this block's leaf (uniform over the block)
  int k = 0;
  while (k + 1 < L.count && L.block_start[k + 1] <= (int)blockIdx.x) ++k;
  const long long n = L.n[k];
  const long long base = (long long)(blockIdx.x - L.block_start[k]) * kBlockElems;
  const float* g = L.g[k];
  float *p = L.p[k], *m = L.m[k], *v = L.v[k];
  if (L.vec[k]) {
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const long long e = base + ((long long)i * kThreads + threadIdx.x) * 4;
      if (e + 4 <= n) {
        const float4 g4 = *reinterpret_cast<const float4*>(g + e);
        float4 p4 = *reinterpret_cast<const float4*>(p + e);
        float4 m4 = *reinterpret_cast<const float4*>(m + e);
        float4 v4 = *reinterpret_cast<const float4*>(v + e);
        adam1(g4.x, p4.x, m4.x, v4.x, h);
        adam1(g4.y, p4.y, m4.y, v4.y, h);
        adam1(g4.z, p4.z, m4.z, v4.z, h);
        adam1(g4.w, p4.w, m4.w, v4.w, h);
        *reinterpret_cast<float4*>(p + e) = p4;
        *reinterpret_cast<float4*>(m + e) = m4;
        *reinterpret_cast<float4*>(v + e) = v4;
      } else {
        for (long long j = e; j < n; ++j) adam1(g[j], p[j], m[j], v[j], h);
      }
    }
  } else {
    const long long end = base + kBlockElems < n ? base + kBlockElems : n;
    for (long long j = base + threadIdx.x; j < end; j += kThreads)
      adam1(g[j], p[j], m[j], v[j], h);
  }
}

bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

}  // namespace

extern "C" {

// The most leaves one launch takes (the caller cuts longer lists).
int nsd_adam_max_leaves() { return kMaxLeaves; }

// One launch over `count` (1..kMaxLeaves) leaves: g[i], p[i], m[i], v[i]
// point to n[i] > 0 float32 elements each; p, m, v are updated in place.
int nsd_adam_f32(const void* const* g, void* const* p, void* const* m, void* const* v,
                 const long long* n, int count, float lr, float c1, float c2, float b1,
                 float omb1, float b2, float omb2, float eps, float l2, void* stream) {
  if (count < 1 || count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Leaves L;
  L.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    L.g[i] = static_cast<const float*>(g[i]);
    L.p[i] = static_cast<float*>(p[i]);
    L.m[i] = static_cast<float*>(m[i]);
    L.v[i] = static_cast<float*>(v[i]);
    L.n[i] = n[i];
    L.vec[i] = aligned16(g[i]) && aligned16(p[i]) && aligned16(m[i]) && aligned16(v[i]);
    L.block_start[i] = static_cast<int>(blocks);
    blocks += (n[i] + kBlockElems - 1) / kBlockElems;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  L.block_start[count] = static_cast<int>(blocks);
  const Hyper h{lr, c1, c2, b1, omb1, b2, omb2, eps, l2};
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(L, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
