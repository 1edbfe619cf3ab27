// The counter-based hash RNG of neural_speech_decoder_tpu/ops/hashrng.py
// (uniform2d / keep_mask2d), bit for bit: a murmur3-style finalizer over
// (seed, salt, row, col) in uint32 with wrapping multiplies and logical
// shifts. The port's ops/hashrng.py computes the same bits in PyTorch.
//
// Also the body of the two dropout-mask test hooks (attention.cu's
// nsd_attn_dropout_masks, ffn.cu's nsd_ffn_dropout_masks; they replace the
// TPU kernels attention_kernel.py::dropout_masks and ffn_kernel.py::
// dropout_masks): hash_masks_kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nsd {

constexpr uint32_t kHashRow = 0x9E3779B1u, kHashCol = 0x85EBCA77u, kHashSeed = 0xC2B2AE3Du,
                   kHashSalt = 0x27D4EB2Fu;

// The finalizer over the xor of the four terms.
__device__ __forceinline__ uint32_t hash_mix(uint32_t h) {
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t hash_bits(int32_t seed, int32_t salt,
                                              int32_t row, int32_t col) {
  return hash_mix(static_cast<uint32_t>(row) * kHashRow ^ static_cast<uint32_t>(col) * kHashCol ^
                  static_cast<uint32_t>(seed) * kHashSeed ^
                  static_cast<uint32_t>(salt) * kHashSalt);
}

// uniform2d's value at (row, col): the top 23 bits times 2**-23, in [0, 1).
__device__ __forceinline__ float hash_uniform(int32_t seed, int32_t salt,
                                              int32_t row, int32_t col) {
  return static_cast<float>(hash_bits(seed, salt, row, col) >> 9) *
         (1.0f / 8388608.0f);
}

// hash_uniform(...) >= rate  <=>  (hash_bits(...) >> 9) >= keep_limit(rate):
// the uniform is k * 2**-23 for an integer k < 2**23, exact in float, and
// scaling both sides by 2**23 is exact, so k >= rate * 2**23 <=> k >=
// ceil(rate * 2**23); a rate that keeps nothing (>= 1, or NaN) gives 2**23.
__device__ __forceinline__ uint32_t keep_limit(float rate) {
  const float s = rate * 8388608.f;
  if (s <= 0.f) return 0u;
  if (!(s < 8388608.f)) return 1u << 23;
  return static_cast<uint32_t>(ceilf(s));
}

// A flat mask of bytes (bool, 0 or 1): byte e = m * width + col is
// hash_uniform(seed, salt0 + m / per_salt, m % per_salt, col) >= rate.
// m / per_salt is (m * salt_mul) >> salt_shift, exact for m < 2**31
// (Granlund and Montgomery's multiply for 31-bit numerators).
struct MaskBuf {
  uint8_t* out;  // 16-byte aligned
  uint32_t n;    // bytes, below 2**31
  uint32_t width, per_salt;
  int32_t salt0;
  uint64_t salt_mul;
  int salt_shift;
};

// The MaskBuf of `rows` rows of `width` bytes at out; n is set to 2**32 - 1
// (refused by hash_masks) when the mask has 2**31 bytes or more.
inline MaskBuf mask_buf(void* out, uint64_t rows, uint32_t width, uint32_t per_salt,
                        int32_t salt0) {
  int l = 0;
  while ((1ull << l) < per_salt) ++l;
  const uint64_t n = rows * width;
  return MaskBuf{static_cast<uint8_t*>(out), n < (1ull << 31) ? (uint32_t)n : 0xFFFFFFFFu,
                 width, per_salt, salt0, ((1ull << (31 + l)) + per_salt - 1) / per_salt, 31 + l};
}

template <int kBufs>
struct MaskBufs {
  MaskBuf b[kBufs];
};

// kBufs masks laid end to end in 16-byte chunks, a thread a chunk. The
// thread finds its (salt, row, col) with one 32-bit division (and the salt's
// multiply-shift), forms the row's seed, salt and row terms of the hash once
// and carries col along the row (on to the next row, and salt, where one
// ends), then writes its 16 bytes with one 16-byte store (byte by byte in a
// mask's last, partial chunk). What bounds it on an H100: the hash, about 14
// integer operations a byte, against one byte written.
template <int kBufs>
__global__ void __launch_bounds__(256)
    hash_masks_kernel(const int32_t* __restrict__ seed, MaskBufs<kBufs> bufs, float rate) {
  uint32_t chunk = blockIdx.x * blockDim.x + threadIdx.x;
  MaskBuf mb = bufs.b[0];
  bool found = false;
#pragma unroll
  for (int k = 0; k < kBufs; ++k) {
    const uint32_t chunks = (bufs.b[k].n + 15) / 16;
    if (!found && chunk < chunks) {
      mb = bufs.b[k];
      found = true;
    } else if (!found) {
      chunk -= chunks;
    }
  }
  if (!found) return;
  const uint32_t e0 = chunk * 16;
  const uint32_t m = e0 / mb.width;
  uint32_t col = e0 - m * mb.width;
  uint32_t salt = static_cast<uint32_t>((m * mb.salt_mul) >> mb.salt_shift);
  uint32_t row = m - salt * mb.per_salt;
  salt += static_cast<uint32_t>(mb.salt0);
  const uint32_t seed_term = static_cast<uint32_t>(*seed) * kHashSeed;
  const uint32_t lim = keep_limit(rate);
  uint32_t base = row * kHashRow ^ seed_term ^ salt * kHashSalt;
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (col == mb.width) {
      col = 0;
      if (++row == mb.per_salt) {
        row = 0;
        ++salt;
      }
      base = row * kHashRow ^ seed_term ^ salt * kHashSalt;
    }
    const uint32_t h = hash_mix(base ^ col * kHashCol);
    word[i / 4] |= static_cast<uint32_t>((h >> 9) >= lim) << (8 * (i % 4));
    ++col;
  }
  if (e0 + 16 <= mb.n) {
    *reinterpret_cast<uint4*>(mb.out + e0) = make_uint4(word[0], word[1], word[2], word[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (e0 + i < mb.n) mb.out[e0 + i] = static_cast<uint8_t>(word[i / 4] >> (8 * (i % 4)));
    }
  }
}

// Launch hash_masks_kernel over bufs on stream st: cudaErrorInvalidValue for
// a mask of 2**31 bytes or more or one not 16-byte aligned.
template <int kBufs>
cudaError_t hash_masks(const int32_t* seed, const MaskBufs<kBufs>& bufs, float rate,
                       cudaStream_t st) {
  uint64_t chunks = 0;
  for (const MaskBuf& mb : bufs.b) {
    if (mb.n >= (1u << 31) || reinterpret_cast<uintptr_t>(mb.out) % 16 != 0)
      return cudaErrorInvalidValue;
    chunks += (mb.n + 15) / 16;
  }
  if (chunks == 0) return cudaSuccess;
  hash_masks_kernel<kBufs><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(seed, bufs, rate);
  return cudaGetLastError();
}

}  // namespace nsd
