// The counter-based hash RNG of neural_speech_decoder_tpu/ops/hashrng.py
// (uniform2d / keep_mask2d), bit for bit: a murmur3-style finalizer over
// (seed, salt, row, col) in uint32 with wrapping multiplies and logical
// shifts. The port's ops/hashrng.py computes the same bits in PyTorch.
#pragma once

#include <stdint.h>

namespace nsd {

__device__ __forceinline__ uint32_t hash_bits(int32_t seed, int32_t salt,
                                              int32_t row, int32_t col) {
  uint32_t h = static_cast<uint32_t>(row) * 0x9E3779B1u ^
               static_cast<uint32_t>(col) * 0x85EBCA77u ^
               static_cast<uint32_t>(seed) * 0xC2B2AE3Du ^
               static_cast<uint32_t>(salt) * 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

// uniform2d's value at (row, col): the top 23 bits times 2**-23, in [0, 1).
__device__ __forceinline__ float hash_uniform(int32_t seed, int32_t salt,
                                              int32_t row, int32_t col) {
  return static_cast<float>(hash_bits(seed, salt, row, col) >> 9) *
         (1.0f / 8388608.0f);
}

}  // namespace nsd
