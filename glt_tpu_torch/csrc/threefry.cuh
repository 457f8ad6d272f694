// threefry2x32 on the card, bit-exact with jax.random (and with the
// port's plain arithmetic in glt_tpu_torch/random.py).
//
// jax.random under its defaults (threefry2x32, partitionable layout,
// 64-bit mode off): split and the random bits hash the counter (0, c)
// under a key of two uint32 words; fold_in hashes (0, data mod 2**32);
// randint draws two 32-bit words and reduces them with the span trick.
// Shared by kernel B1 (sample.cu) and the key-derivation kernel
// (threefry.cu).  Not carried over from a Pallas kernel: in glt_tpu, XLA
// compiles jax.random.

#pragma once

#include <stdint.h>

namespace glt {

struct Key {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// 20 rounds: rotations (13, 15, 26, 6) and (17, 29, 16, 24), a key
// injection after every four.
__device__ __forceinline__ Key threefry2x32(Key k, uint32_t x0,
                                            uint32_t x1) {
  const uint32_t ks[3] = {k.hi, k.lo, k.hi ^ k.lo ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0];
  uint32_t b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl32(b, rot[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return Key{a, b};
}

// jax.random.split(key, n)[i] and jax.random.fold_in(key, d): the same
// hash of (0, counter).
__device__ __forceinline__ Key split_key(Key k, uint32_t i) {
  return threefry2x32(k, 0u, i);
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  return threefry2x32(k, 0u, d);
}

// One uint32 of jax.random.bits at flat position `counter`.
__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t counter) {
  const Key h = threefry2x32(k, 0u, counter);
  return h.hi ^ h.lo;
}

// jax.random.randint(key, shape, 0, maxval) at flat position `counter`,
// given the two halves (kh, kl) = split(key, 2) and span = maxval >= 1
// (<= INT32_MAX, so jax's out-of-range branch never fires):
//   (hi % span * (2**32 % span) + lo % span) % span, in uint32.
__device__ __forceinline__ int32_t randint_span(Key kh, Key kl,
                                                uint32_t counter,
                                                uint32_t span) {
  const uint32_t higher = random_bits(kh, counter);
  const uint32_t lower = random_bits(kl, counter);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t offset = (higher % span) * mult + lower % span;
  return static_cast<int32_t>(offset % span);
}

// A key stored as the port's two int64 words (each a uint32 value).
__device__ __forceinline__ Key load_key(const int64_t* p) {
  return Key{static_cast<uint32_t>(p[0]), static_cast<uint32_t>(p[1])};
}

}  // namespace glt
