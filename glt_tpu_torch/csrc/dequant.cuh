// The dequant epilogue shared by kernels B4 (gather_dequant.cu) and B5
// (fused_frontier_dequant.cu), so the two cannot drift apart.
//
// It is the device copy of the one decode formula of
// glt_tpu_torch/store/quant.py (`dequantize_rows`), itself the formula
// of glt_tpu/store/quant.py `dequantize`:
//
//   bf16 (widen):   float(x), exactly: the 16 bits become the high half
//                   of an f32 (never x * 1 + 0, which turns -0.0 to +0.0)
//   int8 (affine):  scale > 0 ? (float(q) + k) * scale : zero
//
// The add and the multiply are separate round-to-nearest intrinsics
// (__fadd_rn, __fmul_rn), which the compiler may neither contract into an
// FMA nor reassociate, so every rounding is the plain version's.  The
// sources are built without --use_fast_math and without -ftz=true: a
// subnormal scale, zero or result survives as in the plain version.
//
// `sz` is the [8, d] f32 input of quant.scale_zero_rows: row 0 scale,
// row 1 zero, row 2 the integer zero point k.  It is read from global
// memory; a launch touches 3 * d floats of it, which stay in L1/L2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace glt {

enum Codec : int { kWidenBf16 = 0, kAffineInt8 = 1 };

__device__ __forceinline__ float widen_bf16(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float affine_int8(int32_t q, float scale,
                                             float zero, float k) {
  return scale > 0.f ? __fmul_rn(__fadd_rn(static_cast<float>(q), k), scale)
                     : zero;
}

// Storage element of each codec.
template <int kCodec>
struct Storage;
template <>
struct Storage<kWidenBf16> {
  using T = uint16_t;
};
template <>
struct Storage<kAffineInt8> {
  using T = int8_t;
};

// Decode the V consecutive codes at column c of one compressed row `src`
// (a pointer to the row's first element) into dst[c .. c + V) of one f32
// output row.  V is 1 or 4; with V == 4 the caller guarantees c % 4 == 0,
// a 4-code-aligned source row (4 B for int8, 8 B for bf16) and 16-byte
// aligned dst and sz rows, so the codes are one 32- or 64-bit load, the
// output one 128-bit store, and each sz row one 128-bit load.
template <int kCodec, int V>
__device__ __forceinline__ void decode_group(
    const typename Storage<kCodec>::T* __restrict__ src,
    const float* __restrict__ sz, int64_t d, int64_t c,
    float* __restrict__ dst) {
  float v[V];
  if constexpr (V == 4) {
    if constexpr (kCodec == kWidenBf16) {
      const uint2 w = *reinterpret_cast<const uint2*>(src + c);
      v[0] = widen_bf16(w.x & 0xffffu);
      v[1] = widen_bf16(w.x >> 16);
      v[2] = widen_bf16(w.y & 0xffffu);
      v[3] = widen_bf16(w.y >> 16);
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(src + c);
      const float4 s = *reinterpret_cast<const float4*>(sz + c);
      const float4 z = *reinterpret_cast<const float4*>(sz + d + c);
      const float4 k = *reinterpret_cast<const float4*>(sz + 2 * d + c);
      v[0] = affine_int8(static_cast<int8_t>(w & 0xffu), s.x, z.x, k.x);
      v[1] = affine_int8(static_cast<int8_t>((w >> 8) & 0xffu), s.y, z.y,
                         k.y);
      v[2] = affine_int8(static_cast<int8_t>((w >> 16) & 0xffu), s.z, z.z,
                         k.z);
      v[3] = affine_int8(static_cast<int8_t>(w >> 24), s.w, z.w, k.w);
    }
    *reinterpret_cast<float4*>(dst + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    if constexpr (kCodec == kWidenBf16) {
      v[0] = widen_bf16(src[c]);
    } else {
      v[0] = affine_int8(src[c], sz[c], sz[d + c], sz[2 * d + c]);
    }
    dst[c] = v[0];
  }
}

// Zero V outputs at column c (B5's padding rows: a literal 0.f, never the
// decode of a zero code, which for int8 is the column's zero point).
template <int V>
__device__ __forceinline__ void zero_group(int64_t c,
                                           float* __restrict__ dst) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    dst[c] = 0.f;
  }
}

// Whether the 4-wide path may run: d % 4 == 0 and every base aligned.
inline bool quad_aligned(const void* table, int64_t item_bytes,
                         const void* sz, const void* out, int64_t d) {
  return d % 4 == 0 &&
         reinterpret_cast<uintptr_t>(table) % (4 * item_bytes) == 0 &&
         reinterpret_cast<uintptr_t>(sz) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// B5's launch, and B4's default point (B4 takes any point of launch.cuh).
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per H100 SM

inline unsigned grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace glt
