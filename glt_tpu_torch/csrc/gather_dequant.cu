// Dequantizing row gather: kernel B4 of the port.
//
// Replaces the Pallas kernel glt_tpu/ops/gather_pallas.py
// `_make_tiled_dequant_kernel` (launched by `_gather_sorted_pallas_dq`,
// entry point `gather_rows_pallas_dq`).  Over a compressed table (int8 or
// bf16 codes) it computes, for i < batch and every column,
//
//   out[i, :] = dequant(table[clamp(idx[i], 0, n_rows - 1), :])   (f32)
//
// with dequant the epilogue of dequant.cuh (bf16 widen, int8 affine from
// the [8, d] scale/zero/k input), for every row width d >= 1.  The TPU
// kernel ran only d % 128 == 0 or d == 64.
//
// What bounds it on the card: bytes.  It reads each requested compressed
// row once (d or 2d bytes) and writes d f32 (4d bytes), plus 4 B of index
// per row; the decode is two flops a value.
//
// Design: each thread decodes one group of codes of one output row, with
// a grid-stride loop over batch * groups; neighbouring threads take
// neighbouring groups of a row, so reads and the f32 writes are
// coalesced.  A group is 4 codes (one 32-bit int8 or 64-bit bf16 load,
// one 128-bit store) when d % 4 == 0 and the bases are aligned, else one
// code.  The TPU kernel's sort, chunk plan and DMA ring existed for its
// DMAs and have no counterpart here.
//
// Launch point (launch.cuh): threads per block, the grid cap in blocks
// per SM and the largest vector width in bytes of the f32 output (16: the
// 4-code group where d and the bases allow it; less: one code a thread).
// The default, 256 threads, 16 blocks an SM and 16 bytes, is the launch
// this kernel always had (B5 keeps it: dequant.cuh grid_for).  Every point
// decodes the same codes with the same formula, so every point's output
// is equal.

#include "dequant.cuh"
#include "launch.cuh"

namespace {

template <int kCodec, int V, int kThreads>
__global__ void __launch_bounds__(kThreads) gather_dequant_kernel(
    const typename glt::Storage<kCodec>::T* __restrict__ table,
    const int32_t* __restrict__ idx, const float* __restrict__ sz,
    float* __restrict__ out, int64_t n_rows, int64_t batch, int64_t d) {
  const int64_t groups = d / V;
  const int64_t total = batch * groups;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / groups;
    const int64_t c = (t - i * groups) * V;
    int64_t r = idx[i];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    glt::decode_group<kCodec, V>(table + r * d, sz, d, c, out + i * d);
  }
}

template <int kCodec, int V>
int launch(const void* table, const void* idx, const void* sz, void* out,
           int64_t n_rows, int64_t batch, int64_t d, int threads,
           int blocks_per_sm, cudaStream_t stream) {
  using T = typename glt::Storage<kCodec>::T;
  const unsigned blocks =
      glt::grid_blocks(batch * (d / V), threads, blocks_per_sm);
  return glt::with_threads(threads, [&](auto t) {
    constexpr int kThreads = decltype(t)::value;
    gather_dequant_kernel<kCodec, V, kThreads>
        <<<blocks, kThreads, 0, stream>>>(
            static_cast<const T*>(table), static_cast<const int32_t*>(idx),
            static_cast<const float*>(sz), static_cast<float*>(out), n_rows,
            batch, d);
    return static_cast<int>(cudaGetLastError());
  });
}

template <int kCodec>
int launch_codec(const void* table, int64_t item_bytes, const void* idx,
                 const void* sz, void* out, int64_t n_rows, int64_t batch,
                 int64_t d, int threads, int blocks_per_sm,
                 int max_vec_bytes, cudaStream_t stream) {
  if (max_vec_bytes >= 16 && glt::quad_aligned(table, item_bytes, sz, out, d))
    return launch<kCodec, 4>(table, idx, sz, out, n_rows, batch, d, threads,
                             blocks_per_sm, stream);
  return launch<kCodec, 1>(table, idx, sz, out, n_rows, batch, d, threads,
                           blocks_per_sm, stream);
}

}  // namespace

// codec: 0 = bf16 widen, 1 = int8 affine (glt::Codec); threads,
// blocks_per_sm, max_vec_bytes: the launch point (launch.cuh).
extern "C" int glt_gather_rows_dequant(const void* table, const void* idx,
                                       const void* sz, void* out,
                                       int64_t n_rows, int64_t batch,
                                       int64_t d, int codec, int threads,
                                       int blocks_per_sm, int max_vec_bytes,
                                       void* stream) {
  if (!glt::valid_copy_point(threads, blocks_per_sm, max_vec_bytes) ||
      (codec != glt::kWidenBf16 && codec != glt::kAffineInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (codec == glt::kWidenBf16)
    return launch_codec<glt::kWidenBf16>(table, 2, idx, sz, out, n_rows,
                                         batch, d, threads, blocks_per_sm,
                                         max_vec_bytes, s);
  return launch_codec<glt::kAffineInt8>(table, 1, idx, sz, out, n_rows,
                                        batch, d, threads, blocks_per_sm,
                                        max_vec_bytes, s);
}
