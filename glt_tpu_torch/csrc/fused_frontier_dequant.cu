// Dequantizing fused frontier gather: kernel B5 of the port.
//
// Replaces the Pallas kernel glt_tpu/ops/fused_frontier.py
// `_make_fused_dequant_kernel` (launched by `_fused_gather_dq`, entry
// point `fused_frontier(..., dequant=spec)`), together with its caller's
// zero epilogue.  Given the frontier's first-occurrence unique rows `uidx`
// (already mapped through id2index) and the inverse map `inv` of
// unique_first_occurrence, over a compressed table (int8 or bf16 codes) it
// computes in one launch, for i < batch and any row width,
//
//   out[i, :] = inv[i] >= 0
//       ? dequant(table[clamp(uidx[min(inv[i], batch - 1)], 0, n_rows - 1)])
//       : 0.f
//
// The padding zero is a literal 0.f, not the decode of a zero code (for
// int8 that is the column's zero point).  The element code is B4's: both
// call dequant.cuh's decode_group.
//
// What bounds it on the card: bytes.  The least traffic is each unique
// compressed row read once, every f32 output row written once and 8 B of
// indices per row.
//
// Design: as B3 (fused_frontier.cu).  The TPU kernel kept the compressed
// unique block in a ~6 MiB VMEM buffer; a Hopper block has at most
// 227 KiB of shared memory, so each thread decodes one group of one
// output row straight from `table[uidx[inv[i]]]`, and a duplicate row is
// read again from the 50 MB L2, which holds a frontier's compressed
// unique block (13.5 MB at the products shape in int8).  A group is 4
// codes when d % 4 == 0 and the bases are aligned, else one code.

#include "dequant.cuh"

namespace {

template <int kCodec, int V>
__global__ void fused_frontier_dequant_kernel(
    const typename glt::Storage<kCodec>::T* __restrict__ table,
    const int32_t* __restrict__ uidx, const int32_t* __restrict__ inv,
    const float* __restrict__ sz, float* __restrict__ out, int64_t n_rows,
    int64_t batch, int64_t d) {
  const int64_t groups = d / V;
  const int64_t total = batch * groups;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / groups;
    const int64_t c = (t - i * groups) * V;
    int64_t slot = inv[i];
    if (slot < 0) {
      glt::zero_group<V>(c, out + i * d);
      continue;
    }
    if (slot >= batch) slot = batch - 1;
    int64_t r = uidx[slot];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    glt::decode_group<kCodec, V>(table + r * d, sz, d, c, out + i * d);
  }
}

template <int kCodec, int V>
int launch(const void* table, const void* uidx, const void* inv,
           const void* sz, void* out, int64_t n_rows, int64_t batch,
           int64_t d, cudaStream_t stream) {
  using T = typename glt::Storage<kCodec>::T;
  fused_frontier_dequant_kernel<kCodec, V>
      <<<glt::grid_for(batch * (d / V)), glt::kThreads, 0, stream>>>(
          static_cast<const T*>(table), static_cast<const int32_t*>(uidx),
          static_cast<const int32_t*>(inv), static_cast<const float*>(sz),
          static_cast<float*>(out), n_rows, batch, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codec: 0 = bf16 widen, 1 = int8 affine (glt::Codec).
extern "C" int glt_fused_frontier_dequant(const void* table, const void* uidx,
                                          const void* inv, const void* sz,
                                          void* out, int64_t n_rows,
                                          int64_t batch, int64_t d, int codec,
                                          void* stream) {
  if (batch == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (codec == glt::kWidenBf16) {
    if (glt::quad_aligned(table, 2, sz, out, d))
      return launch<glt::kWidenBf16, 4>(table, uidx, inv, sz, out, n_rows,
                                        batch, d, s);
    return launch<glt::kWidenBf16, 1>(table, uidx, inv, sz, out, n_rows,
                                      batch, d, s);
  }
  if (codec == glt::kAffineInt8) {
    if (glt::quad_aligned(table, 1, sz, out, d))
      return launch<glt::kAffineInt8, 4>(table, uidx, inv, sz, out, n_rows,
                                         batch, d, s);
    return launch<glt::kAffineInt8, 1>(table, uidx, inv, sz, out, n_rows,
                                       batch, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
