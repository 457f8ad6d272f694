// Row gather: kernel B2 of the port.
//
// Replaces the Pallas kernel glt_tpu/ops/gather_pallas.py
// `_make_tiled_kernel` (launched by `_gather_sorted_pallas`, entry point
// `gather_rows_pallas`).  It computes
//
//   out[i, :] = table[clamp(idx[i], 0, n_rows - 1), :]
//
// for any row width and element type: rows are copied as bytes, so f32,
// bf16 and int8 tables of every width d >= 1 take the same path (the TPU
// kernel ran only d % 128 == 0 or d == 64).
//
// What bounds it on the card: bytes.  It reads each requested row once
// and writes it once (2 * B * row_bytes, plus 4 B of index per row) and
// computes nothing.  Random rows are the only irregular access.
//
// Design: each thread copies one vector unit of one output row, with a
// grid-stride loop over all B * units; neighbouring threads copy
// neighbouring units of a row, so every row is read and written in
// full, coalesced transactions whatever its width.  The unit is 16 bytes
// (one 128-bit load and store) when the row pitch and both base
// pointers allow it, else the widest of 8, 4, 2 and 1 bytes that they
// allow.  The TPU kernel's sort, un-permute and paired-row view existed
// only for its DMAs and lanes and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per H100 SM

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t n_rows,
                                   int64_t batch, int64_t units) {
  const int64_t total = batch * units;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / units;
    const int64_t c = t - i * units;
    int64_t r = idx[i];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    out[t] = table[r * units + c];
  }
}

template <typename V>
int launch(const void* table, const void* idx, void* out, int64_t n_rows,
           int64_t batch, int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / int64_t(sizeof(V));
  const int64_t total = batch * units;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), n_rows, batch, units);
  return static_cast<int>(cudaGetLastError());
}

bool fits(const void* a, const void* b, int64_t row_bytes, int64_t unit) {
  return row_bytes % unit == 0 &&
         reinterpret_cast<uintptr_t>(a) % unit == 0 &&
         reinterpret_cast<uintptr_t>(b) % unit == 0;
}

}  // namespace

extern "C" int glt_gather_rows(const void* table, const void* idx, void* out,
                               int64_t n_rows, int64_t batch,
                               int64_t row_bytes, void* stream) {
  if (batch == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(table, out, row_bytes, 16))
    return launch<uint4>(table, idx, out, n_rows, batch, row_bytes, s);
  if (fits(table, out, row_bytes, 8))
    return launch<uint2>(table, idx, out, n_rows, batch, row_bytes, s);
  if (fits(table, out, row_bytes, 4))
    return launch<uint32_t>(table, idx, out, n_rows, batch, row_bytes, s);
  if (fits(table, out, row_bytes, 2))
    return launch<uint16_t>(table, idx, out, n_rows, batch, row_bytes, s);
  return launch<uint8_t>(table, idx, out, n_rows, batch, row_bytes, s);
}

extern "C" const char* glt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
