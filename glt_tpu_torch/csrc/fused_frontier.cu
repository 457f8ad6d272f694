// Fused frontier gather: kernel B3 of the port.
//
// Replaces the Pallas kernel glt_tpu/ops/fused_frontier.py
// `_make_fused_kernel` (launched by `_fused_gather`, entry point
// `fused_frontier`), together with its caller's zero epilogue.  Given the
// frontier's first-occurrence unique rows `uidx` (already mapped through
// id2index) and the inverse map `inv` of unique_first_occurrence, it
// computes in one launch, for i < batch and any row width,
//
//   out[i, :] = inv[i] >= 0
//       ? table[clamp(uidx[min(inv[i], batch - 1)], 0, n_rows - 1), :] : 0
//
// Rows are copied as bytes, so f32, bf16 and int8 tables take the same
// path.
// The clamps only make stray indices safe, as in the plain version:
// unique_first_occurrence gives inv[i] < batch.
//
// What bounds it on the card: bytes.  The least traffic is each unique
// row read once, every output row written once and 8 B of indices per
// row; it computes nothing.
//
// Design: the TPU kernel streams the unique rows into a ~6 MiB VMEM
// buffer (phase A) and serves every duplicate position from it (phase
// B), so the unique block never bounces through HBM.  A Hopper block has
// at most 227 KiB of shared memory, so there is no such buffer here:
// each thread copies one vector unit of one output row (grid-stride over
// batch * units, neighbouring threads on neighbouring units of a row, as
// in gather.cu), reading `table[uidx[inv[i]]]` directly.  A duplicate
// row is then read again, but from the 50 MB L2, which holds a whole
// frontier's unique block (<= 56 MB at the products shape, most of it in
// practice far less).  The unit is 16 bytes when the row pitch and both
// base pointers allow it, else the widest of 8, 4, 2 and 1 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per H100 SM

template <typename V>
__global__ void fused_frontier_kernel(const V* __restrict__ table,
                                      const int32_t* __restrict__ uidx,
                                      const int32_t* __restrict__ inv,
                                      V* __restrict__ out, int64_t n_rows,
                                      int64_t batch, int64_t units) {
  const int64_t total = batch * units;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / units;
    const int64_t c = t - i * units;
    int64_t slot = inv[i];
    if (slot < 0) {
      out[t] = V{};
      continue;
    }
    if (slot >= batch) slot = batch - 1;
    int64_t r = uidx[slot];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    out[t] = table[r * units + c];
  }
}

template <typename V>
int launch(const void* table, const void* uidx, const void* inv, void* out,
           int64_t n_rows, int64_t batch, int64_t row_bytes,
           cudaStream_t stream) {
  const int64_t units = row_bytes / int64_t(sizeof(V));
  const int64_t total = batch * units;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_frontier_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(uidx),
      static_cast<const int32_t*>(inv), static_cast<V*>(out), n_rows, batch,
      units);
  return static_cast<int>(cudaGetLastError());
}

bool fits(const void* a, const void* b, int64_t row_bytes, int64_t unit) {
  return row_bytes % unit == 0 &&
         reinterpret_cast<uintptr_t>(a) % unit == 0 &&
         reinterpret_cast<uintptr_t>(b) % unit == 0;
}

}  // namespace

extern "C" int glt_fused_frontier(const void* table, const void* uidx,
                                  const void* inv, void* out, int64_t n_rows,
                                  int64_t batch, int64_t row_bytes,
                                  void* stream) {
  if (batch == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(table, out, row_bytes, 16))
    return launch<uint4>(table, uidx, inv, out, n_rows, batch, row_bytes, s);
  if (fits(table, out, row_bytes, 8))
    return launch<uint2>(table, uidx, inv, out, n_rows, batch, row_bytes, s);
  if (fits(table, out, row_bytes, 4))
    return launch<uint32_t>(table, uidx, inv, out, n_rows, batch, row_bytes,
                            s);
  if (fits(table, out, row_bytes, 2))
    return launch<uint16_t>(table, uidx, inv, out, n_rows, batch, row_bytes,
                            s);
  return launch<uint8_t>(table, uidx, inv, out, n_rows, batch, row_bytes, s);
}
