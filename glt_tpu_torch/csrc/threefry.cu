// Key derivation on the card: jax.random.split, fold_in and the random
// bits' hash in one launch.
//
//   out[k, d] = threefry2x32(keys[k], (0, c_d))
//
// with c_d = d (split, the bits' iota), c_d = data[d] mod 2**32 (fold_in
// of a tensor) or c_d = value for every d (fold_in of a Python int,
// passed by value, so no host->device copy).  Output words are written as
// int64, the port's key layout.
//
// Replaces no Pallas kernel: in glt_tpu, XLA compiles jax.random.  The
// port's plain version is uint32 arithmetic in masked int64 tensor ops,
// ~174 launches per split or fold_in; this is one.
//
// What bounds it on the card: launch latency.  A sampler call derives 4
// keys (fold_in, then split by 3); a training block 8.  Each thread does
// one hash (~100 integer ops) and writes 16 bytes, so bytes and
// operations both round to nothing next to the launch.  Design: one
// thread per output pair, nothing more.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// counter_mode: 0 = iota, 1 = int64 data, 2 = int32 data, 3 = `value`.
__global__ void threefry_hash_kernel(const int64_t* __restrict__ keys,
                                     const void* __restrict__ data,
                                     int64_t value, int counter_mode,
                                     int64_t n_keys, int64_t n_counters,
                                     int64_t* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_keys * n_counters) return;
  const int64_t k = i / n_counters;
  const int64_t d = i % n_counters;
  uint32_t c;
  if (counter_mode == 0) {
    c = static_cast<uint32_t>(d);
  } else if (counter_mode == 1) {
    c = static_cast<uint32_t>(static_cast<const int64_t*>(data)[d]);
  } else if (counter_mode == 2) {
    c = static_cast<uint32_t>(static_cast<const int32_t*>(data)[d]);
  } else {
    c = static_cast<uint32_t>(value);
  }
  const glt::Key h = glt::threefry2x32(glt::load_key(keys + 2 * k), 0u, c);
  out[2 * i] = h.hi;
  out[2 * i + 1] = h.lo;
}

}  // namespace

extern "C" int glt_threefry_hash(const void* keys, const void* data,
                                 int64_t value, int counter_mode,
                                 int64_t n_keys, int64_t n_counters,
                                 void* out, void* stream) {
  const int64_t total = n_keys * n_counters;
  if (total == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (total + threads - 1) / threads;
  threefry_hash_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), data, value, counter_mode, n_keys,
      n_counters, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
