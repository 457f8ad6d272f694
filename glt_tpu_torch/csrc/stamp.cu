// Boundary stamps of the graph-safe stage spans (glt_tpu_torch/obs/stages.py).
//
// One launch appends one entry (tag, ns) to a device ring:
//
//   i = cursor++;  ring[i % capacity] = (tag, %globaltimer)
//
// The tag names the stage boundary (its mark) and the stream lane it was
// recorded on; both are launch arguments, so a CUDA graph that captured the
// launch appends the same tag again at every replay, with no host
// involvement.  The cursor only grows: entries past the capacity overwrite
// the oldest, and the host counts them as lost (cursor - capacity).
//
// What bounds it: nothing but its launch.  One thread reads the global
// timer (ns since an arbitrary epoch, shared by every SM), takes a slot with
// one atomic add and writes 16 bytes.  Stream order places it between the
// kernels before and after it, which is what a boundary needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(long long* __restrict__ ring,
                             unsigned long long* __restrict__ cursor,
                             long long capacity, long long tag) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  const unsigned long long i = atomicAdd(cursor, 1ULL);
  const long long slot =
      static_cast<long long>(i % static_cast<unsigned long long>(capacity));
  ring[2 * slot] = tag;
  ring[2 * slot + 1] = static_cast<long long>(ns);
}

}  // namespace

// ring: int64 [capacity, 2]; cursor: one int64 (the entries ever appended).
extern "C" int glt_stamp(void* ring, void* cursor, int64_t capacity,
                         int64_t tag, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring),
      static_cast<unsigned long long*>(cursor), capacity, tag);
  return static_cast<int>(cudaGetLastError());
}
