// Launch points of the swept kernels B1 (sample.cu), B2 (gather.cu) and B4
// (gather_dequant.cu): the thread counts each kernel is built for, the
// vector widths and grid caps they take, and the grid they launch.
//
// The Python side sweeps exactly these points (CANDIDATE_THREADS of
// glt_tpu_torch/ops/gather_cuda.py and sample_cuda.py), and the static
// launch model (glt_tpu_torch/analysis/kernelmodel.py) checks them against
// the card's limits.  A point outside them makes the C entry point return
// cudaErrorInvalidValue and launch nothing; the wrapper raises on it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace glt {

constexpr int kNumSMs = 132;          // H100 SXM
constexpr int kMaxBlocksPerSM = 32;   // resident blocks an SM holds at most

// Call f with the launched thread count as a compile-time constant (the
// kernels' __launch_bounds__), for the counts the kernels are built for.
template <typename F>
int with_threads(int threads, F&& f) {
  switch (threads) {
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 256:
      return f(std::integral_constant<int, 256>{});
    case 512:
      return f(std::integral_constant<int, 512>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline bool built_threads(int threads) {
  return with_threads(threads, [](auto) { return 0; }) == 0;
}

inline bool valid_vec_bytes(int v) {
  return v == 1 || v == 2 || v == 4 || v == 8 || v == 16;
}

// B2 and B4's point: threads per block, the grid cap in blocks per SM and
// the largest vector width in bytes.
inline bool valid_copy_point(int threads, int blocks_per_sm,
                             int max_vec_bytes) {
  return built_threads(threads) && blocks_per_sm >= 1 &&
         blocks_per_sm <= kMaxBlocksPerSM && valid_vec_bytes(max_vec_bytes);
}

// Blocks of a grid-stride launch over `total` items: one item a thread,
// capped at blocks_per_sm blocks on every SM.
inline unsigned grid_blocks(int64_t total, int threads, int blocks_per_sm) {
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t cap = int64_t(kNumSMs) * blocks_per_sm;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks);
}

}  // namespace glt
