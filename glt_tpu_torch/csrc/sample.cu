// One hop's neighbor read: kernel B1 of the port.
//
// Replaces the Pallas kernel glt_tpu/ops/sample_pallas.py
// `_make_bin_kernel` (launched per degree bin by `_binned_take_sorted`,
// entry point `sample_neighbors_pallas`).  It computes the epilogue of
// glt_tpu/ops/neighbor_sample.py `sample_neighbors`:
//
//   nbrs[i,k] = mask[i,k] ? indices[indptr[s_i] + pos[i,k]] : -1
//   eids[i,k] = mask[i,k] ? edge_ids[...] (or the CSR position) : -1
//
// with s_i = seeds[i]; only valid slots read anything, so padding and
// degree-0 seeds touch no memory.  The draw (pos, mask) stays outside, in the
// port's bit-exact threefry, so the kernel and the plain version read
// the same positions.
//
// What bounds it on the card: bytes.  Per slot it reads pos (4 B) and
// mask (1 B) and writes nbrs (4 B) and eids (4 B), all coalesced; the
// only irregular traffic is one 4-byte read of `indices` (and of
// `edge_ids`) per valid slot, at a random row of the edge array.  There
// is no arithmetic to speak of.
//
// Design: one warp per seed row, lanes over the fanout slots (a loop
// covers fanout > 32), so a row's offset is read once per warp and the
// slot reads of one row fall in one contiguous window of `indices`.
// The TPU kernel's machinery exists for lane windows and DMAs that
// Hopper does not have: no degree binning, no 128-aligned windows, no
// hub epilogue and no padding of the edge array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// eid_mode: 0 = no edge ids, 1 = positional (CSR position), 2 = read
// edge_ids.
__global__ void sample_read_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ seeds,
                                   const int32_t* __restrict__ pos,
                                   const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ edge_ids,
                                   int eid_mode, int64_t rows, int fanout,
                                   int32_t* __restrict__ nbrs,
                                   int32_t* __restrict__ eids) {
  const int64_t row =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int32_t s = seeds[row];
  const int64_t base = row * fanout;
  for (int k = lane; k < fanout; k += 32) {
    const int64_t o = base + k;
    int32_t nb = -1;
    int32_t ed = -1;
    if (mask[o]) {
      // A valid slot implies a seed in range with degree > 0; every
      // lane of the warp reads the same offset, one transaction.
      const int64_t e = int64_t(indptr[s]) + pos[o];
      nb = indices[e];
      if (eid_mode == 1) {
        ed = static_cast<int32_t>(e);
      } else if (eid_mode == 2) {
        ed = edge_ids[e];
      }
    }
    nbrs[o] = nb;
    if (eid_mode != 0) eids[o] = ed;
  }
}

}  // namespace

extern "C" int glt_sample_neighbors(const void* indptr, const void* seeds,
                                    const void* pos, const void* mask,
                                    const void* indices, const void* edge_ids,
                                    int eid_mode, int64_t rows, int fanout,
                                    void* nbrs, void* eids, void* stream) {
  if (rows == 0 || fanout == 0) return 0;
  const int threads = kWarpsPerBlock * 32;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sample_read_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(seeds),
      static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(indices),
      static_cast<const int32_t*>(edge_ids), eid_mode, rows, fanout,
      static_cast<int32_t*>(nbrs), static_cast<int32_t*>(eids));
  return static_cast<int>(cudaGetLastError());
}
