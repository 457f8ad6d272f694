// One hop's neighbor sample: kernel B1 of the port, the threefry draw and
// the neighbor read in one launch.
//
// Replaces the Pallas kernel glt_tpu/ops/sample_pallas.py
// `_make_bin_kernel` (launched per degree bin by `_binned_take_sorted`,
// entry point `sample_neighbors_pallas`), and with it the XLA draw that
// feeds it: it computes glt_tpu/ops/neighbor_sample.py `sample_neighbors`
// (force='xla') whole, bit for bit, in all four draw modes
// (key_by 'slot' or 'id', with or without replacement):
//
//   deg_i      = degree of seeds[i] (0 for padding and ids past the end)
//   pos[i,k]   = Floyd's k-subset (or i.i.d. uniform) position, drawn with
//                jax.random's threefry from the hop's key
//   nbrs[i,k]  = mask[i,k] ? indices[indptr[s_i] + pos[i,k]] : -1
//   eids[i,k]  = mask[i,k] ? edge_ids[...] (or the CSR position) : -1
//
// The key arrives as a device tensor, read through a pointer: no host
// sync, and the launch can be captured in a CUDA graph.
//
// What bounds it on the card: neither bytes nor operations, but the
// launch.  Per slot it writes 9 bytes (nbrs, eids, mask) and reads 4 (8
// with edge ids) at a random row of the edge array; per drawn slot it
// runs 2 threefry hashes (5 when keyed by id), ~80 integer operations
// each, and the span reduction.  At the main path's widest hop
// ([19200, 5]) the integer operations bind at ~1 us and the bytes at
// ~0.4 us, both under the launch latency (the kernel takes ~6.5 us on an
// H100; PERF.md).  The plain version draws with ~800 launches of masked
// int64 tensor arithmetic per hop; this kernel is one launch.
//
// Design: a power-of-two group of min(32, next_pow2(F)) lanes per row,
// so several rows share a warp at small fanouts (F = 5: 4 rows a warp, 3
// idle lanes of 8, not 27 of 32).  Lane l owns slots l, l + G, ...; each
// lane draws its slots' candidates in parallel, and Floyd's sequential
// duplicate test runs as F warp-synchronous steps: the owner of step i
// broadcasts its candidate (__shfl_sync within the group), every lane
// compares it with the picks it holds in registers, and one __ballot_sync
// answers "already chosen?".  Rows keyed by slot share the 3F per-step
// keys, computed once per block into shared memory.  Masked and padding
// slots touch no memory but their outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* indptr;
  int64_t n_ptr;  // indptr's length: N + 1
  const int32_t* indices;
  const int32_t* edge_ids;
  const int32_t* seeds;
  const int64_t* key;  // [2] words, each a uint32 value
  int64_t rows;
  int fanout;
  int group;  // lanes per row, a power of two <= 32
  int replace;
  int by_id;
  int eid_mode;  // 0 = no edge ids, 1 = CSR position, 2 = edge_ids[...]
  int32_t* nbrs;
  int32_t* eids;
  uint8_t* mask;
};

__device__ __forceinline__ void write_slot(const Args& a, int64_t o,
                                           bool valid, int64_t start,
                                           int32_t pos) {
  int32_t nb = -1;
  int32_t ed = -1;
  if (valid) {
    const int64_t e = start + pos;
    nb = a.indices[e];
    if (a.eid_mode == 1) {
      ed = static_cast<int32_t>(e);
    } else if (a.eid_mode == 2) {
      ed = a.edge_ids[e];
    }
  }
  a.nbrs[o] = nb;
  if (a.eid_mode != 0) a.eids[o] = ed;
  a.mask[o] = valid;
}

// kS: the most slots a lane owns without replacement (F <= group * kS).
template <int kS>
__global__ void __launch_bounds__(kThreads) sample_kernel(Args a) {
  // Keyed by slot, every row shares the step keys (kh_i, kl_i) =
  // split(split(key, F)[i], 2), or (kh, kl) = split(key, 2) with
  // replacement.
  extern __shared__ glt::Key step_keys[];
  const int F = a.fanout;
  const glt::Key key = glt::load_key(a.key);
  if (!a.by_id) {
    if (a.replace) {
      if (threadIdx.x < 2) step_keys[threadIdx.x] =
          glt::split_key(key, threadIdx.x);
    } else {
      for (int i = threadIdx.x; i < F; i += blockDim.x) {
        const glt::Key ki = glt::split_key(key, i);
        step_keys[2 * i] = glt::split_key(ki, 0);
        step_keys[2 * i + 1] = glt::split_key(ki, 1);
      }
    }
    __syncthreads();
  }

  const int G = a.group;
  const int lane = threadIdx.x & (G - 1);
  const int64_t row =
      int64_t(blockIdx.x) * (blockDim.x / G) + threadIdx.x / G;
  const bool live = row < a.rows;

  // Offsets and degrees as neighbor_sample._row_offsets_and_degrees:
  // padding gets degree 0; ids past the last row clamp to it (degree 0).
  const int32_t s = live ? a.seeds[row] : -1;
  int64_t start = 0;
  int32_t deg = 0;
  if (s >= 0) {
    const int64_t last = a.n_ptr - 1;
    const int64_t i0 = s < last ? int64_t(s) : last;
    const int64_t i1 = s + int64_t(1) < last ? s + int64_t(1) : last;
    const int32_t lo = a.indptr[i0];
    deg = a.indptr[i1] - lo;
    start = lo;
  }
  // key_by='id' keys the row by its unclamped id (0 for padding).
  const uint32_t id = static_cast<uint32_t>(s >= 0 ? s : 0);
  const int64_t base = row * F;

  if (a.replace) {
    if (!live) return;  // no warp-wide step follows
    glt::Key kh, kl;
    if (a.by_id) {
      const glt::Key rk = glt::fold_in(key, id);
      kh = glt::split_key(rk, 0);
      kl = glt::split_key(rk, 1);
    } else {
      kh = step_keys[0];
      kl = step_keys[1];
    }
    const bool any = deg > 0;
    const uint32_t span = static_cast<uint32_t>(max(deg, 1));
    for (int k = lane; k < F; k += G) {
      int32_t pos = 0;
      if (any) {
        const uint32_t c = a.by_id ? static_cast<uint32_t>(k)
                                   : static_cast<uint32_t>(base + k);
        pos = glt::randint_span(kh, kl, c, span);
      }
      write_slot(a, base + k, any, start, pos);
    }
    return;
  }

  // Without replacement: Floyd's k-subset.  Step i draws
  // t_i in [0, deg - F + i + 1) and keeps it unless already chosen, else
  // takes deg - F + i.  Rows with deg <= F take slots 0..deg-1 in order.
  const bool big = live && deg > F;
  glt::Key rk{0u, 0u};
  if (big && a.by_id) rk = glt::fold_in(key, id);
  uint32_t t[kS];
  int32_t c[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int k = lane + j * G;
    t[j] = 0u;
    c[j] = k;
    if (big && k < F) {
      const uint32_t span = static_cast<uint32_t>(deg - F + k + 1);
      if (a.by_id) {
        const glt::Key kk = glt::split_key(rk, k);
        t[j] = glt::randint_span(glt::split_key(kk, 0),
                                 glt::split_key(kk, 1), 0u, span);
      } else {
        t[j] = glt::randint_span(step_keys[2 * k], step_keys[2 * k + 1],
                                 static_cast<uint32_t>(row), span);
      }
    }
  }
  // Every lane of the warp reaches this point (no early return above), so
  // the warp-wide steps below run with the full mask.
  if (__any_sync(kFull, big)) {
    const int gbase = (threadIdx.x & 31) & ~(G - 1);
    const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u);
    for (int i = 0; i < F; ++i) {
      const int owner = i & (G - 1);
      const int si = i / G;
      uint32_t mine = t[0];
#pragma unroll
      for (int j = 1; j < kS; ++j) {
        if (j == si) mine = t[j];
      }
      const uint32_t ti = __shfl_sync(kFull, mine, owner, G);
      bool hit = false;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        hit |= (lane + j * G < i) && (static_cast<uint32_t>(c[j]) == ti);
      }
      const unsigned dup = (__ballot_sync(kFull, hit) >> gbase) & gmask;
      if (big && lane == owner) {
        const int32_t pick = dup ? deg - F + i : static_cast<int32_t>(ti);
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (j == si) c[j] = pick;
        }
      }
    }
  }
  if (!live) return;
  const int32_t width = min(deg, F);
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int k = lane + j * G;
    if (k < F) write_slot(a, base + k, k < width, start, c[j]);
  }
}

template <int kS>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / a.group;
  const int64_t blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = a.by_id ? 0
                              : sizeof(glt::Key) *
                                    (a.replace ? 2 : 2 * size_t(a.fanout));
  sample_kernel<kS><<<static_cast<unsigned>(blocks), kThreads, smem,
                      stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest fanout without replacement: a lane holds at most 64 picks
// (ops/sample_cuda.py MAX_FANOUT).
constexpr int kMaxFanout = 32 * 64;

extern "C" int glt_sample_neighbors(const void* indptr, int64_t n_ptr,
                                    const void* indices, const void* edge_ids,
                                    const void* seeds, const void* key,
                                    int64_t rows, int fanout, int replace,
                                    int by_id, int eid_mode, void* nbrs,
                                    void* eids, void* mask, void* stream) {
  if (rows == 0 || fanout <= 0) return 0;
  if (!replace && fanout > kMaxFanout)
    return static_cast<int>(cudaErrorInvalidValue);
  int group = 1;
  while (group < fanout && group < 32) group *= 2;
  Args a{static_cast<const int32_t*>(indptr),
         n_ptr,
         static_cast<const int32_t*>(indices),
         static_cast<const int32_t*>(edge_ids),
         static_cast<const int32_t*>(seeds),
         static_cast<const int64_t*>(key),
         rows,
         fanout,
         group,
         replace,
         by_id,
         eid_mode,
         static_cast<int32_t*>(nbrs),
         static_cast<int32_t*>(eids),
         static_cast<uint8_t*>(mask)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (replace || fanout <= 32) return launch<1>(a, s);
  if (fanout <= 32 * 8) return launch<8>(a, s);
  return launch<64>(a, s);
}
