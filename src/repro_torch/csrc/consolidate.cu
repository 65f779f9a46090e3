// Algorithm 1's region copies: gather scattered base pages into one dense
// huge-page region (K5a), and scatter a region's rows back out (K5b).
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/consolidate/kernel.py:consolidate_gather and
// :consolidate_scatter, with the masking of their wrappers (ops.py) moved
// into the kernels' bodies.
//
//   consolidate_gather:  out[j] = ids[j] < 0 ? 0 : src[min(ids[j], n_rows - 1)]
//   consolidate_scatter: dst[ids[j]] = region[j] for 0 <= ids[j] < n_rows, in
//                        place; of several slots with one destination the
//                        last slot wins
//
// Bound on the H100: bytes. At the engine's Redis geometry one region is
// 512 rows of 4 KiB (1,024 float32) out of or into a row space of 3,276,800
// rows: at most 2.1 MB read and 2.1 MB written.
//
// Design. One block per region slot, as the TPU grid has one step per slot;
// the row moves in 16-byte vectors when the row size and pointers allow,
// else in bytes (rows.cuh), so the kernels never look at the dtype. The TPU
// scatter runs its grid in order, so a later slot overwrites an earlier one
// with the same destination; here the blocks run in parallel, so each block
// first scans the slots after its own (hp_ratio is at most a few hundred)
// and writes only if none of them has its destination. Exactly one block
// writes each destination, so the result is the sequential one with no
// race. The TPU wrapper's padded-first sort, which made a real write to row
// 0 win over padded slots redirected there, is not needed: padded and
// out-of-range slots write nothing.
#include "rows.cuh"

namespace {

template <typename U>
__global__ void consolidate_gather_kernel(const U* __restrict__ src, long long n_rows,
                                          long long row_units, const int* __restrict__ ids,
                                          U* __restrict__ out) {
  const long long j = blockIdx.x;
  const int id = ids[j];
  U* dst = out + j * row_units;
  if (id < 0) {
    rows::zero_row(dst, row_units);
    return;
  }
  const long long r = id >= n_rows ? n_rows - 1 : id;  // jnp's gather clamps
  rows::copy_row(src + r * row_units, dst, row_units);
}

template <typename U>
__global__ void consolidate_scatter_kernel(U* __restrict__ dst, long long n_rows,
                                           long long row_units, const U* __restrict__ region,
                                           const int* __restrict__ ids, int m) {
  const int j = blockIdx.x;
  const int id = ids[j];
  if (id < 0 || id >= n_rows) return;  // the same for the whole block
  int overridden = 0;
  for (int i = j + 1 + threadIdx.x; i < m; i += blockDim.x) overridden |= ids[i] == id;
  if (__syncthreads_or(overridden)) return;
  rows::copy_row(region + static_cast<long long>(j) * row_units,
                 dst + static_cast<long long>(id) * row_units, row_units);
}

}  // namespace

// out: m rows of row_bytes. Requires n_rows >= 1 and 1 <= m < 2^31.
extern "C" int rt_consolidate_gather(const void* src, long long n_rows, long long row_bytes,
                                     const int* ids, int m, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows::vec16(row_bytes, src, out)) {
    consolidate_gather_kernel<uint4><<<m, rows::kThreads, 0, s>>>(
        static_cast<const uint4*>(src), n_rows, row_bytes / 16, ids, static_cast<uint4*>(out));
  } else {
    consolidate_gather_kernel<uint8_t><<<m, rows::kThreads, 0, s>>>(
        static_cast<const uint8_t*>(src), n_rows, row_bytes, ids, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// dst: n_rows rows of row_bytes, written in place; region: m rows.
// Requires 1 <= m < 2^31.
extern "C" int rt_consolidate_scatter(void* dst, long long n_rows, long long row_bytes,
                                      const void* region, const int* ids, int m,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows::vec16(row_bytes, dst, region)) {
    consolidate_scatter_kernel<uint4><<<m, rows::kThreads, 0, s>>>(
        static_cast<uint4*>(dst), n_rows, row_bytes / 16, static_cast<const uint4*>(region),
        ids, m);
  } else {
    consolidate_scatter_kernel<uint8_t><<<m, rows::kThreads, 0, s>>>(
        static_cast<uint8_t*>(dst), n_rows, row_bytes, static_cast<const uint8_t*>(region),
        ids, m);
  }
  return static_cast<int>(cudaGetLastError());
}
