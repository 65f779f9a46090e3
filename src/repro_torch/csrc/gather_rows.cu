// Row gather: out[j] = rows[ids[j]], a pure bit copy of row_bytes per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiered_lookup/kernel.py:gather_rows
// (Algorithm 1's payload copy, consolidator.py:122-126).
//
// Bound on the H100: bytes. At full width one launch copies 512 rows of
// 4 KiB (one base page of 1,024 float32 each) out of a pool of 819,200 or
// 3,276,800 rows: 2.1 MB read and 2.1 MB written.
//
// Design: the kernel never looks at the dtype. One block copies one output
// row; with row_bytes a multiple of 16 and both pointers 16-byte aligned the
// threads move 16-byte vectors (a 4 KiB row is one vector per thread of a
// 256-thread block), otherwise bytes (rows.cuh). An id is read once per
// block, wrapped once if negative and clamped to [0, n_rows), as jnp's
// rows[ids] does, so the kernel matches the reference on any input.
#include "rows.cuh"

namespace {

__device__ __forceinline__ long long clamp_row(int id, long long n_rows) {
  long long r = id < 0 ? id + n_rows : id;
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ rows, long long n_rows,
                                   long long row_units, const int* __restrict__ ids,
                                   U* __restrict__ out) {
  const long long j = blockIdx.x;
  rows::copy_row(rows + clamp_row(ids[j], n_rows) * row_units, out + j * row_units,
                 row_units);
}

}  // namespace

// out: m rows of row_bytes. Requires n_rows >= 1 and 1 <= m < 2^31.
extern "C" int rt_gather_rows(const void* rows, long long n_rows, long long row_bytes,
                              const int* ids, long long m, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned grid = static_cast<unsigned>(m);
  if (rows::vec16(row_bytes, rows, out)) {
    gather_rows_kernel<uint4><<<grid, rows::kThreads, 0, s>>>(
        static_cast<const uint4*>(rows), n_rows, row_bytes / 16, ids,
        static_cast<uint4*>(out));
  } else {
    gather_rows_kernel<uint8_t><<<grid, rows::kThreads, 0, s>>>(
        static_cast<const uint8_t*>(rows), n_rows, row_bytes, ids,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
