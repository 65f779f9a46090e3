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
// 256-thread block), otherwise bytes. An id is read once per block, wrapped
// once if negative and clamped to [0, n_rows), as jnp's rows[ids] does, so
// the kernel matches the reference on any input.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_row(int id, long long n_rows) {
  long long r = id < 0 ? id + n_rows : id;
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

__global__ void gather_rows_vec16(const uint4* __restrict__ rows, long long n_rows,
                                  long long row_vecs, const int* __restrict__ ids,
                                  uint4* __restrict__ out) {
  const long long j = blockIdx.x;
  const uint4* src = rows + clamp_row(ids[j], n_rows) * row_vecs;
  uint4* dst = out + j * row_vecs;
  for (long long v = threadIdx.x; v < row_vecs; v += blockDim.x) dst[v] = src[v];
}

__global__ void gather_rows_bytes(const uint8_t* __restrict__ rows, long long n_rows,
                                  long long row_bytes, const int* __restrict__ ids,
                                  uint8_t* __restrict__ out) {
  const long long j = blockIdx.x;
  const uint8_t* src = rows + clamp_row(ids[j], n_rows) * row_bytes;
  uint8_t* dst = out + j * row_bytes;
  for (long long b = threadIdx.x; b < row_bytes; b += blockDim.x) dst[b] = src[b];
}

}  // namespace

// out: m rows of row_bytes. Requires n_rows >= 1 and 1 <= m < 2^31.
extern "C" int rt_gather_rows(const void* rows, long long n_rows, long long row_bytes,
                              const int* ids, long long m, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0;
  unsigned grid = static_cast<unsigned>(m);
  if (vec) {
    gather_rows_vec16<<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(rows), n_rows, row_bytes / 16, ids,
        static_cast<uint4*>(out));
  } else {
    gather_rows_bytes<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(rows), n_rows, row_bytes, ids,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
