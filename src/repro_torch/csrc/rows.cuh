// Block-wide row copies shared by the row-moving kernels (gather_rows.cu,
// consolidate.cu). A row is row_bytes of any dtype: with row_bytes a
// multiple of 16 and both base pointers 16-byte aligned the block moves
// 16-byte vectors (uint4), otherwise bytes (uint8_t).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kThreads = 256;

// Whether the 16-byte path applies to rows of row_bytes at a and b.
inline bool vec16(long long row_bytes, const void* a, const void* b) {
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// The block copies one row of n units (uint4 or uint8_t).
template <typename U>
__device__ __forceinline__ void copy_row(const U* __restrict__ src, U* __restrict__ dst,
                                         long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The block writes one row of n zero units.
template <typename U>
__device__ __forceinline__ void zero_row(U* __restrict__ dst, long long n) {
  const U zero{};
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = zero;
}

}  // namespace rows
