// Per-huge-page hot count: out[r] = sum of hot[r * hp_ratio + j] over j.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hotness_scan/kernel.py:hot_count.
//
// Bound on the H100: bytes. At full width the input is 4,096,000 bool bytes
// (8,000 huge pages x 512 subpages) and the output 8,000 int32.
//
// Design: the bool/uint8 input is read as bytes (the TPU kernel's cast to
// int32 would quadruple the traffic). One warp owns one row: with a row
// length that is a multiple of 16 bytes and an aligned base, each lane reads
// 16-byte vectors and sums their bytes with __dp4a, then the warp reduces
// with shuffles. A 512-byte row is one vector per lane. Any other geometry
// takes a byte loop with the same warp reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void hot_count_vec16(const uint8_t* __restrict__ hot, long long n_hp,
                                int hp_ratio, int* __restrict__ out) {
  long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  int lane = threadIdx.x & 31;
  if (row >= n_hp) return;  // whole warp leaves together
  const uint4* p = reinterpret_cast<const uint4*>(hot + row * hp_ratio);
  const int n_vec = hp_ratio / 16;
  unsigned acc = 0;
  for (int v = lane; v < n_vec; v += 32) {
    uint4 q = p[v];
    acc = __dp4a(q.x, 0x01010101u, acc);
    acc = __dp4a(q.y, 0x01010101u, acc);
    acc = __dp4a(q.z, 0x01010101u, acc);
    acc = __dp4a(q.w, 0x01010101u, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = static_cast<int>(acc);
}

__global__ void hot_count_bytes(const uint8_t* __restrict__ hot, long long n_hp,
                                int hp_ratio, int* __restrict__ out) {
  long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  int lane = threadIdx.x & 31;
  if (row >= n_hp) return;
  const uint8_t* p = hot + row * hp_ratio;
  unsigned acc = 0;
  for (int j = lane; j < hp_ratio; j += 32) acc += p[j];
  acc = warp_sum(acc);
  if (lane == 0) out[row] = static_cast<int>(acc);
}

}  // namespace

extern "C" int rt_hot_count(const uint8_t* hot, long long n_hp, int hp_ratio,
                            int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned grid = static_cast<unsigned>((n_hp + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bool vec = hp_ratio % 16 == 0 && reinterpret_cast<uintptr_t>(hot) % 16 == 0;
  if (vec) {
    hot_count_vec16<<<grid, kWarpsPerBlock * 32, 0, s>>>(hot, n_hp, hp_ratio, out);
  } else {
    hot_count_bytes<<<grid, kWarpsPerBlock * 32, 0, s>>>(hot, n_hp, hp_ratio, out);
  }
  return static_cast<int>(cudaGetLastError());
}
