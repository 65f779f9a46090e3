// Weighted int32 bincount: out[b] = sum of w[i] over i with ids[i] == b.
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram/kernel.py:bincount
// (wrapped by histogram/ops.py:_bincount_pallas). Negative ids wrap once
// (id + n_bins, the ops wrapper's and XLA's .at[].add semantics); ids still
// outside [0, n_bins) drop out.
//
// Bound on the H100: bytes. The engine's two calls read ids and weights once
// and write n_bins int32 (access histogram: 2,097,152 ids into 3,276,801
// bins; host histogram: 3,276,800 mostly-zero weights into 8,000 bins).
//
// Design: the TPU kernel's one-hot compare (O(ids x bins), 7e12 compares at
// full width) is not carried over. When the bins fit in shared memory
// (<= 12,288 int32, 48 KB) each block privatises the histogram there, adds
// with shared-memory atomics and flushes one global atomicAdd per non-zero
// bin. Larger histograms take global atomicAdd straight into the output,
// which the wrapper has zeroed. Zero weights are skipped in both. int32
// addition commutes mod 2^32, so any order of atomics is bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 12288;
constexpr long long kSharedGrid = 264;    // two blocks per SM
constexpr long long kGlobalGrid = 132 * 16;

__device__ __forceinline__ bool bin_of(int id, int n_bins, int* bin) {
  int b = id < 0 ? id + n_bins : id;
  *bin = b;
  return static_cast<unsigned>(b) < static_cast<unsigned>(n_bins);
}

__global__ void bincount_shared(const int* __restrict__ ids,
                                const int* __restrict__ w, long long k,
                                int n_bins, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < k; i += stride) {
    int wi = w[i];
    int b;
    if (wi != 0 && bin_of(ids[i], n_bins, &b)) atomicAdd(&hist[b], wi);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    int v = hist[b];
    if (v != 0) atomicAdd(&out[b], v);
  }
}

__global__ void bincount_global(const int* __restrict__ ids,
                                const int* __restrict__ w, long long k,
                                int n_bins, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < k; i += stride) {
    int wi = w[i];
    int b;
    if (wi != 0 && bin_of(ids[i], n_bins, &b)) atomicAdd(&out[b], wi);
  }
}

}  // namespace

// out must hold n_bins zeros on entry. Returns cudaGetLastError() after launch.
extern "C" int rt_bincount(const int* ids, const int* w, long long k,
                           int n_bins, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (k + kThreads - 1) / kThreads;
  if (n_bins <= kSharedBins) {
    long long grid = blocks < kSharedGrid ? blocks : kSharedGrid;
    bincount_shared<<<static_cast<unsigned>(grid), kThreads,
                      n_bins * sizeof(int), s>>>(ids, w, k, n_bins, out);
  } else {
    long long grid = blocks < kGlobalGrid ? blocks : kGlobalGrid;
    bincount_global<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        ids, w, k, n_bins, out);
  }
  return static_cast<int>(cudaGetLastError());
}
