// Weighted int32 bincount: out[b] = sum of w[i] over i with ids[i] == b.
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram/kernel.py:bincount
// (wrapped by histogram/ops.py:_bincount_pallas). Negative ids wrap once
// (id + n_bins, the ops wrapper's and XLA's .at[].add semantics); ids still
// outside [0, n_bins) drop out.
//
// Bound on the H100: bytes, read once, and the atomics. The engine's two
// calls read ids and weights once and write n_bins int32 (access
// histogram: 2,097,152 ids into 3,276,801 bins, 8.9 us of bytes; host
// histogram: 3,276,800 mostly-zero weights into 8,000 bins, 7.8 us). The
// host histogram's ids are gpt // 512, runs of up to 512 equal ids: one
// atomic per element, a grid-stride walk that lets every block touch nearly
// every bin, and a flush of all of them by every block cost it 6 times its
// bytes. The access histogram's ids are scattered (a warp's 32 lanes hold
// 32 distinct pages on the Redis trace), so its floor is 2 M L2 atomics.
//
// Design: the TPU kernel's one-hot compare (O(ids x bins)) is not carried
// over. Ids and weights are read as 16-byte vectors (scalars where a view
// is not 16-byte aligned), every load of an unrolled step issued before
// its adds, and a thread first folds the elements of its vector that share
// the vector's first live bin into one add (a run of equal ids is one add
// per vector). Zero weights and dropped ids skip.
// * Shared path (<= 12,288 bins, the host histogram): each block takes one
//   contiguous slice of the input, adds into a block-private histogram in
//   shared memory with one atomic per lane, and flushes only the bins
//   between the slice's lowest and highest bin (a slice of the host
//   histogram spans a few dozen huge pages, not 8,000). Warp-level
//   aggregation (__match_any_sync and __reduce_add_sync over the lanes of
//   one bin) was measured slower here than the lanes' own shared atomics
//   after the fold, on the ordered and on shuffled pairs, so this path
//   does not use it.
// * Global path (the access histogram): the blocks walk the vectors
//   grid-stride and each lane adds straight into the output, which the
//   wrapper has zeroed. A warp match buys nothing here: the Redis trace's
//   warps hold 32 distinct pages, and matching first where a bin recurs
//   measured slower on the card than the direct adds.
// int32 addition commutes mod 2^32, so any order of atomics is bit-exact.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 12288;    // 48 KB of int32
constexpr int kSharedUnroll = 2;      // 16-byte vectors of ids (and of weights)
constexpr int kGlobalUnroll = 1;      //   a thread loads per step, by path
constexpr int kSharedPerSm = 2;       // blocks per SM, by path
constexpr int kGlobalPerSm = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bin_of(int id, int n_bins, int* bin) {
  const int b = id < 0 ? id + n_bins : id;
  *bin = b;
  return static_cast<unsigned>(b) < static_cast<unsigned>(n_bins);
}

template <int VEC> struct Load;
template <> struct Load<4> {
  using V = int4;
  static __device__ __forceinline__ void unpack(const int4& v, int* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Load<1> {
  using V = int;
  static __device__ __forceinline__ void unpack(int v, int* o) { o[0] = v; }
};

// Adds the VEC-element vectors base + u * kThreads + threadIdx.x (u < U)
// for base = first, first + step, ... below end into `hist` (shared or
// global), and widens [b_min, b_max] to the bins it added to.
template <int VEC, int U>
__device__ __forceinline__ void add_vectors(const int* __restrict__ ids,
                                            const int* __restrict__ w, long long first,
                                            long long end, long long step, int n_bins,
                                            int* hist, int* b_min, int* b_max) {
  using V = typename Load<VEC>::V;
  const V* iv = reinterpret_cast<const V*>(ids);
  const V* wv = reinterpret_cast<const V*>(w);
  for (long long base = first; base < end; base += step) {
    V ib[U], wb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load before any add
      const long long v = base + u * kThreads + threadIdx.x;
      if (v < end) {
        ib[u] = __ldcs(iv + v);
        wb[u] = __ldcs(wv + v);
      } else {
        ib[u] = V{};
        wb[u] = V{};
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int id[VEC], wt[VEC], bin[VEC];
      bool ok[VEC];
      Load<VEC>::unpack(ib[u], id);
      Load<VEC>::unpack(wb[u], wt);
      // fold every element that shares the vector's first live bin into one
      // add (a run of equal ids is one add per vector); the others follow
      int fb = -1, fw = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ok[j] = wt[j] != 0 && bin_of(id[j], n_bins, &bin[j]);
        if (ok[j]) {
          *b_min = min(*b_min, bin[j]);
          *b_max = max(*b_max, bin[j]);
          if (fb < 0 || bin[j] == fb) {
            fb = bin[j];
            fw += wt[j];
            ok[j] = false;
          }
        }
      }
      if (fb >= 0) atomicAdd(&hist[fb], fw);
#pragma unroll
      for (int j = 1; j < VEC; ++j)
        if (ok[j]) atomicAdd(&hist[bin[j]], wt[j]);
    }
  }
}

// Shared path: block b adds the contiguous slice [b * per, (b + 1) * per)
// (per a multiple of 4) into a private histogram and flushes the bins
// between the slice's lowest and highest bin. VEC = 4 reads whole vectors;
// the block whose slice ends the input adds the k % 4 tail.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bincount_slices(const int* __restrict__ ids, const int* __restrict__ w, long long k,
                long long per, int n_bins, int* __restrict__ out) {
  extern __shared__ int4 hist4[];
  __shared__ int s_lo, s_hi;
  int* hist = reinterpret_cast<int*>(hist4);
  for (int i = threadIdx.x; i < n_bins / 4; i += kThreads) hist4[i] = make_int4(0, 0, 0, 0);
  for (int i = (n_bins & ~3) + threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * per;
  const long long hi = min(k, lo + per);
  int b_min = INT_MAX, b_max = -1;
  if (lo < hi) {
    constexpr long long step = static_cast<long long>(kSharedUnroll) * kThreads;
    add_vectors<VEC, kSharedUnroll>(ids, w, lo / VEC, hi / VEC, step, n_bins, hist, &b_min,
                                    &b_max);
    if (VEC > 1 && hi == k && k % VEC)
      add_vectors<1, kSharedUnroll>(ids, w, k - k % VEC, k, step, n_bins, hist, &b_min, &b_max);
  }
  for (int o = 16; o > 0; o >>= 1) {
    b_min = min(b_min, __shfl_xor_sync(kFull, b_min, o));
    b_max = max(b_max, __shfl_xor_sync(kFull, b_max, o));
  }
  if ((threadIdx.x & 31) == 0 && b_max >= 0) {
    atomicMin(&s_lo, b_min);
    atomicMax(&s_hi, b_max);
  }
  __syncthreads();
  if (s_hi < 0) return;  // the slice added nothing
  for (int b = s_lo + threadIdx.x; b <= s_hi; b += kThreads) {
    const int v = hist[b];
    if (v != 0) atomicAdd(&out[b], v);
  }
}

// Global path: the blocks walk the vectors grid-stride, adding straight into
// the zeroed output; block 0 adds the k % 4 tail.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bincount_global(const int* __restrict__ ids, const int* __restrict__ w, long long k,
                int n_bins, int* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * kGlobalUnroll * kThreads;
  int b_min = INT_MAX, b_max = -1;  // unused here
  add_vectors<VEC, kGlobalUnroll>(ids, w,
                                  static_cast<long long>(blockIdx.x) * kGlobalUnroll * kThreads,
                                  k / VEC, step, n_bins, out, &b_min, &b_max);
  if (VEC > 1 && blockIdx.x == 0 && k % VEC)
    add_vectors<1, kGlobalUnroll>(ids, w, k - k % VEC, k, step, n_bins, out, &b_min, &b_max);
}

int n_sm() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int VEC>
void launch(const int* ids, const int* w, long long k, int n_bins, int* out, cudaStream_t s) {
  const bool shared = n_bins <= kSharedBins;
  const long long step =
      static_cast<long long>(kThreads) * (shared ? kSharedUnroll : kGlobalUnroll) * VEC;
  long long grid = (k + step - 1) / step;
  if (shared) {
    grid = std::min<long long>(grid, static_cast<long long>(n_sm()) * kSharedPerSm);
    long long per = (k + grid - 1) / grid;
    per = (per + 3) / 4 * 4;
    grid = (k + per - 1) / per;
    bincount_slices<VEC><<<static_cast<unsigned>(grid), kThreads, n_bins * sizeof(int), s>>>(
        ids, w, k, per, n_bins, out);
  } else {
    grid = std::min<long long>(grid, static_cast<long long>(n_sm()) * kGlobalPerSm);
    bincount_global<VEC><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(ids, w, k, n_bins,
                                                                          out);
  }
}

}  // namespace

// out must hold n_bins zeros on entry; k >= 1. Returns cudaGetLastError()
// after the launch.
extern "C" int rt_bincount(const int* ids, const int* w, long long k, int n_bins, int* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(ids) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    launch<4>(ids, w, k, n_bins, out, s);
  else
    launch<1>(ids, w, k, n_bins, out, s);
  return static_cast<int>(cudaGetLastError());
}
