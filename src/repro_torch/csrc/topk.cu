// Row-wise top-k of an int32 matrix with jax.lax.top_k's order: values
// descending, ties to the lowest column.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk/kernel.py:topk_rows.
//
// Bound on the H100: bytes, the row read once (13.1 MB at full width: one
// row of 3,276,800 candidate scores, k = 2,048, nearly all -1) plus k pairs
// out. The TPU kernel peels the maximum k times, which would read the row
// 2,048 times; it is not carried over.
//
// Design, one CTA of 1,024 threads per row. One SM reads the row five
// times, so the rate at which it can keep loads in flight bounds the kernel:
// each thread loads 16-byte vectors (4 keys), 4 of them at once, when the
// row allows it (width % 4 == 0 and an aligned base), single keys otherwise.
//   1. Keys become order-preserving uint32 (x ^ 0x80000000). Four radix-
//      select passes (8-bit digits, most significant first) histogram the
//      digits of the keys that match the prefix found so far and narrow down
//      to the k-th largest key T and the number of keys greater than T.
//      Each warp counts into its own shared-memory histogram; a warp whose
//      lanes all hold one digit (the mass ties of the score row, nearly all
//      -1, or no lane in the prefix) adds once, other warps add per lane, so
//      no bin is contended across warps.
//   2. One ordered compaction pass takes every key > T and the first
//      k - count(> T) keys == T in ascending column order (a block-wide
//      prefix of per-thread tie counts, run only for tiles that hold a wanted
//      key == T), which keeps the lowest-column rule under ties; the next
//      tile's keys are loaded before the current ones are processed.
//   3. A bitonic sort of the k survivors in shared memory on the 64-bit key
//      (~value << 32 | column) orders them by value desc, column asc; it
//      reuses the shared memory of the per-warp histograms.
// With rows = 1 this runs on one SM; spreading a row over many CTAs is the
// open redesign.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxK = 4096;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned to_key(int x) {
  return static_cast<unsigned>(x) ^ 0x80000000u;
}

__device__ __forceinline__ unsigned long long pack(unsigned key, long long col) {
  return (static_cast<unsigned long long>(~key) << 32) |
         static_cast<unsigned long long>(static_cast<unsigned>(col));
}

// The VEC keys of slot s (columns s * VEC .. s * VEC + VEC - 1); keys past
// the row end are 0 and flagged out.
template <int VEC>
__device__ __forceinline__ void load_slot(const int* __restrict__ row, long long s,
                                          long long width, unsigned (&key)[VEC],
                                          bool (&in)[VEC]) {
  const long long c0 = s * VEC;
  if constexpr (VEC == 4) {
    // width % 4 == 0, so a slot is either wholly inside the row or outside
    const bool inside = c0 < width;
    int4 v = inside ? reinterpret_cast<const int4*>(row)[s] : make_int4(0, 0, 0, 0);
    key[0] = to_key(v.x);
    key[1] = to_key(v.y);
    key[2] = to_key(v.z);
    key[3] = to_key(v.w);
#pragma unroll
    for (int j = 0; j < 4; ++j) in[j] = inside;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      in[j] = c0 + j < width;
      key[j] = in[j] ? to_key(row[c0 + j]) : 0u;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const int* __restrict__ mat, long long width, int k,
                 int* __restrict__ vals, int* __restrict__ idx) {
  // per-warp digit histograms during the select, survivors afterwards
  __shared__ unsigned long long buf[kMaxK];
  __shared__ unsigned hist[256];
  __shared__ int warp_eq[kWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_krem;
  __shared__ int s_ngt;
  unsigned (*warp_hist)[256] = reinterpret_cast<unsigned (*)[256]>(buf);
  unsigned long long* sel = buf;
  static_assert(sizeof(buf) == kWarps * 256 * sizeof(unsigned), "histogram alias");

  const int* row = mat + static_cast<long long>(blockIdx.x) * width;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n_slots = (width + VEC - 1) / VEC;
  const long long tile = static_cast<long long>(kThreads) * kUnroll;  // slots

  // ---- 1. radix select of the k-th largest key ---------------------------
  unsigned prefix = 0, mask = 0;
  int k_rem = k;  // rank (from the top) of the wanted key among prefix matches
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < 256; b += 32) warp_hist[warp][b] = 0;
    __syncwarp();
    for (long long base = 0; base < n_slots; base += tile) {
      unsigned key[kUnroll][VEC];
      bool in[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_slot<VEC>(row, base + u * kThreads + tid, width, key[u], in[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          bool match = in[u][j] && (key[u][j] & mask) == prefix;
          // lanes outside the prefix share the sentinel 256 and add nothing
          unsigned digit = match ? (key[u][j] >> shift) & 0xffu : 256u;
          unsigned d0 = __shfl_sync(kFull, digit, 0);
          if (__all_sync(kFull, digit == d0)) {
            // the common case (mass ties, or no lane in the prefix)
            if (lane == 0 && d0 < 256u) warp_hist[warp][d0] += 32u;
          } else if (match) {
            atomicAdd(&warp_hist[warp][digit], 1u);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    for (int b = tid; b < 256; b += kThreads) {
      unsigned c = 0;
      for (int w = 0; w < kWarps; ++w) c += warp_hist[w][b];
      hist[b] = c;
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0;
      int d = 255;
      for (; d > 0; --d) {
        int c = static_cast<int>(hist[d]);
        if (cum + c >= k_rem) break;
        cum += c;
      }
      s_prefix = prefix | (static_cast<unsigned>(d) << shift);
      s_krem = k_rem - cum;
    }
    __syncthreads();
    prefix = s_prefix;
    k_rem = s_krem;
    mask |= 0xffu << shift;
  }
  const unsigned t_key = prefix;  // the k-th largest key
  const int n_gt = k - k_rem;     // keys strictly greater than t_key

  // ---- 2. ordered compaction --------------------------------------------
  // A tile is kUnroll sub-tiles of kThreads slots; in sub-tile u thread tid
  // holds slot base + u * kThreads + tid, so (u, tid, j) order is column
  // order.
  if (tid == 0) s_ngt = 0;
  __syncthreads();  // also: every warp is done with its histogram
  int eq_base = 0;  // keys == t_key taken so far, in column order (uniform)
  unsigned next[kUnroll][VEC];
  bool next_in[kUnroll][VEC];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    load_slot<VEC>(row, u * kThreads + tid, width, next[u], next_in[u]);
  for (long long base = 0; base < n_slots; base += tile) {
    unsigned eq[kUnroll];  // bit j: key j of the thread's slot is a tie
    bool want_eq = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = base + u * kThreads + tid;
      unsigned key[VEC];
      bool in[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        key[j] = next[u][j];
        in[j] = next_in[u][j];
      }
      load_slot<VEC>(row, s + tile, width, next[u], next_in[u]);
      eq[u] = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (in[j] && key[j] > t_key) sel[atomicAdd(&s_ngt, 1)] = pack(key[j], s * VEC + j);
        if (in[j] && key[j] == t_key) eq[u] |= 1u << j;
      }
      want_eq |= eq[u] != 0;
    }
    if (__syncthreads_or(want_eq && eq_base < k_rem)) {  // block-uniform
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // exclusive prefix of the per-thread tie counts over the block
        const int c = __popc(eq[u]);
        int incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          int y = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += y;
        }
        if (lane == 31) warp_eq[warp] = incl;
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < kWarps; ++w) {
          int cw = warp_eq[w];
          before += w < warp ? cw : 0;
          total += cw;
        }
        int r = eq_base + before + incl - c;
        const long long s = base + u * kThreads + tid;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (eq[u] >> j & 1u) {
            if (r < k_rem) sel[n_gt + r] = pack(t_key, s * VEC + j);
            ++r;
          }
        }
        eq_base += total;
        __syncthreads();  // warp_eq is rewritten by the next sub-tile
      }
    }
  }
  __syncthreads();

  // ---- 3. bitonic sort of the k survivors --------------------------------
  int n = 1;
  while (n < k) n <<= 1;
  for (int j = k + tid; j < n; j += kThreads) sel[j] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n / 2; t += kThreads) {
        int lo = 2 * t - (t & (stride - 1));
        int hi = lo + stride;
        bool asc = (lo & size) == 0;
        unsigned long long a = sel[lo], b = sel[hi];
        if ((a > b) == asc) {
          sel[lo] = b;
          sel[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  int* out_v = vals + static_cast<long long>(blockIdx.x) * k;
  int* out_i = idx + static_cast<long long>(blockIdx.x) * k;
  for (int j = tid; j < k; j += kThreads) {
    unsigned long long e = sel[j];
    unsigned key = ~static_cast<unsigned>(e >> 32);
    out_v[j] = static_cast<int>(key ^ 0x80000000u);
    out_i[j] = static_cast<int>(e & 0xffffffffull);
  }
}

}  // namespace

extern "C" int rt_topk_max_k() { return kMaxK; }

// vals, idx: int32[rows, k]. Requires 0 < k <= min(width, kMaxK).
extern "C" int rt_topk_rows(const int* mat, int rows, long long width, int k,
                            int* vals, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0;
  if (vec) {
    topk_rows_kernel<4><<<rows, kThreads, 0, s>>>(mat, width, k, vals, idx);
  } else {
    topk_rows_kernel<1><<<rows, kThreads, 0, s>>>(mat, width, k, vals, idx);
  }
  return static_cast<int>(cudaGetLastError());
}
