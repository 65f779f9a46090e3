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
// Keys become order-preserving uint32 (x ^ 0x80000000). Four radix-select
// passes (8-bit digits, most significant first) histogram the digits of the
// keys that match the prefix found so far and narrow down to the k-th
// largest key T and the number of keys greater than T. Each warp counts into
// its own shared-memory histogram; a warp whose lanes all hold one digit
// (the mass ties of the score row, nearly all -1, or no lane in the prefix)
// adds once. An ordered compaction then takes every key > T and the first
// k - count(> T) keys == T in column order (the lowest-column rule under
// ties), and a bitonic sort on (~value << 32 | column) orders the k
// survivors by value desc, column asc. Only integer counts and slots go
// through atomics, and the sort fixes the slots' order, so the result is
// deterministic.
//
// A single CTA per row kept a 13.1 MB row on one SM (36 GB/s of the card's
// 3.35 TB/s). So a row is spread over many CTAs:
//
// * Wide rows (more than kNarrowMax = 2,048 keys) are cut into chunks of
//   1 K-16 K keys, C per row, so that rows x C is about 2 x 132 SMs. Each
//   radix pass is one launch over all chunks: a CTA histograms its chunk,
//   keeps that histogram in global scratch, adds it into the row's
//   histogram, and the last CTA of the row (an atomic ticket after
//   __threadfence) picks the digit and writes the row's prefix and
//   remaining k. A chunk with no key in the prefix reads nothing. The kept histograms give each chunk its
//   count of keys > T and == T without another read, so the compaction
//   launch places ties by the tie counts of the chunks before it, and keys
//   > T by a per-row atomic slot. One CTA per row sorts the k survivors.
//   Six launches in all, no host sync; the row stays in the 50 MB L2 after
//   the first pass.
// * Narrow rows load the row once into shared memory, and one CTA of 256
//   threads does the select, the compaction and a sort sized to k there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // narrow, pass and compaction kernels
constexpr int kWarps = kThreads / 32;
constexpr int kSortThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxK = 4096;
constexpr int kPasses = 4;
constexpr int kNarrowMax = 2048;  // keys of a row held in shared memory
constexpr long long kChunkMin = 1024, kChunkMax = 16384, kChunkAlign = 1024;
constexpr long long kTargetCtas = 264;  // 2 x 132 SMs
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "one thread per digit bin");

__device__ __forceinline__ unsigned to_key(int x) {
  return static_cast<unsigned>(x) ^ 0x80000000u;
}

__device__ __forceinline__ unsigned long long pack(unsigned key, long long col) {
  return (static_cast<unsigned long long>(~key) << 32) |
         static_cast<unsigned long long>(static_cast<unsigned>(col));
}

// The VEC keys of slot s (columns s * VEC .. s * VEC + VEC - 1); keys at or
// past `end` are 0 and flagged out.
template <int VEC>
__device__ __forceinline__ void load_slot(const int* __restrict__ row, long long s,
                                          long long end, unsigned (&key)[VEC],
                                          bool (&in)[VEC]) {
  const long long c0 = s * VEC;
  if constexpr (VEC == 4) {
    // end % 4 == 0, so a slot is either wholly inside or outside
    const bool inside = c0 < end;
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
      in[j] = c0 + j < end;
      key[j] = in[j] ? to_key(row[c0 + j]) : 0u;
    }
  }
}

// Adds a warp's 32 digits (256: not in the prefix) to the warp's histogram,
// once when all lanes share a digit, else one shared atomic per lane.
__device__ __forceinline__ void warp_count(unsigned* hist, unsigned digit, int lane) {
  const unsigned d0 = __shfl_sync(kFull, digit, 0);
  if (__all_sync(kFull, digit == d0)) {
    if (lane == 0 && d0 < 256u) hist[d0] += 32u;
  } else if (digit < 256u) {
    atomicAdd(&hist[digit], 1u);
  }
  __syncwarp();
}

// Inclusive prefix sum of v over the block in thread order; *total gets the
// block's sum. Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = buf[w];
    before += w < warp ? c : 0;
    tot += c;
  }
  __syncthreads();  // buf is rewritten by the next call
  *total = tot;
  return before + incl;
}

// Thread t holds the count of digit 255 - t among the keys in the prefix.
// Returns, in every thread, the digit of the k_rem-th largest of them, and
// sets k_rem to its rank among the keys with that digit.
__device__ __forceinline__ unsigned pick_digit(unsigned count, int& k_rem, int* buf,
                                               int* pick) {
  const int b = 255 - static_cast<int>(threadIdx.x);
  int total;
  const int incl = block_scan(static_cast<int>(count), buf, &total);  // digits >= b
  const int above = incl - static_cast<int>(count);                  // digits > b
  if (above < k_rem && (incl >= k_rem || b == 0)) {
    pick[0] = b;
    pick[1] = k_rem - above;
  }
  __syncthreads();
  const unsigned d = static_cast<unsigned>(pick[0]);
  k_rem = pick[1];
  __syncthreads();  // pick is rewritten by the next call
  return d;
}

// Sorts sel[0, k) ascending, padded to n (a power of two) with ~0.
__device__ void bitonic_sort(unsigned long long* sel, int k, int n) {
  for (int j = k + threadIdx.x; j < n; j += blockDim.x) sel[j] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const unsigned long long a = sel[lo], b = sel[hi];
        if ((a > b) == asc) {
          sel[lo] = b;
          sel[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ void write_out(const unsigned long long* sel, int k, int* out_v, int* out_i) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned long long e = sel[j];
    out_v[j] = static_cast<int>(~static_cast<unsigned>(e >> 32) ^ 0x80000000u);
    out_i[j] = static_cast<int>(e & 0xffffffffull);
  }
}

// ---- narrow rows: one CTA per row, the row in shared memory --------------
// Dynamic shared memory: n_sort survivors (u64), then the width keys.
__global__ void __launch_bounds__(kThreads)
topk_rows_narrow(const int* __restrict__ mat, int width, int k, int n_sort,
                 int* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ unsigned long long narrow_smem[];
  unsigned long long* sel = narrow_smem;
  unsigned* keys = reinterpret_cast<unsigned*>(sel + n_sort);
  __shared__ unsigned warp_hist[kWarps][256];
  __shared__ int buf[kWarps];
  __shared__ int pick[2];
  __shared__ int s_ngt;
  const int* row = mat + static_cast<long long>(blockIdx.x) * width;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_it = (width + kThreads - 1) / kThreads;
  for (int i = tid; i < width; i += kThreads) keys[i] = to_key(row[i]);
  __syncthreads();

  unsigned prefix = 0, mask = 0;
  int k_rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < 256; b += 32) warp_hist[warp][b] = 0;
    __syncwarp();
    for (int it = 0; it < n_it; ++it) {
      const int i = it * kThreads + tid;
      unsigned digit = 256u;
      if (i < width && (keys[i] & mask) == prefix) digit = (keys[i] >> shift) & 0xffu;
      warp_count(warp_hist[warp], digit, lane);
    }
    __syncthreads();
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += warp_hist[w][255 - tid];
    prefix |= pick_digit(c, k_rem, buf, pick) << shift;  // syncs: histograms read
    mask |= 0xffu << shift;
  }
  const unsigned t_key = prefix;
  const int n_gt = k - k_rem;

  if (tid == 0) s_ngt = 0;
  __syncthreads();
  int eq_base = 0;  // ties taken so far, in column order (block-uniform)
  for (int it = 0; it < n_it; ++it) {
    const int i = it * kThreads + tid;
    const unsigned key = i < width ? keys[i] : 0u;
    if (i < width && key > t_key) sel[atomicAdd(&s_ngt, 1)] = pack(key, i);
    if (eq_base < k_rem) {
      const int eq = i < width && key == t_key;
      int total;
      const int r = eq_base + block_scan(eq, buf, &total) - eq;
      if (eq && r < k_rem) sel[n_gt + r] = pack(t_key, i);
      eq_base += total;
    }
  }
  __syncthreads();
  bitonic_sort(sel, k, n_sort);
  write_out(sel, k, vals + static_cast<long long>(blockIdx.x) * k,
            idx + static_cast<long long>(blockIdx.x) * k);
}

// ---- wide rows: C chunks per row -----------------------------------------
// Scratch, per row: hist[kPasses][C][256] the chunks' digit counts of each
// pass, state[kPasses][2] the prefix and remaining k after each pass, and
// (zeroed) row_hist[kPasses][256], ticket[kPasses], n_gt[1].

// One radix pass (shift = 24 - 8 * pass) over chunk blockIdx.x % C of row
// blockIdx.x / C.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
topk_rows_pass(const int* __restrict__ mat, long long width, long long chunk, int C, int k,
               int pass, int* __restrict__ hist, int* __restrict__ row_hist,
               int* __restrict__ ticket, int* __restrict__ state) {
  __shared__ unsigned warp_hist[kWarps][256];
  __shared__ int buf[kWarps];
  __shared__ int pick[2];
  __shared__ int s_last;
  const int row = blockIdx.x / C, c = blockIdx.x % C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int shift = 24 - 8 * pass;
  const long long rp = static_cast<long long>(row) * kPasses + pass;  // (row, pass)
  unsigned prefix = 0, mask = 0;
  int k_rem = k;
  bool skip = false;
  if (pass > 0) {
    prefix = static_cast<unsigned>(state[(rp - 1) * 2]);
    k_rem = state[(rp - 1) * 2 + 1];
    mask = kFull << (shift + 8);
    // the chunk's count of keys in the prefix, from the previous pass
    skip = hist[((rp - 1) * C + c) * 256 + ((prefix >> (shift + 8)) & 0xffu)] == 0;
  }
  for (int b = lane; b < 256; b += 32) warp_hist[warp][b] = 0;
  __syncwarp();
  if (!skip) {  // block-uniform
    const int* r = mat + static_cast<long long>(row) * width;
    const long long end = min(width, (c + 1) * chunk);
    const long long s_end = (end + VEC - 1) / VEC;
    const long long tile = static_cast<long long>(kThreads) * kUnroll;
    for (long long base = c * chunk / VEC; base < s_end; base += tile) {
      unsigned key[kUnroll][VEC];
      bool in[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_slot<VEC>(r, base + u * kThreads + tid, end, key[u], in[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const bool match = in[u][j] && (key[u][j] & mask) == prefix;
          warp_count(warp_hist[warp], match ? (key[u][j] >> shift) & 0xffu : 256u, lane);
        }
      }
    }
  }
  __syncthreads();
  unsigned cnt = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt += warp_hist[w][tid];
  hist[(rp * C + c) * 256 + tid] = static_cast<int>(cnt);
  if (cnt) atomicAdd(&row_hist[rp * 256 + tid], static_cast<int>(cnt));
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&ticket[rp], 1) == C - 1;
  __syncthreads();
  if (!s_last) return;
  // the row's last CTA: every chunk's counts are in row_hist
  __threadfence();
  const unsigned rc = static_cast<unsigned>(__ldcg(&row_hist[rp * 256 + 255 - tid]));
  const unsigned d = pick_digit(rc, k_rem, buf, pick);
  if (tid == 0) {
    state[rp * 2] = static_cast<int>(prefix | d << shift);
    state[rp * 2 + 1] = k_rem;
  }
}

// The ordered compaction of chunk blockIdx.x % C of row blockIdx.x / C into
// the row's k survivors: keys > T at slots from the row's counter, the
// wanted ties at their rank in column order.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
topk_rows_compact(const int* __restrict__ mat, long long width, long long chunk, int C,
                  int k, const int* __restrict__ hist, const int* __restrict__ state,
                  int* __restrict__ n_gt_row, unsigned long long* __restrict__ sel) {
  __shared__ int buf[kWarps];
  __shared__ int s_base;
  __shared__ int s_cnt;
  const int row = blockIdx.x / C, c = blockIdx.x % C;
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(row) * kPasses;
  const unsigned t_key = static_cast<unsigned>(state[(r0 + kPasses - 1) * 2]);
  const int k_rem = state[(r0 + kPasses - 1) * 2 + 1];  // ties wanted
  const int n_gt = k - k_rem;
  const unsigned t_low = t_key & 0xffu;
  const int* tie_hist = hist + (r0 + kPasses - 1) * C * 256;
  // ties in the chunks before this one; keys > T in this one
  int before = 0, gt = 0;
  for (int c2 = tid; c2 < c; c2 += kThreads) before += tie_hist[c2 * 256LL + t_low];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const unsigned d = (t_key >> (24 - 8 * p)) & 0xffu;
    if (static_cast<unsigned>(tid) > d) gt += hist[((r0 + p) * C + c) * 256 + tid];
  }
  int eq_before, n_gt_c;
  block_scan(before, buf, &eq_before);
  block_scan(gt, buf, &n_gt_c);
  const int eq_c = tie_hist[c * 256LL + t_low];
  if (n_gt_c == 0 && !(eq_before < k_rem && eq_c > 0)) return;  // block-uniform
  if (tid == 0) {
    s_base = n_gt_c ? atomicAdd(&n_gt_row[row], n_gt_c) : 0;
    s_cnt = 0;
  }
  __syncthreads();
  const int gt_base = s_base;
  const int eq_end = min(k_rem, eq_before + eq_c);  // ties this chunk supplies
  unsigned long long* out = sel + static_cast<long long>(row) * k;
  const int* r = mat + static_cast<long long>(row) * width;
  const long long end = min(width, (c + 1) * chunk);
  const long long s_end = (end + VEC - 1) / VEC;
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  int eq_base = eq_before;  // ties seen so far in column order (block-uniform)
  // a tile is kUnroll sub-tiles of kThreads slots; in sub-tile u thread tid
  // holds slot base + u * kThreads + tid, so (u, tid, j) order is column order
  for (long long base = c * chunk / VEC; base < s_end; base += tile) {
    unsigned eq[kUnroll];
    bool want_eq = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = base + u * kThreads + tid;
      unsigned key[VEC];
      bool in[VEC];
      load_slot<VEC>(r, s, end, key, in);
      eq[u] = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (in[j] && key[j] > t_key) out[gt_base + atomicAdd(&s_cnt, 1)] = pack(key[j], s * VEC + j);
        if (in[j] && key[j] == t_key) eq[u] |= 1u << j;
      }
      want_eq |= eq[u] != 0;
    }
    if (__syncthreads_or(want_eq && eq_base < eq_end)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int n = __popc(eq[u]);
        int total;
        int rank = eq_base + block_scan(n, buf, &total) - n;
        const long long s = base + u * kThreads + tid;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (eq[u] >> j & 1u) {
            if (rank < k_rem) out[n_gt + rank] = pack(t_key, s * VEC + j);
            ++rank;
          }
        }
        eq_base += total;
      }
    }
    // done: every key > T of the chunk placed and no more ties wanted
    if (__syncthreads_and(s_cnt == n_gt_c && eq_base >= eq_end)) break;
  }
}

// One CTA per row sorts the row's k survivors.
__global__ void __launch_bounds__(kSortThreads)
topk_rows_sort(const unsigned long long* __restrict__ sel_rows, int k, int n_sort,
               int* __restrict__ vals, int* __restrict__ idx) {
  __shared__ unsigned long long sel[kMaxK];
  const long long r = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += kSortThreads) sel[j] = sel_rows[r * k + j];
  bitonic_sort(sel, k, n_sort);
  write_out(sel, k, vals + r * k, idx + r * k);
}

struct Plan {
  bool narrow;
  long long chunk, C;
  long long sel_off, hist_off, state_off, scratch_bytes;  // torch.empty
  long long ticket_off, n_gt_off, zeroed_bytes;            // torch.zeros (row_hist at 0)
};

Plan make_plan(int rows, long long width, int k) {
  Plan p{};
  p.narrow = width <= kNarrowMax;
  if (p.narrow) return p;
  const long long per_row = (kTargetCtas + rows - 1) / rows;
  long long chunk = (width + per_row - 1) / per_row;
  chunk = (chunk + kChunkAlign - 1) / kChunkAlign * kChunkAlign;
  p.chunk = chunk < kChunkMin ? kChunkMin : chunk > kChunkMax ? kChunkMax : chunk;
  p.C = (width + p.chunk - 1) / p.chunk;
  const long long R = rows;
  p.sel_off = 0;
  p.hist_off = R * k * 8;
  p.state_off = p.hist_off + R * kPasses * p.C * 256 * 4;
  p.scratch_bytes = p.state_off + R * kPasses * 2 * 4;
  p.ticket_off = R * kPasses * 256 * 4;
  p.n_gt_off = p.ticket_off + R * kPasses * 4;
  p.zeroed_bytes = p.n_gt_off + R * 4;
  return p;
}

int sort_size(int k) {
  int n = 1;
  while (n < k) n <<= 1;
  return n;
}

template <int VEC>
int launch_wide(const int* mat, int rows, long long width, int k, int* vals, int* idx,
                char* scratch, char* zeroed, const Plan& p, cudaStream_t s) {
  auto* sel = reinterpret_cast<unsigned long long*>(scratch + p.sel_off);
  int* hist = reinterpret_cast<int*>(scratch + p.hist_off);
  int* state = reinterpret_cast<int*>(scratch + p.state_off);
  int* row_hist = reinterpret_cast<int*>(zeroed);
  int* ticket = reinterpret_cast<int*>(zeroed + p.ticket_off);
  int* n_gt = reinterpret_cast<int*>(zeroed + p.n_gt_off);
  const unsigned grid = static_cast<unsigned>(rows * p.C);
  const int C = static_cast<int>(p.C);
  cudaError_t err;
  for (int pass = 0; pass < kPasses; ++pass) {
    topk_rows_pass<VEC><<<grid, kThreads, 0, s>>>(mat, width, p.chunk, C, k, pass, hist,
                                                  row_hist, ticket, state);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  topk_rows_compact<VEC><<<grid, kThreads, 0, s>>>(mat, width, p.chunk, C, k, hist, state,
                                                   n_gt, sel);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  topk_rows_sort<<<rows, kSortThreads, 0, s>>>(sel, k, sort_size(k), vals, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_topk_max_k() { return kMaxK; }

// sizes[0]: bytes of scratch the wrapper allocates (uninitialised), sizes[1]:
// bytes it allocates zeroed, for rt_topk_rows on the same shape.
extern "C" int rt_topk_scratch(int rows, long long width, int k, long long* sizes) {
  const Plan p = make_plan(rows, width, k);
  sizes[0] = p.scratch_bytes;
  sizes[1] = p.zeroed_bytes;
  return 0;
}

// vals, idx: int32[rows, k]. Requires 0 < k <= min(width, kMaxK), width
// < 2^31, and the two scratch buffers of rt_topk_scratch.
extern "C" int rt_topk_rows(const int* mat, int rows, long long width, int k, int* vals,
                            int* idx, void* scratch, void* zeroed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || k > width) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(rows, width, k);
  if (p.narrow) {
    const int n_sort = sort_size(k);  // at most 24 KB with the keys
    const size_t smem = static_cast<size_t>(n_sort) * 8 + static_cast<size_t>(width) * 4;
    topk_rows_narrow<<<rows, kThreads, smem, s>>>(mat, static_cast<int>(width), k, n_sort,
                                                  vals, idx);
    return static_cast<int>(cudaGetLastError());
  }
  char* sc = static_cast<char*>(scratch);
  char* z = static_cast<char*>(zeroed);
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0)
    return launch_wide<4>(mat, rows, width, k, vals, idx, sc, z, p, s);
  return launch_wide<1>(mat, rows, width, k, vals, idx, sc, z, p, s);
}
