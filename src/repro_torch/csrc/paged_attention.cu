// GQA decode attention through a block table, on per-sequence page pools.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py:paged_attention (_paged_attn_kernel).
//
//   q      (B, KVH, G, hd)              float32 or bf16
//   k, v   (B, KVH, n_pool, page, hd)   sequence b's pool, same dtype
//   btab   int32 (B, pps)               logical slot -> page of b's pool
//   lens   int32 (B,)                   positions >= len are masked
//   out    (B, KVH, G, hd)              q's dtype
//
// Bound on the H100: bytes. One decode step reads the K and V rows of every
// position below len once (qwen2-0.5b at 1,056 tokens: 8 sequences x 2 kv
// heads x 1,056 rows x 128 B x 2 = 4.3 MB per layer) and does 4 flops per
// byte read, far below the card's ~20 flops per byte of float32 CUDA-core
// rate.
//
// Design. The TPU kernel walks the pages of one (b, kvh) in a sequential
// grid axis and carries the online softmax in VMEM scratch. Here the
// positions [0, len) are cut into chunks of kChunk logical positions, and
// the chunks into n_split contiguous ranges; one CTA per (range, kvh, b)
// keeps a running max, sum and float32 accumulator over its chunks, and a
// second kernel merges the ranges in order. So 8 sequences x 2 kv heads fill
// the card, and the ranges depend only on len, the shapes and the SM count:
// the result is a function of the logical slot order alone, with no atomics,
// and GPAC's physical page moves leave it bit-unchanged. Chunks past len
// are never read (the reference's masked pages). A chunk's K and V rows are
// read through btab in 16-byte vectors (one page row is hd contiguous
// elements) into shared memory as float32; K rows are padded by one float
// so that the score loop, one thread per (g, position), is conflict-free.
// Scores, the chunk's softmax (one warp per query head) and P.V (one thread
// per (g, d) output) follow. G = 7 is no power of two: the work is sized by
// kChunk and hd, with G only a loop bound. A len of 0 leaves the sums at 0
// and writes 0 / 1e-30 = 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;  // logical positions per chunk (two per lane)
constexpr int kThreads = 256;
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;
constexpr int kMaxAcc = kMaxG * kMaxHd / kThreads;  // (g, d) outputs per thread
static_assert(kChunk == 64, "the softmax stage reads two positions per lane");

template <typename T> struct Vec;  // elements in one 16-byte vector
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* o, float) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* o, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

size_t smem_floats(int G, int hd) {
  return static_cast<size_t>(G) * hd          // q
         + static_cast<size_t>(kChunk) * (hd + 1)  // K chunk, padded rows
         + static_cast<size_t>(kChunk) * hd   // V chunk
         + static_cast<size_t>(G) * kChunk    // scores, then probabilities
         + 3 * static_cast<size_t>(G);        // running max, sum, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                 const int* __restrict__ btab, const int* __restrict__ lens,
                 float* __restrict__ part_acc, float* __restrict__ part_ml, int KVH, int G,
                 int hd, int n_pool, int page, int pps, int n_split, float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ks = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + G * hd;
  float* v_s = k_s + kChunk * ks;
  float* p_s = v_s + kChunk * hd;
  float* m_s = p_s + G * kChunk;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int len = max(0, min(lens[b], pps * page));
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const int per = (n_chunks + n_split - 1) / n_split;
  const int c_lo = split * per, c_hi = min(n_chunks, c_lo + per);

  const size_t bh = static_cast<size_t>(b) * KVH + h;
  const int n_pairs = G * hd;
  for (int i = tid; i < n_pairs; i += kThreads) q_s[i] = to_f(q[bh * n_pairs + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  const size_t pool = static_cast<size_t>(n_pool) * page * hd;
  const T* kbase = kp + bh * pool;
  const T* vbase = vp + bh * pool;
  const int* brow = btab + static_cast<size_t>(b) * pps;
  constexpr int VN = Vec<T>::n;
  const int vpr = hd / VN;  // vectors per row
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int c = c_lo; c < c_hi; ++c) {
    const int t0 = c * kChunk;
    const int nv = min(kChunk, len - t0);  // >= 1
    // 1. the chunk's K and V rows, through the block table, as float32
    for (int i = tid; i < nv * vpr; i += kThreads) {
      const int t = i / vpr, e = (i % vpr) * VN;
      const int j = t0 + t;
      const int phys = min(max(brow[j / page], 0), n_pool - 1);
      const size_t row = (static_cast<size_t>(phys) * page + j % page) * hd + e;
      const uint4 ku = *reinterpret_cast<const uint4*>(kbase + row);
      const uint4 vu = *reinterpret_cast<const uint4*>(vbase + row);
      float kf[VN], vf[VN];
      unpack16(ku, kf, T());
      unpack16(vu, vf, T());
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        k_s[t * ks + e + u] = kf[u];
        v_s[t * hd + e + u] = vf[u];
      }
    }
    __syncthreads();
    // 2. scores, one thread per (g, position); masked positions -inf
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int g = i / kChunk, t = i % kChunk;
      float sc = -INFINITY;
      if (t < nv) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + t * ks;
        float d = 0.f;
        for (int e = 0; e < hd; ++e) d = fmaf(qr[e], kr[e], d);
        sc = d * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // 3. online softmax, one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = p_s + g * kChunk;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: the chunk has a position
      const float e0 = expf(x0 - m_new), e1 = expf(x1 - m_new);
      row[lane] = e0;
      row[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first chunk
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + P V, one thread per (g, d)
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int i = tid + r * kThreads;
      if (i < n_pairs) {
        const int g = i / hd, d = i % hd;
        const float* pr = p_s + g * kChunk;
        float sum = 0.f;
        for (int t = 0; t < nv; ++t) sum = fmaf(pr[t], v_s[t * hd + d], sum);
        acc[r] = acc[r] * a_s[g] + sum;
      }
    }
    __syncthreads();  // the next chunk overwrites k_s, v_s and p_s
  }

  float* pa = part_acc + (bh * n_split + split) * n_pairs;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int i = tid + r * kThreads;
    if (i < n_pairs) pa[i] = acc[r];
  }
  float* pm = part_ml + (bh * n_split + split) * G * 2;
  for (int g = tid; g < G; g += kThreads) {
    pm[2 * g] = m_s[g];
    pm[2 * g + 1] = l_s[g];
  }
}

// Merge the n_split partial sums of each (b, kvh) in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                 T* __restrict__ out, int G, int hd, int n_split) {
  const size_t bh = blockIdx.x;
  const int n_pairs = G * hd;
  const float* pm = part_ml + bh * n_split * G * 2;
  const float* pa = part_acc + bh * n_split * n_pairs;
  for (int i = threadIdx.x; i < n_pairs; i += blockDim.x) {
    const int g = i / hd;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[(s * G + g) * 2]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // else len 0: nothing attended, the output is 0
      for (int s = 0; s < n_split; ++s) {
        const float w = expf(pm[(s * G + g) * 2] - mx);  // an empty split: 0
        num += w * pa[static_cast<size_t>(s) * n_pairs + i];
        den += w * pm[(s * G + g) * 2 + 1];
      }
    }
    out[bh * n_pairs + i] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* btab, const int* lens,
           void* out, float* part_acc, float* part_ml, int B, int KVH, int G, int hd,
           int n_pool, int page, int pps, int n_split, float scale, cudaStream_t s) {
  const size_t smem = smem_floats(G, hd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_split, KVH, B);
  paged_attn_split<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), btab,
      lens, part_acc, part_ml, KVH, G, hd, n_pool, page, pps, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_merge<T><<<B * KVH, kThreads, 0, s>>>(part_acc, part_ml, static_cast<T*>(out),
                                                   G, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bf16. Requires G <= 16, hd <= 256, hd * sizeof(T) a
// multiple of 16 and 16-byte aligned pools; part_acc holds
// B*KVH*n_split*G*hd floats and part_ml B*KVH*n_split*G*2.
extern "C" int rt_paged_attention(const void* q, const void* k, const void* v,
                                  const int* btab, const int* lens, void* out,
                                  float* part_acc, float* part_ml, int B, int KVH, int G,
                                  int hd, int n_pool, int page, int pps, int n_split,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || hd > kMaxHd || n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, btab, lens, out, part_acc, part_ml, B, KVH, G, hd, n_pool,
                         page, pps, n_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, btab, lens, out, part_acc, part_ml, B, KVH, G,
                                 hd, n_pool, page, pps, n_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
