// GQA attention, causal or not, in the heads-first layout.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention (_flash_kernel),
// as src/repro/kernels/flash_attention/ops.py:gqa_attention calls it.
//
//   q    (B, H, S, hd)     float32 or bf16, H = KVH * G
//   k, v (B, KVH, Sk, hd)  the same dtype
//   out  (B, H, S, hd)     q's dtype
//
// Query head kvh*G+g at position s attends to the keys k_pos <= s (causal)
// or to all Sk keys, with scale hd^-0.5 and the softmax in float32.
//
// Bound on the H100: operations. A causal pass does 4*B*H*hd*S(S+1)/2
// flops on 2 bytes per element read (qwen2-0.5b's prefill: 7.5 GFLOP on
// 7.3 MB at S = 1,024), far above the memory line.
//
// Design. The TPU kernel folds the G query heads of a kv head into the
// query rows (a rearrange copy in its wrapper) and walks the K tiles in a
// sequential grid axis with the online softmax in VMEM scratch. Here one
// CTA takes a tile of kRows query rows: bq positions of all G query heads
// of one kv head (bq = 64 / G; heads are split into chunks of 64 only for
// G > 64), read where they lie in q's layout, so each K/V tile is loaded
// once for the whole group. The CTA walks the K/V tiles of kKeys keys in
// order with a running max, sum and float32 accumulator per row, and stops
// at the last tile that holds a key at or below its last position: a tile
// wholly above the diagonal would leave every running max unchanged and add
// nothing. Q, K and V are held in shared memory as float32 (K and Q rows
// padded by one float, the probability rows by four, so that the loops
// below are free of bank conflicts). 256 threads: thread t owns rows
// 4*(t/16) .. +3 and, within them, keys t%16 + 16*j (scores) and output
// columns t%16 + 16*c (accumulator); the row max and sum reduce across the
// 16 lanes of a half warp. Every product and sum is a float32 FMA, so bf16
// inputs lose nothing beyond their own rounding (the reference upcasts to
// float32). A row with no key yet (Sk = 0) keeps a sum of 0 and writes
// 0 / 1e-30 = 0. wgmma and TMA are for a later kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows (head, position) per CTA
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kLanes = 16;  // threads that share a group of 4 rows
constexpr int kRowsPer = kRows / (kThreads / kLanes);  // 4 rows per thread
constexpr int kKeysPer = kKeys / kLanes;               // 4 keys per thread
constexpr int kPStride = kKeys + 4;
static_assert(kRowsPer == 4 && kKeysPer == 4, "the micro-tile is 4 rows x 4 keys");

template <typename T> struct Vec;  // elements in one 16-byte vector
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

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

size_t smem_floats(int hd) {
  return static_cast<size_t>(kRows) * (hd + 1)    // Q
         + static_cast<size_t>(kKeys) * (hd + 1)  // K tile
         + static_cast<size_t>(kKeys) * hd        // V tile
         + static_cast<size_t>(kRows) * kPStride;  // probabilities
}

// NC: accumulator columns per thread, hd <= 16 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, int H, int KVH, int G, int S, int Sk, int hd, int gt,
               int bq, int n_qt, int causal, float scale) {
  extern __shared__ float smem[];
  const int qp = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + kRows * qp;
  float* v_s = k_s + kKeys * qp;
  float* p_s = v_s + kKeys * hd;

  // the last query tiles (the most keys under the causal rule) start first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int qt = tile % n_qt, hc = tile / n_qt;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int s0 = qt * bq, g0 = hc * gt;
  const int n_s = min(bq, S - s0), n_g = min(gt, G - g0);
  const int tid = threadIdx.x, rg = tid / kLanes, ln = tid % kLanes;
  constexpr int VN = Vec<T>::n;
  const int vpr = hd / VN;  // 16-byte vectors per row
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g0;

  // 1. the tile's query rows: row r is head g0 + r / bq at position s0 + r % bq
  for (int i = tid; i < kRows * vpr; i += kThreads) {
    const int r = i / vpr, e = (i % vpr) * VN;
    const int gl = r / bq, sl = r % bq;
    float f[VN];
    if (gl < n_g && sl < n_s) {
      const size_t at = ((head0 + gl) * S + s0 + sl) * hd + e;
      unpack16(*reinterpret_cast<const uint4*>(q + at), f, T());
    } else {
#pragma unroll
      for (int u = 0; u < VN; ++u) f[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VN; ++u) q_s[r * qp + e + u] = f[u];
  }
  int pos[kRowsPer];  // a row past the tile computes at s0 and is not stored
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int sl = (rg * kRowsPer + i) % bq;
    pos[i] = s0 + (sl < n_s ? sl : 0);
  }
  const int n_keys = causal ? min(Sk, s0 + n_s) : Sk;
  const int n_kt = (n_keys + kKeys - 1) / kKeys;
  const size_t kv0 = (static_cast<size_t>(b) * KVH + kvh) * Sk * hd;

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][NC];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's reads (and the Q stores) are done
    // 2. the K and V tile as float32; keys past n_keys are zeros
    for (int i = tid; i < kKeys * vpr; i += kThreads) {
      const int t = i / vpr, e = (i % vpr) * VN;
      float kf[VN], vf[VN];
      if (k0 + t < n_keys) {
        const size_t at = kv0 + static_cast<size_t>(k0 + t) * hd + e;
        unpack16(*reinterpret_cast<const uint4*>(k + at), kf, T());
        unpack16(*reinterpret_cast<const uint4*>(v + at), vf, T());
      } else {
#pragma unroll
        for (int u = 0; u < VN; ++u) kf[u] = vf[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        k_s[t * qp + e + u] = kf[u];
        v_s[t * hd + e + u] = vf[u];
      }
    }
    __syncthreads();
    // 3. scores of 4 rows x 4 keys per thread
    float sc[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) sc[i][j] = 0.f;
    const float* qr = q_s + rg * kRowsPer * qp;
    const float* kr = k_s + ln * qp;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[kRowsPer], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) qv[i] = qr[i * qp + d];
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) kv[j] = kr[j * kLanes * qp + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    // 4. the online softmax; the 16 lanes of a row group hold its 64 keys
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int key = k0 + ln + j * kLanes;
        const bool ok = key < n_keys && (!causal || key <= pos[i]);
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: all p 0
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        sc[i][j] = expf(sc[i][j] - m_use);
        sum += sc[i][j];
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      float* pr = p_s + (rg * kRowsPer + i) * kPStride + ln;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) pr[j * kLanes] = sc[i][j];
    }
    __syncthreads();
    // 5. acc += P V over the tile's keys
    const int kn = min(kKeys, n_keys - k0);
    const float* pr = p_s + rg * kRowsPer * kPStride;
    for (int t = 0; t < kn; ++t) {
      float pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) pv[i] = pr[i * kPStride + t];
      const float* vr = v_s + t * hd + ln;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (ln + c * kLanes < hd) {
          const float vv = vr[c * kLanes];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
  // 6. out = acc / l for the tile's rows
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = rg * kRowsPer + i;
    const int gl = r / bq, sl = r % bq;
    if (gl < n_g && sl < n_s) {
      T* orow = out + ((head0 + gl) * S + s0 + sl) * hd;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = ln + c * kLanes;
        if (col < hd) orow[col] = from_f<T>(acc[i][c] / den);
      }
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
           int S, int Sk, int hd, int causal, float scale, cudaStream_t s) {
  const int G = H / KVH;
  const int gt = G < kRows ? G : kRows;
  const int bq = kRows / gt;
  const int n_qt = (S + bq - 1) / bq, n_hc = (G + gt - 1) / gt;
  const size_t smem = smem_floats(hd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(n_qt) * n_hc, KVH, B);
  flash_attn_fwd<T, NC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KVH, G, S, Sk, hd, gt, bq, n_qt, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
              int S, int Sk, int hd, int causal, float scale, cudaStream_t s) {
  if (hd <= 64) return launch<T, 4>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  if (hd <= 128) return launch<T, 8>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  return launch<T, 16>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
}

}  // namespace

// dtype: 0 float32, 1 bf16. Requires contiguous 16-byte aligned tensors,
// H a multiple of KVH, hd a multiple of 8 up to 256, S >= 1, B and KVH at
// most 65,535.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int B, int H, int KVH, int S, int Sk, int hd, int causal,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH || hd % 8 || hd < 8 || hd > 256 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
