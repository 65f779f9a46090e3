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
// Shared by both kernels. The TPU kernel folds the G query heads of a kv
// head into the query rows (a rearrange copy in its wrapper) and walks the
// K tiles in a sequential grid axis with the online softmax in VMEM scratch.
// Here one CTA takes a tile of kRows query rows: bq positions of all G query
// heads of one kv head (bq = 64 / G; heads are split into chunks of 64 only
// for G > 64), read where they lie in q's layout, so each K/V tile is loaded
// once for the whole group. The last query tiles (the most keys under the
// causal rule) launch first. The CTA walks the K/V tiles in order with a
// running max, sum and float32 accumulator per row, and stops at the last
// tile that holds a key at or below its last position: a tile wholly above
// the diagonal would leave every running max unchanged and add nothing. A
// row with no key yet (Sk = 0) keeps a sum of 0 and writes 0 / 1e-30 = 0.
//
// float32: flash_attn_fwd. Every product and sum is a float32 FMA on the
// CUDA cores (the float32 rate, 67 TFLOP/s, bounds it): Q, K and V are held
// in shared memory (K and Q rows padded by one float, the probability rows
// by four, so that the loops are free of bank conflicts); 256 threads,
// thread t owns rows 4*(t/16) .. +3 and, within them, keys t%16 + 16*j
// (scores) and output columns t%16 + 16*c (accumulator); the row max and
// sum reduce across the 16 lanes of a half warp.
//
// bf16: flash_attn_bf16, on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulate; wgmma with TMA and a producer warp is the next step).
// The float32 FMA design ran at 31% of the float32 rate, its ceiling, far
// from the 989 TFLOP/s of the bf16 tensor cores. Four warps each own 16 of
// the 64 rows; their Q fragments are loaded once with ldmatrix and stay in
// registers (read again from shared memory for hd > 128). S = Q K^T: bf16 x
// bf16 products are exact in float32, so the scores equal the reference's
// up to the order of the sums. The online softmax runs on the accumulator
// fragments; a row's max and sum reduce over its quad of lanes. P never
// leaves registers: S's m16n8 accumulator layout is the A-fragment layout
// of the next m16n8k16. The reference does P V in float32, and rounding P
// to bf16 (as library kernels do) would err by about 2^-9 of the output's
// scale, beyond one bf16 step wherever an output lies near 0. A hi/lo pair
// of bf16 terms still errs by up to 2^-16 of p; on rows with few keys that
// reached 3.3e-6 against the tolerance's 1e-6 near 0 (B 40, hd 128, S 9).
// So p is split into three bf16 terms, which hold all 24 bits of its
// float32 significand, and O += P V (V by ldmatrix.trans) is float32-exact
// up to the order of the sums: four MMAs per tile where a library kernel
// does two. Each MMA's 16-term sum starts from 0 and is added to its
// accumulator in float32, for S and for O: chaining a large accumulator
// through the tensor cores rounds more coarsely (kernels/flash_attention/
// accuracy.py counts the outputs off the plain version and off a float64
// softmax). K/V tiles of 64 keys (32 for hd > 128, where the
// accumulator takes 128 registers) go by 16-byte cp.async into a double
// buffer, so tile j+1 loads while tile j computes; keys past the end are
// zero-filled by the copy. Rows are padded by 8 bf16 so that ldmatrix's
// eight row addresses fall on distinct banks, and hd is zero-padded to a
// multiple of 16 (16, 32, 64, 128 or 256).
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

__device__ __forceinline__ void unpack16(const uint4& u, float* o) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}

size_t smem_floats(int hd) {
  return static_cast<size_t>(kRows) * (hd + 1)    // Q
         + static_cast<size_t>(kKeys) * (hd + 1)  // K tile
         + static_cast<size_t>(kKeys) * hd        // V tile
         + static_cast<size_t>(kRows) * kPStride;  // probabilities
}

// NC: accumulator columns per thread, hd <= 16 * NC.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int H, int KVH, int G,
               int S, int Sk, int hd, int gt, int bq, int n_qt, int causal, float scale) {
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
  constexpr int VN = 4;
  const int vpr = hd / VN;  // 16-byte vectors per row
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g0;

  // 1. the tile's query rows: row r is head g0 + r / bq at position s0 + r % bq
  for (int i = tid; i < kRows * vpr; i += kThreads) {
    const int r = i / vpr, e = (i % vpr) * VN;
    const int gl = r / bq, sl = r % bq;
    float f[VN];
    if (gl < n_g && sl < n_s) {
      const size_t at = ((head0 + gl) * S + s0 + sl) * hd + e;
      unpack16(*reinterpret_cast<const uint4*>(q + at), f);
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
        unpack16(*reinterpret_cast<const uint4*>(k + at), kf);
        unpack16(*reinterpret_cast<const uint4*>(v + at), vf);
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
      float* orow = out + ((head0 + gl) * S + s0 + sl) * hd;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = ln + c * kLanes;
        if (col < hd) orow[col] = acc[i][c] / den;
      }
    }
  }
}

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
               int S, int Sk, int hd, int causal, float scale, cudaStream_t s) {
  const int G = H / KVH;
  const int gt = G < kRows ? G : kRows;
  const int bq = kRows / gt;
  const int n_qt = (S + bq - 1) / bq, n_hc = (G + gt - 1) / gt;
  const size_t smem = smem_floats(hd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd<NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(n_qt) * n_hc, KVH, B);
  flash_attn_fwd<NC><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, KVH, G, S, Sk, hd, gt, bq, n_qt, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on the tensor cores ---------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as three bf16 pairs whose sum holds every bit of the float32 pair:
// p[0] = bf16(x, y), p[1] = bf16 of the rest, p[2] = bf16 of what remains
__device__ __forceinline__ void split_bf16(float x, float y, unsigned (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    x -= hf.x;
    y -= hf.y;
    p[i] = *reinterpret_cast<const unsigned*>(&h);
  }
}

// HD: hd zero-padded to a multiple of 16; KK: keys per K/V tile.
template <int HD, int KK>
__global__ void __launch_bounds__(kTcThreads)
flash_attn_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int H, int KVH, int G,
                int S, int Sk, int hd, int gt, int bq, int n_qt, int causal, float scale) {
  constexpr int LD = HD + 8;  // shared row stride in bf16
  constexpr int NT = KK / 8;  // score n-tiles of 8 keys
  constexpr int DT = HD / 8;  // output n-tiles of 8 columns
  constexpr int KC = HD / 16;
  constexpr bool kQRegs = HD <= 128;
  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // kRows x LD
  bf16* k_s = q_s + kRows * LD;                  // 2 stages x KK x LD
  bf16* v_s = k_s + 2 * KK * LD;                 // 2 stages x KK x LD

  const int tile = gridDim.x - 1 - blockIdx.x;  // the last query tiles first
  const int qt = tile % n_qt, hc = tile / n_qt;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int s0 = qt * bq, g0 = hc * gt;
  const int n_s = min(bq, S - s0), n_g = min(gt, G - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vpr = hd / 8;  // 16-byte vectors per row
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g0;

  // columns [hd, HD) of every tile are zeros (the copies never write them)
  if (hd < HD) {
    const int pad = HD - hd;
    for (int i = tid; i < (kRows + 4 * KK) * pad; i += kTcThreads)
      q_s[(i / pad) * LD + hd + i % pad] = __float2bfloat16(0.f);
  }
  // 1. the tile's query rows: row r is head g0 + r / bq at position s0 + r % bq
  for (int i = tid; i < kRows * vpr; i += kTcThreads) {
    const int r = i / vpr, e = (i % vpr) * 8;
    const int gl = r / bq, sl = r % bq;
    const bool ok = gl < n_g && sl < n_s;
    cp_async16(q_s + r * LD + e, ok ? q + ((head0 + gl) * S + s0 + sl) * hd + e : q, ok);
  }
  cp_async_commit();

  const int n_keys = causal ? min(Sk, s0 + n_s) : Sk;
  const int n_kt = (n_keys + KK - 1) / KK;
  const size_t kv0 = (static_cast<size_t>(b) * KVH + kvh) * Sk * hd;
  auto load_kv = [&](int kt, int stage) {  // keys past n_keys are zero-filled
    const int k0 = kt * KK;
    for (int i = tid; i < KK * vpr; i += kTcThreads) {
      const int t = i / vpr, e = (i % vpr) * 8;
      const bool ok = k0 + t < n_keys;
      const size_t at = ok ? kv0 + static_cast<size_t>(k0 + t) * hd + e : 0;
      cp_async16(k_s + (stage * KK + t) * LD + e, k + at, ok);
      cp_async16(v_s + (stage * KK + t) * LD + e, v + at, ok);
    }
    cp_async_commit();
  };
  if (n_kt > 0) {
    load_kv(0, 0);
    cp_async_wait<1>();  // Q has landed; the first K/V tile may still fly
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int row0 = warp * 16;
  const int g = lane >> 2, t4 = lane & 3;  // the fragment's row and column pair
  // A fragments of Q: rows row0 + (lane & 15), columns 16 kc + 8 (lane >> 4)
  const bf16* q_frag = q_s + (row0 + (lane & 15)) * LD + (lane >> 4) * 8;
  unsigned qf[kQRegs ? KC : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[kc], q_frag + kc * 16);
  }
  int pos[2];  // a row past the tile computes at s0 and is not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sl = (row0 + g + 8 * h) % bq;
    pos[h] = s0 + (sl < n_s ? sl : 0);
  }
  float o[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // K fragments (B of Q K^T, no transpose): keys 8 (lane >> 4) + (lane & 7),
  // columns 8 ((lane >> 3) & 1); V fragments (B of P V, transposed): keys
  // (lane & 7) + 8 ((lane >> 3) & 1), columns 8 (lane >> 4)
  const int k_frag = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + stage * KK * LD;
    const bf16* vs = v_s + stage * KK * LD;
    // 2. S = Q K^T for the warp's 16 rows and the tile's KK keys
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        ldsm_x4(a, q_frag + kc * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, ks + np * 16 * LD + kc * 16 + k_frag);
        // each 16-term product starts from 0 and is added in float32
        float part[2][4] = {};
        mma_bf16(part[0], a, bk[0], bk[1]);
        mma_bf16(part[1], a, bk[2], bk[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[2 * np][e] += part[0][e];
          sc[2 * np + 1][e] += part[1][e];
        }
      }
    }
    // 3. the online softmax on the fragments: lane holds rows g (e = 0, 1)
    // and g + 8 (e = 2, 3) at keys 8 nt + 2 t4 + (e & 1). Scores are scaled
    // as the reference scales them, and exp(x - m) is taken as
    // exp2((x - m) log2 e): folding log2 e into the scale would round
    // every score by 2^-24 of its size, not of its distance to the max.
    const int k0 = kt * KK;
    const bool edge = k0 + KK > n_keys || (causal && k0 + KK - 1 > s0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        float x = sc[nt][e] * scale;
        if (edge && (key >= n_keys || (causal && key > pos[e >> 1]))) x = -INFINITY;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: all p 0
      const float alpha = exp2f((m[h] - m_use[h]) * kLog2e);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[nt][e] - m_use[e >> 1]) * kLog2e);
        l[e >> 1] += p;
        sc[nt][e] = p;
      }
    // 4. O += P V with P as three bf16 terms; S's accumulators of key
    // n-tiles 2 kc and 2 kc + 1 are the A fragment of keys 16 kc .. + 15
#pragma unroll
    for (int kc = 0; kc < KK / 16; ++kc) {
      unsigned pa[4][3], pt[3][4];
      split_bf16(sc[2 * kc][0], sc[2 * kc][1], pa[0]);
      split_bf16(sc[2 * kc][2], sc[2 * kc][3], pa[1]);
      split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], pa[2]);
      split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], pa[3]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[i][e] = pa[e][i];
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vs + kc * 16 * LD + dp * 16 + v_frag);
        // the 16 keys' sum, smallest term first, added to O in float32
        float part[2][4] = {};
#pragma unroll
        for (int i = 2; i >= 0; --i) {
          mma_bf16(part[0], pt[i], bv[0], bv[1]);
          mma_bf16(part[1], pt[i], bv[2], bv[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * dp][e] += part[0][e];
          o[2 * dp + 1][e] += part[1][e];
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  // 5. out = O / l for the tile's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row0 + g + 8 * h;
    const int gl = r / bq, sl = r % bq;
    if (gl < n_g && sl < n_s) {
      bf16* orow = out + ((head0 + gl) * S + s0 + sl) * hd;
      const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + 2 * t4;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[dt][2 * h] / den, o[dt][2 * h + 1] / den);
      }
    }
  }
}

template <int HD, int KK>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
                int S, int Sk, int hd, int causal, float scale, cudaStream_t s) {
  const int G = H / KVH;
  const int gt = G < kRows ? G : kRows;
  const int bq = kRows / gt;
  const int n_qt = (S + bq - 1) / bq, n_hc = (G + gt - 1) / gt;
  const size_t smem = static_cast<size_t>(kRows + 4 * KK) * (HD + 8) * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attn_bf16<HD, KK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(n_qt) * n_hc, KVH, B);
  flash_attn_bf16<HD, KK><<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, KVH, G, S, Sk, hd, gt, bq, n_qt, causal, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) {
    if (hd <= 64) return launch_f32<4>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
    if (hd <= 128) return launch_f32<8>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
    return launch_f32<16>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 16) return launch_bf16<16, 64>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  if (hd <= 32) return launch_bf16<32, 64>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  if (hd <= 64) return launch_bf16<64, 64>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  if (hd <= 128)
    return launch_bf16<128, 64>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
  return launch_bf16<256, 32>(q, k, v, out, B, H, KVH, S, Sk, hd, causal, scale, s);
}
