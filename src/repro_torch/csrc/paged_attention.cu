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
// Bound on the H100: bytes by the roofline, latency in fact. One decode
// step reads the K and V rows of every position below len once (qwen2-0.5b
// at 1,056 tokens: 8 sequences x 2 kv heads x 1,056 rows x 128 B x 2 = 4.3
// MB per layer, 1.3 us at 3.35 TB/s) and does 4 flops per byte, far below
// the card's ~20 float32 flops per byte, so the tensor cores would buy
// nothing. At 4.3 MB a call, the dependent chain of round trips (lens and
// the block table, then K/V, then the partials of the other CTAs) and the
// per-warp latency of a chunk's arithmetic take longer than the bytes.
//
// Design: one launch, one CTA of 8 warps per (split, kvh, b). The
// positions [0, len) are cut into chunks of 8 positions per warp (64, or 32
// where float32 rows of 1 KB leave room for no more), and split s owns
// chunks s, s + n_split, s + 2 n_split, ... So the table entries of every
// chunk a CTA may own follow from n_split alone: they load in one round
// trip together with len and q (every global load of the setup issued
// before any store) into shared memory. The CTA then streams its chunks
// through a ring of three buffers filled by 16-byte cp.async, the next two
// chunks' loads in flight under the current chunk's arithmetic (a sweep of
// ring depths 2-5 on the H100 found none clearly faster than three). K and V
// stay in the input dtype in shared memory (rows padded by 16 bytes) and
// are converted at use; all arithmetic is float32 FMAs on the CUDA cores.
// Inside a chunk no CTA-wide barrier is crossed: each warp owns 8
// positions and keeps its own running max, sum and accumulator for all the
// kv head's query heads (padded to MAXG with q = 0, so that no loop
// branches on G), and each K/V byte is read once for all of them. Scores:
// 8 lanes per position split hd (they read 128 contiguous bytes of the
// row), each holding its eighth of q in registers (hd <= 64), and a
// reduce-scatter of 7 shuffles leaves each lane the sum for one head (two
// for MAXG 16). The softmax of a head runs on the lanes that hold it; p
// and the rescale factor go through a per-warp shared buffer to P.V, where
// each lane owns column pairs lane + 32 dp of every head. At the CTA's end
// each thread merges four outputs of one head over the warps in warp order
// and writes the split's (m, l, acc) to a workspace; thread 0 fences and
// takes a ticket on the (b, kvh) counter. The CTA that draws the last
// ticket merges all splits in split order: each thread loads the partials
// of its four outputs from L2 (__ldcg), up to kMergeBatch splits in one
// round trip, and carries a running max. It writes the counter back to 0,
// so the counters are zeroed once when the workspace is made. A split
// that owns no chunk below len still writes m = -inf, l = 0 and acc = 0
// and takes its ticket.
//
// Invariants:
// * Determinism. The chunk assignment depends on len, the shapes and the
//   caller's split count only (the wrapper's split plan: the shapes and
//   the SM count), never on btab's contents, and every sum runs in a fixed
//   order (positions, warps, then splits; whichever CTA draws the last
//   ticket runs the same merge). So the output is a function of the
//   logical slot order alone: GPAC's physical page moves leave it
//   bit-unchanged, and two calls on the same inputs agree bit for bit.
// * Positions >= len never reach P.V: their rows are not copied, their
//   scores are replaced by -inf (p = 0), and the V row of such a position
//   (stale in the stage, possibly Inf or NaN) is replaced by 0 before the
//   product, so no stale value is ever multiplied by p = 0.
// * len 0 gives 0; len past pps * page is clamped; btab entries are clamped
//   to [0, n_pool). G <= 16 and hd <= 256, hd * sizeof(T) a multiple of 16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTpw = 8;             // positions per warp in a chunk
constexpr int kRound = 4;           // positions a warp scores at once
constexpr int kParts = 32 / kRound; // lanes per position in the score dot product
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;
constexpr int kPad = 16;            // bytes after each staged row
constexpr int kStages = 3;          // the ring's depth
constexpr int kMaxWarps = 8;
constexpr int kMergeBatch = 12;     // splits' partials one thread loads at once
constexpr int kSmemLimit = 227 * 1024 - 1024;  // dynamic, beside the static bytes
constexpr unsigned kFull = 0xffffffffu;

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
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// two adjacent elements of a staged row, as floats
__device__ __forceinline__ float2 load2(const char* row, int pair, float) {
  return *reinterpret_cast<const float2*>(row + pair * 8);
}
__device__ __forceinline__ float2 load2(const char* row, int pair, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + pair * 4));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Plan {  // the launch geometry shared by the host and the kernel
  int warps, chunk, rstride, n_tab;
  size_t stage_bytes, smem;
};

// MAXG bounds G and DP = ceil(hd / 64) the output column pairs per lane.
template <typename T, int MAXG, int DP>
__global__ void __launch_bounds__(256, DP == 1 ? 2 : 1)
paged_attn_decode(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ btab,
                  const int* __restrict__ lens, T* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int* __restrict__ tickets, int KVH, int G, int hd, int n_pool, int page,
                  int pps, int n_split, int rstride, int stage_bytes, float scale) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_last;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = nthreads >> 5, chunk = nwarps * kTpw;
  const int part = lane % kParts, tl = lane / kParts;
  constexpr int VN = Vec<T>::n;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int vpr = row_bytes / 16;  // 16-byte vectors per row
  const int n_pairs = G * hd;
  const int hd2 = hd / 2;

  constexpr int HPL = MAXG / kParts;  // heads whose softmax a lane carries
  char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + static_cast<size_t>(kStages) * stage_bytes);
  float* pw_s = q_s + MAXG * hd;  // per warp: p[kTpw][MAXG], then alpha[MAXG]
  int* tab_s = reinterpret_cast<int*>(pw_s + nwarps * (kTpw + 1) * MAXG);

  // this CTA's chunks: c = split, split + n_split, ... below len. The
  // assignment is a function of n_split alone, so the table entries of every
  // chunk the CTA may own are known before len arrives and load beside it.
  const int cap = pps * page;
  const int n_cap = (cap + chunk - 1) / chunk;           // chunks of the table
  const int n_own = (n_cap - split + n_split - 1) / n_split;  // may own (>= 1)
  const int tpc = (chunk - 1) / page + 2;                // table entries per chunk
  const int* brow = btab + static_cast<size_t>(b) * pps;
  const size_t bh = static_cast<size_t>(b) * KVH + h;
  const int n_tab = n_own * tpc;
  auto page_of = [&](int x) {  // table entry x: page (x % tpc) of chunk x / tpc
    const int k = x / tpc;
    return (split + k * n_split) * chunk / page + (x - k * tpc);
  };
  // every global load of the setup is issued before any store, so that they
  // share one round trip: len, this thread's 16-byte vector of q and its
  // table entry (a longer table or q follows in the loops below)
  const int len_in = lens[b];
  const uint4* qg = reinterpret_cast<const uint4*>(q + bh * n_pairs);
  const int n_qv = n_pairs * static_cast<int>(sizeof(T)) / 16;
  const uint4 qv0 = tid < n_qv ? qg[tid] : make_uint4(0, 0, 0, 0);
  const int pg0 = tid < n_tab ? page_of(tid) : pps;
  const int te0 = pg0 < pps ? brow[pg0] : 0;
  auto put_q = [&](int x, const uint4& u) {
    float f[VN];
    unpack16(u, f, T());
#pragma unroll
    for (int e = 0; e < VN; ++e) q_s[x * VN + e] = f[e];
  };
  if (tid < n_qv) put_q(tid, qv0);
  if (tid < n_tab) tab_s[tid] = min(max(te0, 0), n_pool - 1);
  for (int x = tid + nthreads; x < n_qv; x += nthreads) put_q(x, qg[x]);
  for (int x = tid + nthreads; x < n_tab; x += nthreads) {
    const int pg = page_of(x);
    tab_s[x] = pg < pps ? min(max(brow[pg], 0), n_pool - 1) : 0;
  }
  // q is float32 in shared memory for MAXG heads, 0 past G: the hot loops
  // run every head without a branch, and a padded head's results are never
  // written
  for (int i = n_pairs + tid; i < MAXG * hd; i += nthreads) q_s[i] = 0.f;
  const int len = max(0, min(len_in, cap));
  const int n_chunks = (len + chunk - 1) / chunk;
  const int n_loc = n_chunks > split ? (n_chunks - split - 1) / n_split + 1 : 0;
  __syncthreads();

  const size_t pool = static_cast<size_t>(n_pool) * page * hd;
  const char* kbase = reinterpret_cast<const char*>(kp + bh * pool);
  const char* vbase = reinterpret_cast<const char*>(vp + bh * pool);
  const int chunk_bytes = chunk * rstride;
  auto chunk_of = [&](int i) { return split + i * n_split; };  // the CTA's i-th chunk
  auto issue = [&](int i) {  // the i-th chunk into stage i % kStages
    const int t0 = chunk_of(i) * chunk;
    const int nv = min(chunk, len - t0);
    const int* tab = tab_s + i * tpc - t0 / page;  // indexed by page
    char* ks = ring + (i % kStages) * stage_bytes;
    char* vs = ks + chunk_bytes;
    for (int x = tid; x < nv * vpr; x += nthreads) {
      const int t = x / vpr, e = x - t * vpr;
      const int j = t0 + t;
      const int pg = j / page;
      const size_t off =
          (static_cast<size_t>(tab[pg]) * page + (j - pg * page)) * row_bytes + e * 16;
      cp_async16(ks + t * rstride + e * 16, kbase + off);
      cp_async16(vs + t * rstride + e * 16, vbase + off);
    }
  };

  // lane (tl, part) scores position tl of each round of 4 against every
  // head over an eighth of hd (8 lanes on one row read 128 contiguous
  // bytes), then carries the softmax of heads [part * HPL, part * HPL +
  // HPL); every lane accumulates output column pairs lane + 32 * dp of all
  // heads. For hd <= 64 (QREG) the lane's eighth of q lives in registers.
  constexpr bool QREG = DP == 1;
  constexpr int NVL = 8 / VN;  // a lane's 16-byte vectors of a row at hd 64
  for (int s = 0; s < kStages - 1; ++s) {  // the first chunks' copies, first
    if (s < n_loc) issue(s);
    cp_async_commit();
  }
  float m_w[HPL], l_w[HPL], acc[MAXG][DP][2];
#pragma unroll
  for (int i = 0; i < HPL; ++i) {
    m_w[i] = -INFINITY;
    l_w[i] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int dp = 0; dp < DP; ++dp) acc[g][dp][0] = acc[g][dp][1] = 0.f;
  float q_r[QREG ? MAXG : 1][QREG ? 8 : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < NVL; ++i)
#pragma unroll
        for (int x = 0; x < VN; ++x) {
          const int v = part + kParts * i;
          q_r[g][i * VN + x] = v < vpr ? q_s[g * hd + v * VN + x] : 0.f;
        }
  }
  float* pw = pw_s + warp * (kTpw + 1) * MAXG;
  for (int i = 0; i < n_loc; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();               // everyone's; and chunk i-1's stage is free
    if (i + kStages - 1 < n_loc) issue(i + kStages - 1);
    cp_async_commit();

    const char* ks = ring + (i % kStages) * stage_bytes;
    const char* vs = ks + chunk_bytes;
    const int nv = min(chunk, len - chunk_of(i) * chunk);
    float mine[kTpw / kRound][HPL];
    bool valid[kTpw / kRound];
#pragma unroll
    for (int r = 0; r < kTpw / kRound; ++r) {
      // 1. this lane's position of round r against every head, over an
      // eighth of hd
      const int t = warp * kTpw + r * kRound + tl;
      valid[r] = t < nv;
      float sc[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
      const char* krow = ks + t * rstride;
      if constexpr (QREG) {
        // read even a row past len (a stale row of the stage, finite or
        // not): its score is replaced by -inf below, and no other
        // position's sum sees it
#pragma unroll
        for (int i2 = 0; i2 < NVL; ++i2) {
          const int v = part + kParts * i2;
          if (v < vpr) {
            float kf[VN];
            unpack16(*reinterpret_cast<const uint4*>(krow + v * 16), kf, T());
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
#pragma unroll
              for (int x = 0; x < VN; ++x) sc[g] = fmaf(q_r[g][i2 * VN + x], kf[x], sc[g]);
          }
        }
      } else if (valid[r]) {
        for (int v = part; v < vpr; v += kParts) {
          float kf[VN];
          unpack16(*reinterpret_cast<const uint4*>(krow + v * 16), kf, T());
          const float* qv = q_s + v * VN;
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
#pragma unroll
            for (int x = 0; x < VN; x += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qv + g * hd + x);
              sc[g] = fmaf(qq.x, kf[x], sc[g]);
              sc[g] = fmaf(qq.y, kf[x + 1], sc[g]);
              sc[g] = fmaf(qq.z, kf[x + 2], sc[g]);
              sc[g] = fmaf(qq.w, kf[x + 3], sc[g]);
            }
          }
        }
      }
      // 2. sum the eight parts, each lane keeping its HPL heads (lane bit
      // 4 picks the upper half of the heads, bit 2 the upper half of that,
      // bit 1 the upper half again)
      float h4[MAXG / 2], h2[MAXG / 4];
      const bool b4 = lane & 4, b2 = lane & 2, b1 = lane & 1;
#pragma unroll
      for (int j = 0; j < MAXG / 2; ++j)
        h4[j] = (b4 ? sc[j + MAXG / 2] : sc[j]) +
                __shfl_xor_sync(kFull, b4 ? sc[j] : sc[j + MAXG / 2], 4);
#pragma unroll
      for (int j = 0; j < MAXG / 4; ++j)
        h2[j] = (b2 ? h4[j + MAXG / 4] : h4[j]) +
                __shfl_xor_sync(kFull, b2 ? h4[j] : h4[j + MAXG / 4], 2);
#pragma unroll
      for (int j = 0; j < HPL; ++j)
        mine[r][j] = (b1 ? h2[j + HPL] : h2[j]) +
                     __shfl_xor_sync(kFull, b1 ? h2[j] : h2[j + HPL], 1);
    }
    // 3. the warp's online softmax over its 8 positions, for the lane's heads
#pragma unroll
    for (int j = 0; j < HPL; ++j) {
      const int g = part * HPL + j;
      float s[kTpw / kRound], mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kTpw / kRound; ++r) {
        s[r] = valid[r] ? mine[r][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[r]);
      }
#pragma unroll
      for (int o = kParts; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_w[j], mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_w[j] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int r = 0; r < kTpw / kRound; ++r) {
        const float p = valid[r] ? expf(s[r] - m_new) : 0.f;
        ps += p;
        pw[(r * kRound + tl) * MAXG + g] = p;
      }
#pragma unroll
      for (int o = kParts; o < 32; o <<= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l_w[j] = l_w[j] * alpha + ps;
      m_w[j] = m_new;
      if (tl == 0) pw[kTpw * MAXG + g] = alpha;
    }
    __syncwarp();
    // 4. acc = acc * alpha + P.V over the warp's positions below len only
#pragma unroll
    for (int g4 = 0; g4 < MAXG; g4 += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(pw + kTpw * MAXG + g4);
      const float al[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int dp = 0; dp < DP; ++dp) {
          acc[g4 + u][dp][0] *= al[u];
          acc[g4 + u][dp][1] *= al[u];
        }
    }
    // a position past len has p = 0, and its V row (stale, possibly Inf
    // or NaN) is replaced by 0 before the product
    const int nt = min(max(nv - warp * kTpw, 0), kTpw);
#pragma unroll
    for (int tt = 0; tt < kTpw; ++tt) {
      const char* vrow = vs + (warp * kTpw + tt) * rstride;
      float2 vv[DP];
#pragma unroll
      for (int dp = 0; dp < DP; ++dp) {
        const int pr = lane + 32 * dp;
        const float2 x = pr < hd2 ? load2(vrow, pr, T()) : make_float2(0.f, 0.f);
        vv[dp] = tt < nt ? x : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int g4 = 0; g4 < MAXG; g4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + tt * MAXG + g4);
        const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int dp = 0; dp < DP; ++dp) {
            acc[g4 + u][dp][0] = fmaf(pp[u], vv[dp].x, acc[g4 + u][dp][0]);
            acc[g4 + u][dp][1] = fmaf(pp[u], vv[dp].y, acc[g4 + u][dp][1]);
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // merge the warps in warp order into the split's (m, l, acc)
  float* w_acc = reinterpret_cast<float*>(ring);                 // [nwarps][G * hd]
  float* w_ml = w_acc + static_cast<size_t>(nwarps) * n_pairs;  // [nwarps][G][2]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
#pragma unroll
      for (int dp = 0; dp < DP; ++dp) {
        const int pr = lane + 32 * dp;
        if (pr < hd2) {
          float* dst = w_acc + static_cast<size_t>(warp) * n_pairs + g * hd + 2 * pr;
          dst[0] = acc[g][dp][0];
          dst[1] = acc[g][dp][1];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < HPL; ++j) {
    const int g = part * HPL + j;
    if (tl == 0 && g < G) {
      w_ml[(warp * G + g) * 2] = m_w[j];
      w_ml[(warp * G + g) * 2 + 1] = l_w[j];
    }
  }
  __syncthreads();
  // each thread: 4 outputs of one head, the warps' factors exp(m_w - m)
  // (an empty warp's is 0) computed where they are used
  float* pa = part_acc + (bh * n_split + split) * n_pairs;
  float* pm = part_ml + (bh * n_split + split) * G * 2;
  for (int i4 = tid; i4 < n_pairs / 4; i4 += nthreads) {
    const int g = i4 * 4 / hd;
    float m[kMaxWarps];
    float4 a[kMaxWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      if (w < nwarps) {
        m[w] = w_ml[(w * G + g) * 2];
        a[w] = reinterpret_cast<const float4*>(w_acc + static_cast<size_t>(w) * n_pairs)[i4];
        mx = fmaxf(mx, m[w]);
      }
    }
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      if (w < nwarps) {
        const float f = m[w] == -INFINITY ? 0.f : expf(m[w] - mx);
        num = make_float4(fmaf(f, a[w].x, num.x), fmaf(f, a[w].y, num.y),
                          fmaf(f, a[w].z, num.z), fmaf(f, a[w].w, num.w));
        den = fmaf(f, w_ml[(w * G + g) * 2 + 1], den);
      }
    }
    reinterpret_cast<float4*>(pa)[i4] = num;
    if (i4 * 4 - g * hd == 0) {
      pm[2 * g] = mx;
      pm[2 * g + 1] = den;
    }
  }

  // the last CTA of this (b, kvh) to finish merges the ranges in split
  // order: the barrier orders the CTA's partials before thread 0's fence
  // and ticket (release), and the last CTA's fence after its ticket before
  // its reads (acquire)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&tickets[bh], 1) == n_split - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  // each thread: 4 outputs of one head over every split, in split order,
  // kMergeBatch splits' partials loaded at once from L2, carried as a
  // running max, denominator and numerator
  const float* pm0 = part_ml + bh * n_split * G * 2;
  const float4* pa0 = reinterpret_cast<const float4*>(part_acc + bh * n_split * n_pairs);
  T* o = out + bh * n_pairs;
  for (int i4 = tid; i4 < n_pairs / 4; i4 += nthreads) {
    const int g = i4 * 4 / hd;
    float mx = -INFINITY, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += kMergeBatch) {
      float2 ml[kMergeBatch];
      float4 a[kMergeBatch];
      float bm = -INFINITY;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (s0 + u < n_split) {
          ml[u] = __ldcg(reinterpret_cast<const float2*>(pm0) + (s0 + u) * G + g);
          a[u] = __ldcg(pa0 + static_cast<size_t>(s0 + u) * (n_pairs / 4) + i4);
          bm = fmaxf(bm, ml[u].x);
        }
      }
      const float m_new = fmaxf(mx, bm);
      const float r = m_new == -INFINITY ? 1.f : expf(mx - m_new);  // 0 on the first batch
      num = make_float4(num.x * r, num.y * r, num.z * r, num.w * r);
      den *= r;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (s0 + u < n_split) {
          const float w = ml[u].x == -INFINITY ? 0.f : expf(ml[u].x - m_new);  // empty: 0
          num = make_float4(fmaf(w, a[u].x, num.x), fmaf(w, a[u].y, num.y),
                            fmaf(w, a[u].z, num.z), fmaf(w, a[u].w, num.w));
          den = fmaf(w, ml[u].y, den);
        }
      }
      mx = m_new;
    }
    den = fmaxf(den, 1e-30f);  // len 0: every weight 0, the output 0
    o[4 * i4] = from_f<T>(num.x / den);
    o[4 * i4 + 1] = from_f<T>(num.y / den);
    o[4 * i4 + 2] = from_f<T>(num.z / den);
    o[4 * i4 + 3] = from_f<T>(num.w / den);
  }
  if (tid == 0) tickets[bh] = 0;  // ready for the next call on this workspace
}

// The launch geometry: 8 warps (64-position chunks), or 4 where a ring of
// three 64-position stages would not fit (float32 rows of 1 KB). After the
// chunk loop the whole buffer holds the warps' states, then the split
// weights.
template <typename T>
Plan plan(int G, int maxg, int hd, int page, int pps, int n_split) {
  Plan p{};
  p.rstride = hd * static_cast<int>(sizeof(T)) + kPad;
  for (int warps = 8; warps >= 4; warps /= 2) {
    p.warps = warps;
    p.chunk = warps * kTpw;
    p.stage_bytes = 2 * static_cast<size_t>(p.chunk) * p.rstride;
    const int n_chunks = (pps * page + p.chunk - 1) / p.chunk;
    const int per = (n_chunks + n_split - 1) / n_split;
    p.n_tab = per * ((p.chunk - 1) / page + 2);
    const size_t fixed = (static_cast<size_t>(maxg) * hd + warps * (kTpw + 1) * maxg) * 4 +
                         static_cast<size_t>(p.n_tab) * 4;  // q, p and alpha, the table
    const size_t warp_state = static_cast<size_t>(warps) * G * (hd + 2) * 4;
    p.smem = std::max(kStages * p.stage_bytes + fixed, warp_state);
    if (p.smem <= static_cast<size_t>(kSmemLimit)) break;
  }
  return p;
}

template <typename T, int MAXG, int DP>
int launch_t(const void* q, const void* k, const void* v, const int* btab, const int* lens,
             void* out, float* part_acc, float* part_ml, int* tickets, int B, int KVH, int G,
             int hd, int n_pool, int page, int pps, int n_split, float scale,
             cudaStream_t s) {
  const Plan p = plan<T>(G, MAXG, hd, page, pps, n_split);
  if (p.smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.smem > 48 * 1024) {  // the attribute is the current device's: set it on every call
    cudaError_t err = cudaFuncSetAttribute(paged_attn_decode<T, MAXG, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_split, KVH, B);
  paged_attn_decode<T, MAXG, DP><<<grid, p.warps * 32, p.smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), btab,
      lens, static_cast<T*>(out), part_acc, part_ml, tickets, KVH, G, hd, n_pool, page, pps,
      n_split, p.rstride, static_cast<int>(p.stage_bytes), scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* btab, const int* lens,
           void* out, float* part_acc, float* part_ml, int* tickets, int B, int KVH, int G,
           int hd, int n_pool, int page, int pps, int n_split, float scale,
           cudaStream_t s) {
  if (G <= 8 && hd <= 64)
    return launch_t<T, 8, 1>(q, k, v, btab, lens, out, part_acc, part_ml, tickets, B, KVH, G,
                             hd, n_pool, page, pps, n_split, scale, s);
  return launch_t<T, kMaxG, kMaxHd / 64>(q, k, v, btab, lens, out, part_acc, part_ml, tickets,
                                        B, KVH, G, hd, n_pool, page, pps, n_split, scale, s);
}

}  // namespace

// dtype: 0 float32, 1 bf16. Requires G <= 16, hd <= 256, hd * sizeof(T) a
// multiple of 16 and 16-byte aligned pools; part_acc holds
// B*KVH*n_split*G*hd floats, part_ml B*KVH*n_split*G*2, and tickets B*KVH
// ints that are 0 on entry (and are 0 again when the kernel ends).
extern "C" int rt_paged_attention(const void* q, const void* k, const void* v,
                                  const int* btab, const int* lens, void* out,
                                  float* part_acc, float* part_ml, int* tickets, int B,
                                  int KVH, int G, int hd, int n_pool, int page, int pps,
                                  int n_split, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || hd > kMaxHd || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, btab, lens, out, part_acc, part_ml, tickets, B, KVH, G, hd,
                         n_pool, page, pps, n_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, btab, lens, out, part_acc, part_ml, tickets, B, KVH,
                                 G, hd, n_pool, page, pps, n_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
