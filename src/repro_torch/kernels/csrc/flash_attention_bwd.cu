// Backward of the causal (or full) prefill attention of flash_attention.cu,
// on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel and
// differentiates its plain `full_attention` (src/repro/models/attention.py)
// with XLA's autodiff.  This is the port's counterpart of that autodiff,
// so that the training forward can run through the prefill kernel (B2) and
// still have its gradient from a kernel.
//
// Given q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], the forward's out and its
// per-row log-sum-exp lse [B, Hq, Sq] (fp32), and dO = dL/d out, it writes
// dq, dk, dv for the same masks as the forward at q_offset = 0: causal
// k <= q, the sliding window k > q - window, the tanh softcap (chain rule
// ds *= 1 - tanh^2(z / cap)), scale 1/sqrt(D) and GQA (dk and dv sum over
// the group's query heads).  Ragged Sq / Sk are masked in the kernels.
// With delta = rowsum(dO O): P = exp(s - lse), dS = P (dP - delta),
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.  In bf16, P and dS are
// rounded to bf16 as the operands of their products, with fp32 sums.
//
// What bounds it on an H100: operations.  Five products of 2 D FLOPs per
// unmasked (query, key) pair and head (S, dP, dV, dK, dQ), half the pairs
// under the causal mask, at 989 TFLOP/s bf16, against ~2 bytes an element
// moved once.  No atomics anywhere, so the same inputs give the same bits
// (resumed training runs stay bit-equal); that costs two recomputed
// products, so the kernels issue seven, on whole 64 x 64 tiles.
//
// bf16, every head dim (32, 64, 128, 256): two launches (three at D = 256).
//   1. dQ, one CTA (one warpgroup) per (batch, query head, 64-query tile),
//      the last tiles first: it writes delta of its rows for launch 2, then
//      walks the key steps its queries see: S = Q K^T and dP = dO V^T,
//      P and dS, dQ += dS K.
//   2. dK and dV, one CTA per (batch, KV head, 64-key tile, rank).  The
//      group's query heads are dealt over a thread-block cluster of
//      `split` CTAs (the largest divisor of the group up to 8): rank r
//      walks heads r, r + split, .. and the query steps each sees, S^T =
//      K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  So the
//      causal mask's 32:1 spread between the first and the last key tile
//      no longer sits on a few long CTAs walking 8 heads in series: every
//      SM has CTAs at the train shapes and the longest does under twice the
//      mean.  The cluster then sums its fp32 partials in rank order
//      through distributed shared memory (each CTA a share of the rows),
//      so the sum is fixed whatever the schedule.  At D = 256, dK and dV
//      (128 accumulator registers a thread each) are two launches of this
//      kernel, dV then dK.
// How each part meets the bound:
//   - Products on `wgmma` (m64nNk16, fp32 accumulators, wgmma.cuh): K, V
//     (or Q, dO) are shared-memory A operands of the score products; P^T
//     and dS^T (dS) go from the accumulator fragments straight into the
//     register A operand of the next product; Q, dO and K are read
//     MN-major through the descriptor's transpose bit.  Tiles sit in the
//     128-byte swizzle (64-byte at D = 32) the descriptors name.
//   - A two-stage ring: the next step's Q, dO, lse and delta (dK/dV) or K
//     and V (dQ) load by 16-byte cp.async into the other stage while the
//     current step's products run; no step waits on a load it issued.
//   - The elementwise pass: exp2 on the special-function unit, the mask
//     only on tiles at the diagonal, the window or the ragged end.
//   - Occupancy: steps of 64 queries (keys), 32 at D = 256, keep two CTAs
//     an SM at D = 128 (98 KB of shared memory each) and three at
//     D <= 64 (registers capped at 168), so one CTA's elementwise pass
//     overlaps another's products.
//
// fp32: the first, CUDA-core version, the parity path of the fp32 train
// steps: delta (one warp a row), then the dK/dV and dQ kernels on fp32
// FMAs from fp32 tiles of 32 rows in shared memory (padded to D + 1 floats
// so the column reads spread over the banks), 256 threads, dQ recomputing
// the two score products.  Shared memory: 4 tiles of 32 x (D + 1) floats
// and two 32 x 33 score tiles, 25 KB at D = 32 to 140 KB at D = 256.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows a tile
constexpr int kBK = 32;  // keys a tile
constexpr int kLS = kBK + 1;  // row of a score tile in shared memory

// The operand of a product: fp32 as it is, bf16 rounded (round to nearest
// even) as the tensor cores would take it.
template <typename T>
__device__ __forceinline__ float as_operand(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(4) * kBQ * (D + 1) + 2 * kBQ * kLS + 2 * kBQ) *
         sizeof(float);
}

// Loads rows [r0, r0 + 32) of head h of x [B, S, H, D] into a 32 x (D + 1)
// fp32 tile, zeros past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* x, int b,
                                          int r0, int S, int H, int h) {
  constexpr int LD = D + 1;
  const int64_t row = static_cast<int64_t>(H) * D;
  const T* base = x + static_cast<int64_t>(b) * S * row +
                  static_cast<int64_t>(h) * D;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int p = r0 + r;
    dst[r * LD + d] = p < S ? to_f(base[p * row + d]) : 0.f;
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
               float* __restrict__ delta, int64_t rows, int Sq, int Hq,
               int D, int* counts) {
  count_launch(counts, 0);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(o[d]) * to_f(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int64_t b = row / (static_cast<int64_t>(Sq) * Hq);
    const int64_t rem = row - b * Sq * Hq;
    const int64_t i = rem / Hq;
    const int64_t h = rem - i * Hq;
    delta[(b * Hq + h) * Sq + i] = s;
  }
}

// The scores of a (32-query, 32-key) tile pair for this thread's query row
// r = tid / 8 and keys c0 + 8 j: P recomputed from lse and dS.  Writes the
// operands of the products (P where `Ps` is given, dS) into shared memory.
template <typename T, int D>
__device__ __forceinline__ void score_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Sk, int causal, int window, float softcap,
    float scale) {
  constexpr int LD = D + 1;
  const int r = threadIdx.x >> 3;
  const int c0 = threadIdx.x & 7;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
  const float* qr = Qs + r * LD;
  const float* gr = dOs + r * LD;
  for (int d = 0; d < D; ++d) {
    const float qv = qr[d];
    const float gv = gr[d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += qv * Ks[(c0 + 8 * j) * LD + d];
      dp[j] += gv * Vs[(c0 + 8 * j) * LD + d];
    }
  }
  const int qp = q0 + r;
  const float l = lse_s[r];
  const float dl = delta_s[r];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;
    const int kp = k0 + c;
    const bool ok = qp < Sq && kp < Sk && (!causal || kp <= qp) &&
                    (window <= 0 || kp > qp - window);
    const float z = s[j] * scale;
    float sc = z, dcap = 1.f;
    if (softcap > 0.f) {
      const float t = tanhf(z / softcap);
      sc = softcap * t;
      dcap = 1.f - t * t;
    }
    const float p = ok ? expf(sc - l) : 0.f;
    const float ds = p * (dp[j] - dl) * dcap;
    if (Ps != nullptr) Ps[r * kLS + c] = as_operand<T>(p);
    dSs[r * kLS + c] = as_operand<T>(ds);
  }
}

// Loads lse and delta of query rows [q0, q0 + 32) of head h.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int b, int h,
                                          int q0, int Sq, int Hq) {
  if (threadIdx.x < kBQ) {
    const int p = q0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + p;
    lse_s[threadIdx.x] = p < Sq ? lse[at] : 0.f;
    delta_s[threadIdx.x] = p < Sq ? delta[at] : 0.f;
  }
}

// dK, dV of one (batch, KV head, key tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
              int Hkv, int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 8;  // accumulator columns a thread
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;

  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;
  float* dSs = Ps + kBQ * kLS;
  float* lse_s = dSs + kBQ * kLS;
  float* delta_s = lse_s + kBQ;

  load_tile<T, D>(Ks, k, b, k0, Sk, Hkv, hk);
  load_tile<T, D>(Vs, v, b, k0, Sk, Hkv, hk);

  // the query tiles that see a key of this tile
  const int k_last = min(k0 + kBK, Sk) - 1;
  const int qt_begin = causal ? k0 / kBQ : 0;
  int q_stop = Sq;
  if (window > 0) q_stop = min(q_stop, k_last + window);
  const int qt_end = (q_stop + kBQ - 1) / kBQ;

  const int kr = threadIdx.x >> 3;  // this thread's key row
  const int c0 = threadIdx.x & 7;   // and column phase
  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile is consumed (K, V on entry)
      load_tile<T, D>(Qs, q, b, q0, Sq, Hq, h);
      load_tile<T, D>(dOs, dout, b, q0, Sq, Hq, h);
      load_rows(lse_s, delta_s, lse, delta, b, h, q0, Sq, Hq);
      __syncthreads();
      score_tile<T, D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                       Sk, causal, window, softcap, scale);
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        const float p = Ps[r * kLS + kr];
        const float ds = dSs[r * kLS + kr];
        const float* gr = dOs + r * LD + c0;
        const float* qr = Qs + r * LD + c0;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          dv_acc[i] += p * gr[8 * i];
          dk_acc[i] += ds * qr[8 * i];
        }
      }
    }
  }

  const int kp = k0 + kr;
  if (kp < Sk) {
    const int64_t at = ((static_cast<int64_t>(b) * Sk + kp) * Hkv + hk) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dk[at + c0 + 8 * i] = from_f<T>(dk_acc[i] * scale);
      dv[at + c0 + 8 * i] = from_f<T>(dv_acc[i]);
    }
  }
}

// dQ of one (batch, query head, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
            int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 8;
  // the last query tiles see the most key tiles: hand them out first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + kBQ * LD;
  float* Ks = dOs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* dSs = Vs + kBK * LD;
  float* lse_s = dSs + 2 * kBQ * kLS;
  float* delta_s = lse_s + kBQ;

  load_tile<T, D>(Qs, q, b, q0, Sq, Hq, h);
  load_tile<T, D>(dOs, dout, b, q0, Sq, Hq, h);
  load_rows(lse_s, delta_s, lse, delta, b, h, q0, Sq, Hq);

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  const int r = threadIdx.x >> 3;
  const int c0 = threadIdx.x & 7;
  float dq_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq_acc[i] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D>(Ks, k, b, k0, Sk, Hkv, hk);
    load_tile<T, D>(Vs, v, b, k0, Sk, Hkv, hk);
    __syncthreads();
    score_tile<T, D>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0,
                     Sq, Sk, causal, window, softcap, scale);
    __syncthreads();
    const float* ds_r = dSs + r * kLS;
    for (int c = 0; c < kBK; ++c) {
      const float ds = ds_r[c];
      const float* kc = Ks + c * LD + c0;
#pragma unroll
      for (int i = 0; i < NC; ++i) dq_acc[i] += ds * kc[8 * i];
    }
  }

  const int qp = q0 + r;
  if (qp < Sq) {
    const int64_t at = ((static_cast<int64_t>(b) * Sq + qp) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      dq[at + c0 + 8 * i] = from_f<T>(dq_acc[i] * scale);
  }
}

// --------------------------------------------------------------------------
// bf16: the wgmma version.  One warpgroup a CTA; warp w owns rows
// 16 w .. 16 w + 15 of every 64-row accumulator (wgmma's M).
// --------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kRows = 64;        // keys of a dK/dV CTA, queries of a dQ CTA
constexpr int kMaxSplit = 8;     // the portable thread-block cluster size

// Queries a step of the dK/dV pass (the N of S^T) and keys a step of the
// dQ pass: 64, or 32 at D = 256, where the D / 2 fp32 accumulator
// registers a thread of dK (dV, dQ) leave room for two 16-register score
// tiles only.
template <int D>
__host__ __device__ constexpr int step_rows() {
  return D == 256 ? 32 : 64;
}

// CTAs an SM: at D <= 64 the tiles leave room for three in shared memory,
// and the registers are capped to match (168 a thread); above, shared
// memory alone sets it (two at D = 128, one at D = 256).
template <int D>
__host__ __device__ constexpr int min_ctas() {
  return D <= 64 ? 3 : 1;
}

// What a dK/dV launch computes: both (D <= 128), or one of them (D = 256,
// whose dK and dV accumulators take 128 registers a thread each).
enum Pass { kDkDv = 0, kDvOnly = 1, kDkOnly = 2 };

// The passes' shared memory: K and V tiles and two stages of Q and dO
// tiles with their rows' lse and delta; the cluster sum reuses it for one
// 64 x (D + 4) fp32 partial.  1024 bytes of slack align the tiles.
template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr size_t BQ = step_rows<D>();
  const size_t tiles = 2 * kRows * D * 2 + 2 * (2 * BQ * D * 2 + 2 * BQ * 4);
  const size_t partial = static_cast<size_t>(kRows) * (D + 4) * 4;
  return 1024 + (tiles > partial ? tiles : partial);
}

// The dQ pass's: Q and dO tiles, two stages of K and V tiles, the rows'
// lse and delta.
template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr size_t BK = step_rows<D>();
  return 1024 + 2 * kRows * D * 2 + 2 * 2 * BK * D * 2 + 2 * kRows * 4;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit alone (flushing denormals to 0: P is
// rounded to bf16 or summed in fp32, where they do not count).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P and dS of one element of a score tile, in place of its unscaled score
// s and of dP: P = exp(z - lse) with z = s * scale (tanh-capped under a
// softcap) taken as exp2 (`sl` = scale log2(e), `ll` = lse log2(e)), and
// dS = P (dP - delta) (1 - tanh^2 under a softcap).
__device__ __forceinline__ void p_ds(float& s, float& dp, bool ok, float ll,
                                     float delta, float softcap, float scale,
                                     float sl) {
  float x, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s * scale / softcap);
    x = softcap * kLog2e * t - ll;
    dcap = 1.f - t * t;
  } else {
    x = fmaf(s, sl, -ll);
  }
  const float p = ok ? fast_exp2(x) : 0.f;
  s = p;
  dp = p * (dp - delta) * dcap;
}

__device__ __forceinline__ float p_only(float s, bool ok, float ll,
                                        float softcap, float scale,
                                        float sl) {
  const float x = softcap > 0.f
                      ? softcap * kLog2e * tanhf(s * scale / softcap) - ll
                      : fmaf(s, sl, -ll);
  return ok ? fast_exp2(x) : 0.f;
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk,
                                        int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// Whether every (query, key) pair of queries [q0, q0 + nq) and keys
// [k0, k0 + nk) is visible: such a tile skips the mask.
__device__ __forceinline__ bool all_visible(int q0, int nq, int k0, int nk,
                                            int Sq, int Sk, int causal,
                                            int window) {
  return q0 + nq <= Sq && k0 + nk <= Sk && (!causal || k0 + nk - 1 <= q0) &&
         (window <= 0 || k0 > q0 + nq - 1 - window);
}

// The A fragment of k-step kk of a product whose A is an accumulator
// (64 x N, N = 16 * steps), rounded to bf16: accumulator element 4 n + e
// is row g + 8 (e >> 1), column 8 n + 2 t4 + (e & 1), as in mma.sync.
template <int N>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// sum of the products of two rows of 8 bf16
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 af = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
    const float2 bf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&bw[i]));
    s += af.x * bf.x + af.y * bf.y;
  }
  return s;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Writes a 64 x D accumulator (rows from row0 of a [B, S, H, D] tensor's
// head h) as bf16 times `mul`, rows past S skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* x,
                                           const float (&acc)[D / 2],
                                           float mul, int b, int row0,
                                           int S, int H, int h) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = row0 + warp * 16 + (lane >> 2) + 8 * i;
    if (p >= S) continue;
    __nv_bfloat16* row = x + ((static_cast<int64_t>(b) * S + p) * H + h) *
                                 D + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * mul,
                                acc[4 * n + 2 * i + 1] * mul);
  }
}

// The sum over a cluster of `split` CTAs of their 64 x D partials, in rank
// order, written as bf16 times `mul`: each CTA puts its partial in its own
// shared memory (`red`, rows of D + 4 floats), then sums a share of the
// rows from every CTA's through distributed shared memory.
template <int D>
__device__ __forceinline__ void cluster_sum_rows(
    float* red, const float (&acc)[D / 2], __nv_bfloat16* x, float mul,
    int split, int b, int row0, int S, int H, int h) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* row = red + (warp * 16 + (lane >> 2) + 8 * i) * LD +
                 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
  cluster_sync();
  const int per = (kRows + split - 1) / split;
  const int r0 = static_cast<int>(cluster_rank()) * per;
  const int r1 = min(kRows, r0 + per);
  for (int i = threadIdx.x; i < (r1 - r0) * (D / 4); i += kWgThreads) {
    const int r = r0 + i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 sum = ld_cluster_f4(red + r * LD + c, 0);
    for (int src = 1; src < split; ++src) {
      const float4 part = ld_cluster_f4(red + r * LD + c, src);
      sum.x += part.x;
      sum.y += part.y;
      sum.z += part.z;
      sum.w += part.w;
    }
    const int p = row0 + r;
    if (p < S) {
      __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
          x + ((static_cast<int64_t>(b) * S + p) * H + h) * D + c);
      out[0] = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
      out[1] = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
    }
  }
  cluster_sync();  // every CTA has read `red` before it changes or exits
}

// dK and/or dV of one (batch, KV head, 64-key tile), from the query heads
// rank, rank + split, .. of the group (the CTA's rank in its cluster of
// `split`); the cluster sums the heads' partials in rank order.  Per step
// of BQ queries of one head: S^T = K Q^T and dP^T = V dO^T (K, V the
// shared-memory A operands), then dV += P^T dO and dK += dS^T Q with P^T
// and dS^T as register A operands and dO, Q read MN-major.  The next
// step's Q, dO, lse and delta load into the other stage meanwhile.
template <int D, int PASS>
__global__ void __launch_bounds__(kWgThreads, min_ctas<D>())
attn_bwd_dkdv_wg(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq,
                 int Hkv, int causal, int window, float softcap, float scale,
                 int split) {
  constexpr int BQ = step_rows<D>();
  constexpr bool DV = PASS != kDkOnly;
  constexpr bool DK = PASS != kDvOnly;
  constexpr int TILE_K = kRows * D * 2;  // bytes of the K or the V tile
  constexpr int TILE_Q = BQ * D * 2;     // bytes of a Q or a dO tile
  constexpr int STAGE = 2 * TILE_Q;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = blockIdx.x % split;
  const int k0 = blockIdx.x / split * kRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int h0 = hk * group + rank;
  const float sl = scale * kLog2e;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + TILE_K;
  unsigned char* ring = Vs + TILE_K;
  float* rows = reinterpret_cast<float*>(ring + 2 * STAGE);  // lse, delta

  // the query steps that see a key of this tile, for each of its heads
  const int k_last = min(k0 + kRows, Sk) - 1;
  const int qt_begin = causal ? k0 / BQ : 0;
  int q_stop = Sq;
  if (window > 0) q_stop = min(q_stop, k_last + window);
  const int n_qt = max(0, (q_stop + BQ - 1) / BQ - qt_begin);
  const int n_steps = group / split * n_qt;

  auto load_step = [&](int s, int stage) {
    const int h = h0 + split * (s / n_qt);
    const int q0 = (qt_begin + s % n_qt) * BQ;
    unsigned char* Qt = ring + stage * STAGE;
    load_tile_async<D, BQ, kWgThreads>(Qt, q, b, q0, Sq, Hq, h, tid);
    load_tile_async<D, BQ, kWgThreads>(Qt + TILE_Q, dout, b, q0, Sq, Hq, h,
                                       tid);
    if (tid < BQ) {
      const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq;
      const bool ok = q0 + tid < Sq;
      float* r = rows + stage * 2 * BQ;
      cp_async4(r + tid, lse + at + (ok ? q0 + tid : 0), ok);
      cp_async4(r + BQ + tid, delta + at + (ok ? q0 + tid : 0), ok);
    }
  };

  load_tile_async<D, kRows, kWgThreads>(Ks, k, b, k0, Sk, Hkv, hk, tid);
  if (DK)
    load_tile_async<D, kRows, kWgThreads>(Vs, v, b, k0, Sk, Hkv, hk, tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dv_acc[DV ? D / 2 : 2], dk_acc[DK ? D / 2 : 2];
  zero(dv_acc);
  zero(dk_acc);

  for (int s = 0; s < n_steps; ++s) {
    const int stage = s & 1;
    cp_async_wait<0>();  // this step's tiles, loaded during the last step
    fence_async_shared();
    __syncthreads();  // ... visible to all; every thread past the last step
    if (s + 1 < n_steps) load_step(s + 1, stage ^ 1);
    cp_async_commit();
    const unsigned char* Qt = ring + stage * STAGE;
    const unsigned char* dOt = Qt + TILE_Q;
    const float* lse_s = rows + stage * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    const int q0 = (qt_begin + s % n_qt) * BQ;

    float st[BQ / 2], dpt[DK ? BQ / 2 : 2];
    zero(st);
    zero(dpt);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<BQ>(st, desc_kmajor<D>(Ks + kmajor_step<D>(kRows, ks)),
                   desc_kmajor<D>(Qt + kmajor_step<D>(BQ, ks)), 1);
      if constexpr (DK)
        wgmma_ss<BQ>(dpt, desc_kmajor<D>(Vs + kmajor_step<D>(kRows, ks)),
                     desc_kmajor<D>(dOt + kmajor_step<D>(BQ, ks)), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // element 4 n + e: key row 16 warp + g + 8 (e >> 1) of the tile,
    // query column 8 n + 2 t4 + (e & 1) of the step
    auto elementwise = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int qi = 8 * n + 2 * (lane & 3);
        const float2 ll = make_float2(lse_s[qi] * kLog2e,
                                      lse_s[qi + 1] * kLog2e);
        const float2 dl = make_float2(delta_s[qi], delta_s[qi + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if constexpr (decltype(masked)::value)
            ok = visible(q0 + qi + (e & 1),
                         k0 + warp * 16 + (lane >> 2) + 8 * (e >> 1), Sq,
                         Sk, causal, window);
          const float l = e & 1 ? ll.y : ll.x;
          if constexpr (DK)
            p_ds(st[4 * n + e], dpt[4 * n + e], ok, l,
                 e & 1 ? dl.y : dl.x, softcap, scale, sl);
          else
            st[4 * n + e] = p_only(st[4 * n + e], ok, l, softcap, scale,
                                   sl);
        }
      }
    };
    if (all_visible(q0, BQ, k0, kRows, Sq, Sk, causal, window))
      elementwise(std::false_type{});
    else
      elementwise(std::true_type{});

    // every A fragment is written before the fence that orders it before
    // the products reading it
    uint32_t pa[BQ / 16][4], sa[DK ? BQ / 16 : 1][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_fragment(pa[kk], st, kk);
      if constexpr (DK) a_fragment(sa[kk], dpt, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      if constexpr (DV)
        wgmma_rs_t<D>(dv_acc, pa[kk], desc_mnmajor<D>(dOt, BQ, kk), 1);
      if constexpr (DK)
        wgmma_rs_t<D>(dk_acc, sa[kk], desc_mnmajor<D>(Qt, BQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  if (split == 1) {
    if constexpr (DV) store_rows<D>(dv, dv_acc, 1.f, b, k0, Sk, Hkv, hk);
    if constexpr (DK) store_rows<D>(dk, dk_acc, scale, b, k0, Sk, Hkv, hk);
  } else {
    float* red = reinterpret_cast<float*>(Ks);
    if constexpr (DV)
      cluster_sum_rows<D>(red, dv_acc, dv, 1.f, split, b, k0, Sk, Hkv, hk);
    if constexpr (DK)
      cluster_sum_rows<D>(red, dk_acc, dk, scale, split, b, k0, Sk, Hkv,
                          hk);
  }
}

// dQ of one (batch, query head, 64-query tile), and first delta =
// rowsum(dO O) of its rows, which it keeps and writes for the dK/dV launch
// that follows.  Per step of BK keys: S = Q K^T and dP = dO V^T (Q, dO the
// shared-memory A operands), then dQ += dS K with dS as the register A
// operand and K read MN-major.  The next step's K and V load into the
// other stage meanwhile.
template <int D>
__global__ void __launch_bounds__(kWgThreads, min_ctas<D>())
attn_bwd_dq_wg(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ out,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq,
               int Hkv, int causal, int window, float softcap, float scale,
               int* counts) {
  constexpr int BK = step_rows<D>();
  constexpr int TILE_Q = kRows * D * 2;  // bytes of the Q or the dO tile
  constexpr int TILE_K = BK * D * 2;     // bytes of a K or a V tile
  constexpr int STAGE = 2 * TILE_K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the last query tiles see the most key tiles: hand them out first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float sl = scale * kLog2e;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + TILE_Q;
  unsigned char* ring = dOs + TILE_Q;
  float* lse_s = reinterpret_cast<float*>(ring + 2 * STAGE);
  float* delta_s = lse_s + kRows;

  const int q_last = min(q0 + kRows, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_steps = max(0, kt_end - kt_begin);

  auto load_step = [&](int s, int stage) {
    const int k0 = (kt_begin + s) * BK;
    unsigned char* Kt = ring + stage * STAGE;
    load_tile_async<D, BK, kWgThreads>(Kt, k, b, k0, Sk, Hkv, hk, tid);
    load_tile_async<D, BK, kWgThreads>(Kt + TILE_K, v, b, k0, Sk, Hkv, hk,
                                       tid);
  };

  count_launch(counts, 0);
  load_tile_async<D, kRows, kWgThreads>(Qs, q, b, q0, Sq, Hq, h, tid);
  load_tile_async<D, kRows, kWgThreads>(dOs, dout, b, q0, Sq, Hq, h, tid);
  const int64_t row_at = (static_cast<int64_t>(b) * Hq + h) * Sq;
  if (tid < kRows) {
    const bool ok = q0 + tid < Sq;
    cp_async4(lse_s + tid, lse + row_at + (ok ? q0 + tid : 0), ok);
  }
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  // delta of row tid / 2, half a row a thread
  static_assert(2 * kRows == kWgThreads, "two threads a query row");
  {
    const int qp = q0 + (tid >> 1);
    float sum = 0.f;
    if (qp < Sq) {
      const int64_t at = ((static_cast<int64_t>(b) * Sq + qp) * Hq + h) *
                             D + (tid & 1) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        sum += dot8(*reinterpret_cast<const uint4*>(out + at + 8 * c),
                    *reinterpret_cast<const uint4*>(dout + at + 8 * c));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      delta_s[tid >> 1] = sum;
      if (qp < Sq) delta[row_at + qp] = sum;
    }
  }

  float dq_acc[D / 2];
  zero(dq_acc);
  // this thread's two query rows' lse log2(e) and delta
  float ll[2], dl[2];

  for (int s = 0; s < n_steps; ++s) {
    const int stage = s & 1;
    cp_async_wait<0>();  // this step's tiles, loaded during the last step
    fence_async_shared();
    __syncthreads();  // ... visible to all; every thread past the last step
    if (s + 1 < n_steps) load_step(s + 1, stage ^ 1);
    cp_async_commit();
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = warp * 16 + (lane >> 2) + 8 * i;
        ll[i] = lse_s[qi] * kLog2e;
        dl[i] = delta_s[qi];
      }
    }
    const unsigned char* Kt = ring + stage * STAGE;
    const unsigned char* Vt = Kt + TILE_K;
    const int k0 = (kt_begin + s) * BK;

    float sc[BK / 2], dp[BK / 2];
    zero(sc);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<BK>(sc, desc_kmajor<D>(Qs + kmajor_step<D>(kRows, ks)),
                   desc_kmajor<D>(Kt + kmajor_step<D>(BK, ks)), 1);
      wgmma_ss<BK>(dp, desc_kmajor<D>(dOs + kmajor_step<D>(kRows, ks)),
                   desc_kmajor<D>(Vt + kmajor_step<D>(BK, ks)), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // element 4 n + e: query row 16 warp + g + 8 (e >> 1) of the tile,
    // key column 8 n + 2 t4 + (e & 1) of the step
    auto elementwise = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if constexpr (decltype(masked)::value)
            ok = visible(q0 + warp * 16 + (lane >> 2) + 8 * (e >> 1),
                         k0 + 8 * n + 2 * (lane & 3) + (e & 1), Sq, Sk,
                         causal, window);
          p_ds(sc[4 * n + e], dp[4 * n + e], ok, ll[e >> 1], dl[e >> 1],
               softcap, scale, sl);
        }
      }
    };
    if (all_visible(q0, kRows, k0, BK, Sq, Sk, causal, window))
      elementwise(std::false_type{});
    else
      elementwise(std::true_type{});

    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_fragment(sa[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_t<D>(dq_acc, sa[kk], desc_mnmajor<D>(Kt, BK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
  }
  cp_async_wait<0>();
  store_rows<D>(dq, dq_acc, scale, b, q0, Sq, Hq, h);
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, causal, window;
  float softcap, scale;
  int* counts;
};

// The CTAs of one (KV head, key tile) in the dK/dV pass: the largest
// divisor of the group that a portable cluster holds.
inline int dkdv_split(int group) {
  for (int c = group < kMaxSplit ? group : kMaxSplit; c > 1; --c)
    if (group % c == 0) return c;
  return 1;
}

template <int D, int PASS>
cudaError_t launch_dkdv_wg(const Args& a, cudaStream_t s) {
  const size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = allow_smem(attn_bwd_dkdv_wg<D, PASS>, smem);
  if (err != cudaSuccess) return err;
  const int split = dkdv_split(a.Hq / a.Hkv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Sk + kRows - 1) / kRows * split, a.Hkv, a.B);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  using bf16 = __nv_bfloat16;
  return cudaLaunchKernelEx(
      &cfg, attn_bwd_dkdv_wg<D, PASS>, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window,
      a.softcap, a.scale, split);
}

// bf16: the wgmma kernels, dQ (which writes delta) then dK/dV (in two
// passes at D = 256); fp32: delta, then the CUDA-core dK/dV and dQ.
template <typename T, int D>
int launch(const Args& a, cudaStream_t s) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = allow_smem(attn_bwd_dq_wg<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_q((a.Sq + kRows - 1) / kRows, a.Hq, a.B);
    attn_bwd_dq_wg<D><<<grid_q, kWgThreads, smem, s>>>(
        q, k, v, static_cast<const T*>(a.out), dout, a.lse, a.delta,
        static_cast<T*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window,
        a.softcap, a.scale, a.counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if constexpr (D == 256) {
      err = launch_dkdv_wg<D, kDvOnly>(a, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_dkdv_wg<D, kDkOnly>(a, s);
    } else {
      err = launch_dkdv_wg<D, kDkDv>(a, s);
    }
    return static_cast<int>(err);
  } else {
    const int64_t rows = static_cast<int64_t>(a.B) * a.Sq * a.Hq;
    attn_bwd_delta<T>
        <<<static_cast<int>((rows + kThreads / 32 - 1) / (kThreads / 32)),
           kThreads, 0, s>>>(static_cast<const T*>(a.out), dout, a.delta,
                             rows, a.Sq, a.Hq, D, a.counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = smem_bytes<D>();
    err = allow_smem(attn_bwd_dkdv<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv((a.Sk + kBK - 1) / kBK, a.Hkv, a.B);
    attn_bwd_dkdv<T, D><<<grid_kv, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window,
        a.softcap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = allow_smem(attn_bwd_dq<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_q((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
    attn_bwd_dq<T, D><<<grid_q, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk,
        a.Hq, a.Hkv, a.causal, a.window, a.softcap, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch_dtype(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == kFloat32) return launch<float, D>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16, D>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q, out, dout, dq [B, Sq, Hq, D]; k, v, dk, dv [B, Sk, Hkv, D] (fp32 or
// bf16); lse and the scratch delta fp32 [B, Hq, Sq].  Contiguous, one
// device, D in {32, 64, 128, 256}; query row i at position i.  Launches
// the three kernels on `stream` and returns the first cudaGetLastError()
// that is not 0 (0 on success).  counts: null, or int32 [1] on the card,
// to which the call adds one.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int causal, int window,
                                   float softcap, float scale, void* counts,
                                   void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q,      k,       v,
               out,    dout,    static_cast<const float*>(lse),
               static_cast<float*>(delta),
               dq,     dk,      dv,
               B,      Sq,      Sk,
               Hq,     Hkv,     causal,
               window, softcap, scale,
               static_cast<int*>(counts)};
  switch (D) {
    case 32:
      return launch_dtype<32>(dtype, a, s);
    case 64:
      return launch_dtype<64>(dtype, a, s);
    case 128:
      return launch_dtype<128>(dtype, a, s);
    case 256:
      return launch_dtype<256>(dtype, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
