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
//
// The FlashAttention-2 scheme without atomics, so the gradients are
// deterministic (the same inputs give the same bits):
//   1. delta[b, h, i] = sum_d dO * O over row i (one warp a row);
//   2. one CTA per (batch, KV head, key tile) keeps the tile's K and V and
//      its dK, dV accumulators, and walks the group's query heads and the
//      query tiles that can see the tile: it recomputes P = exp(s - lse) in
//      fp32, dP = dO V^T, dS = P (dP - delta), and adds P^T dO to dV and
//      dS^T Q to dK;
//   3. one CTA per (batch, query head, query tile) keeps the tile's Q, dO
//      and dQ accumulator and walks the key tiles it sees: dQ += dS K.
// Each backward call is these three launches.  In bf16, P and dS are
// rounded to bf16 as the operands of their products (the precision of the
// forward's tensor-core products), with fp32 sums.
//
// What bounds it on an H100: operations (five products of 2 Sq Sk D a
// head, halved under the causal mask) against ~2 bytes an element moved;
// only the tensor cores come near that bound.
//
// bf16 at D <= 128, the training path: steps 2 and 3 run on the tensor
// cores, `mma.sync` m16n8k16 with the forward's fragment layouts and
// `ldmatrix` helpers (common.cuh).  Four warps a CTA, each owning 16 rows:
// 16 keys of a 64-key dK/dV tile, stepping over 32 queries at a time, or
// 16 queries of a 64-query dQ tile, stepping over 32 keys.  S^T and dP^T
// (S and dP) are accumulated in registers; P^T and dS^T become bf16 A
// operands straight from the accumulators, and Q, dO or K are read as
// transposed B operands from shared memory (rows padded by 16 bytes).
// Tiles are loaded by 16-byte cp.async, one stage.  dK and dV (16 x D
// fp32 each a warp) take 128 registers a thread at D = 128, which is why
// D = 256 stays on the CUDA cores.  Shared memory: 192 rows of D + 8 bf16,
// 15 KB at D = 32 to 52 KB at D = 128.
//
// fp32, and bf16 at D = 256: the first, CUDA-core version: fp32 FMAs from
// fp32 tiles of 32 rows in shared memory (padded to D + 1 floats so the
// column reads spread over the banks), 256 threads, two score products
// recomputed in the dQ pass.  Shared memory: 4 tiles of 32 x (D + 1)
// floats and two 32 x 33 score tiles, 25 KB at D = 32 to 140 KB at
// D = 256.
#include <type_traits>

#include "common.cuh"

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
               int D) {
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
// bf16, D <= 128: the tensor-core version (mma.sync m16n8k16, the
// fragment layouts of the forward's bf16 kernel).
// --------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // four warps, 16 rows each
constexpr int kTcKeys = 64;      // keys a dK/dV CTA (16 a warp)
constexpr int kTcQStep = 32;     // queries a step of the dK/dV CTA
constexpr int kTcQRows = 64;     // queries a dQ CTA (16 a warp)
constexpr int kTcKStep = 32;     // keys a step of the dQ CTA

template <int D>
constexpr size_t tc_smem_bytes() {
  // 64 + 64 + 32 + 32 rows of D bf16 (+ a 16-byte pad), then lse and delta
  return static_cast<size_t>(2 * kTcKeys + 2 * kTcQStep) * (D + 8) *
             sizeof(__nv_bfloat16) +
         2 * kTcQRows * sizeof(float);
}

// Copies rows [r0, r0 + rows) of head h of x [B, S, H, D] (bf16) into a
// rows x (D + 8) shared tile with 16-byte cp.async, zeros past S.
template <int D>
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst,
                                             const __nv_bfloat16* x, int b,
                                             int r0, int rows, int S, int H,
                                             int h) {
  constexpr int CH = D / 8;
  const int64_t row = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* base = x + static_cast<int64_t>(b) * S * row +
                              static_cast<int64_t>(h) * D;
  for (int i = threadIdx.x; i < rows * CH; i += kTcThreads) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * (D + 8) + c * 8,
               base + (ok ? (r0 + r) * row : 0) + c * 8, ok);
  }
}

// P and dS of one element of a score tile, in place of its scaled score
// s and of dP.
__device__ __forceinline__ void tc_p_ds(float& s, float& dp, bool ok,
                                        float lse, float delta, float softcap,
                                        float scale) {
  const float z = s * scale;
  float sc = z, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(z / softcap);
    sc = softcap * t;
    dcap = 1.f - t * t;
  }
  const float p = ok ? expf(sc - lse) : 0.f;
  s = p;
  dp = p * (dp - delta) * dcap;
}

// dK, dV of one (batch, KV head, 64-key tile); warp w owns keys 16 w..
// Per step: S^T = K Q^T and dP^T = V dO^T for 32 queries, then
// dV += P^T dO and dK += dS^T Q with P^T, dS^T as bf16 A operands.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq,
                 int Hkv, int causal, int window, float softcap,
                 float scale) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NQ = kTcQStep / 8;  // n-tiles of S^T (queries)
  constexpr int NO = D / 8;         // n-tiles of dK, dV (columns)
  const int k0 = blockIdx.x * kTcKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTcKeys * LD;
  __nv_bfloat16* Qs = Vs + kTcKeys * LD;
  __nv_bfloat16* dOs = Qs + kTcQStep * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kTcQStep * LD);
  float* delta_s = lse_s + kTcQStep;

  tc_load_rows<D>(Ks, k, b, k0, kTcKeys, Sk, Hkv, hk);
  tc_load_rows<D>(Vs, v, b, k0, kTcKeys, Sk, Hkv, hk);
  cp_async_commit();

  // the query steps that see a key of this tile
  const int k_last = min(k0 + kTcKeys, Sk) - 1;
  const int qt_begin = causal ? k0 / kTcQStep : 0;
  int q_stop = Sq;
  if (window > 0) q_stop = min(q_stop, k_last + window);
  const int qt_end = (q_stop + kTcQStep - 1) / kTcQStep;

  // ldmatrix lane addresses, as in the forward: A rows, B from rows (the
  // n index is a smem row), B transposed (the k index is a smem row)
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kTcQStep;
      __syncthreads();  // the previous step's Q, dO, lse, delta consumed
      tc_load_rows<D>(Qs, q, b, q0, kTcQStep, Sq, Hq, h);
      tc_load_rows<D>(dOs, dout, b, q0, kTcQStep, Sq, Hq, h);
      cp_async_commit();
      if (threadIdx.x < kTcQStep) {
        const int p = q0 + threadIdx.x;
        const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + p;
        lse_s[threadIdx.x] = p < Sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = p < Sq ? delta[at] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ak[4], av[4];
        ldmatrix_x4(ak, Ks + a_row * LD + ks * 16 + a_col);
        ldmatrix_x4(av, Vs + a_row * LD + ks * 16 + a_col);
#pragma unroll
        for (int jp = 0; jp < NQ / 2; ++jp) {
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, Qs + (jp * 16 + b_row) * LD + ks * 16 + b_col);
          ldmatrix_x4(bo, dOs + (jp * 16 + b_row) * LD + ks * 16 + b_col);
          mma_bf16(st[2 * jp], ak, bq[0], bq[1]);
          mma_bf16(st[2 * jp + 1], ak, bq[2], bq[3]);
          mma_bf16(dpt[2 * jp], av, bo[0], bo[1]);
          mma_bf16(dpt[2 * jp + 1], av, bo[2], bo[3]);
        }
      }

      // accumulator element e of n-tile n: key row g + 8 (e >> 1) of the
      // warp, query column 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + warp * 16 + g + (e >> 1) * 8;
          const int qi = n * 8 + 2 * t4 + (e & 1);
          const int qp = q0 + qi;
          const bool ok = qp < Sq && kp < Sk && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          tc_p_ds(st[n][e], dpt[n][e], ok, lse_s[qi], delta_s[qi], softcap,
                  scale);
        }
      }

#pragma unroll
      for (int kk = 0; kk < kTcQStep / 16; ++kk) {
        const uint32_t ap[4] = {
            pack_bf16(st[2 * kk][0], st[2 * kk][1]),
            pack_bf16(st[2 * kk][2], st[2 * kk][3]),
            pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t as[4] = {
            pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo,
                            dOs + (kk * 16 + t_row) * LD + dp * 16 + t_col);
          ldmatrix_x4_trans(bq,
                            Qs + (kk * 16 + t_row) * LD + dp * 16 + t_col);
          mma_bf16(dv_acc[2 * dp], ap, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * dp + 1], ap, bo[2], bo[3]);
          mma_bf16(dk_acc[2 * dp], as, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * dp + 1], as, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + warp * 16 + g + i * 8;
    if (kp >= Sk) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * Sk + kp) * Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * i] * scale,
                                dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// dQ of one (batch, query head, 64-query tile); warp w owns queries
// 16 w..  Per step of 32 keys: S = Q K^T, dP = dO V^T, then dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq,
               int Hkv, int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NK = kTcKStep / 8;  // n-tiles of S (keys)
  constexpr int NO = D / 8;
  // the last query tiles see the most key tiles: hand them out first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kTcQRows * LD;
  __nv_bfloat16* Ks = dOs + kTcQRows * LD;
  __nv_bfloat16* Vs = Ks + kTcKStep * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + kTcKStep * LD);
  float* delta_s = lse_s + kTcQRows;

  tc_load_rows<D>(Qs, q, b, q0, kTcQRows, Sq, Hq, h);
  tc_load_rows<D>(dOs, dout, b, q0, kTcQRows, Sq, Hq, h);
  cp_async_commit();
  if (threadIdx.x < kTcQRows) {
    const int p = q0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + p;
    lse_s[threadIdx.x] = p < Sq ? lse[at] : 0.f;
    delta_s[threadIdx.x] = p < Sq ? delta[at] : 0.f;
  }

  const int q_last = min(q0 + kTcQRows, Sq) - 1;
  int kt_end = (Sk + kTcKStep - 1) / kTcKStep;
  if (causal) kt_end = min(kt_end, q_last / kTcKStep + 1);
  const int kt_begin =
      window > 0 ? max(0, q0 - window + 1) / kTcKStep : 0;

  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int t_col = (lane >> 4) * 8;

  float dq_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTcKStep;
    __syncthreads();  // the previous step's K and V consumed
    tc_load_rows<D>(Ks, k, b, k0, kTcKStep, Sk, Hkv, hk);
    tc_load_rows<D>(Vs, v, b, k0, kTcKStep, Sk, Hkv, hk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t aq[4], ao[4];
      ldmatrix_x4(aq, Qs + a_row * LD + ks * 16 + a_col);
      ldmatrix_x4(ao, dOs + a_row * LD + ks * 16 + a_col);
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Ks + (jp * 16 + b_row) * LD + ks * 16 + b_col);
        ldmatrix_x4(bv, Vs + (jp * 16 + b_row) * LD + ks * 16 + b_col);
        mma_bf16(s[2 * jp], aq, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * jp], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], ao, bv[2], bv[3]);
      }
    }

    // element e of n-tile n: query row g + 8 (e >> 1) of the warp, key
    // column 8 n + 2 t4 + (e & 1)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = warp * 16 + g + (e >> 1) * 8;
        const int qp = q0 + qi;
        const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = qp < Sq && kp < Sk && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        tc_p_ds(s[n][e], dp[n][e], ok, lse_s[qi], delta_s[qi], softcap,
                scale);
      }
    }

#pragma unroll
    for (int kk = 0; kk < kTcKStep / 16; ++kk) {
      const uint32_t as[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, Ks + (kk * 16 + t_row) * LD + d * 16 + t_col);
        mma_bf16(dq_acc[2 * d], as, bk[0], bk[1]);
        mma_bf16(dq_acc[2 * d + 1], as, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + warp * 16 + g + i * 8;
    if (qp >= Sq) continue;
    __nv_bfloat16* row = dq + ((static_cast<int64_t>(b) * Sq + qp) * Hq + h) *
                                  D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(dq_acc[n][2 * i] * scale,
                                dq_acc[n][2 * i + 1] * scale);
  }
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
};

// delta, then the dK/dV and dQ kernels of the CUDA-core version or, for
// bf16 at D <= 128, of the tensor-core one.
template <typename T, int D>
int launch(const Args& a, cudaStream_t s) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int64_t rows = static_cast<int64_t>(a.B) * a.Sq * a.Hq;
  const int delta_blocks =
      static_cast<int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  attn_bwd_delta<T><<<delta_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.out), dout, a.delta, rows, a.Sq, a.Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if constexpr (std::is_same_v<T, __nv_bfloat16> && D <= 128) {
    const size_t smem = tc_smem_bytes<D>();
    err = allow_smem(attn_bwd_dkdv_tc<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv((a.Sk + kTcKeys - 1) / kTcKeys, a.Hkv, a.B);
    attn_bwd_dkdv_tc<D><<<grid_kv, kTcThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window,
        a.softcap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = allow_smem(attn_bwd_dq_tc<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_q((a.Sq + kTcQRows - 1) / kTcQRows, a.Hq, a.B);
    attn_bwd_dq_tc<D><<<grid_q, kTcThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk,
        a.Hq, a.Hkv, a.causal, a.window, a.softcap, a.scale);
    return static_cast<int>(cudaGetLastError());
  } else {
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
// that is not 0 (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int causal, int window,
                                   float softcap, float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q,      k,       v,
               out,    dout,    static_cast<const float*>(lse),
               static_cast<float*>(delta),
               dq,     dk,      dv,
               B,      Sq,      Sk,
               Hq,     Hkv,     causal,
               window, softcap, scale};
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
