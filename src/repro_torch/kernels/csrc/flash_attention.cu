// Causal (or full) flash attention for prefill on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py): q [B, Sq, Hq, D] attends to
// k/v [B, Sk, Hkv, D], query head h reading KV head h / group (GQA in the
// index arithmetic, no expanded K/V copy), with optional tanh softcap,
// causal mask k <= q, sliding window k > q - window and an fp32 online
// softmax over key tiles.  Query row i sits at position q_offset + i for
// both masks (a prefill chunk after q_offset resident tokens; 0 for a
// whole prompt), keys at their index.  The offset comes by value, or, in
// the device-offset form, from an int32 tensor on the card that each CTA
// reads at its start (one scalar for every row, or one per batch row): a
// captured CUDA graph then serves any offset, the engine's chunk forward
// writing the new one into the tensor before each replay.  Both forms
// compute the same bits: the loaded value drives the same code.  Ragged
// Sq / Sk are masked inside the kernel, so no caller pads anything (the
// non-causal padded-key leak of the JAX padding wrapper does not exist
// here).  Key tiles past the
// causal limit are never visited and tiles wholly below the window's lower
// edge are skipped.
//
// What bounds it on an H100: operations at prefill lengths (4 * Sq * Sk *
// D / 2 FLOPs per head under the causal mask against ~2 bytes per element
// moved).  Only the tensor cores come near that bound: 989 TFLOP/s in
// bf16 against 67 TFLOP/s for fp32 on the CUDA cores.
//
// bf16, the serving path: an FA2-style kernel on `mma.sync` m16n8k16 (bf16
// in, fp32 accumulate). One CTA of four warps per (batch, query head,
// 64-query tile), the heaviest causal tiles first; each warp owns 16 query
// rows. The Q tile is staged once in shared memory and held in registers as
// the A fragments (`ldmatrix`); at D = 256 they would crowd out the 16 x 256
// fp32 output accumulator, so there they are re-read from shared memory at
// each step. K/V tiles stay bf16 in shared memory (rows padded by 16 bytes
// so that `ldmatrix` reads without bank conflicts), loaded by 16-byte
// `cp.async` into a two-stage ring: tile j + 1 is in flight while tile j is
// computed, with one barrier per tile. Scale, softcap and masks act on the
// accumulator fragments in registers, and only tiles that cross the causal
// diagonal, the window's edge or the ragged end of Sk pay for the mask. The
// row max and sum of the online softmax are taken over the four lanes that
// share a row. P is rounded to bf16 in registers and used directly as the A
// operand of P·V (V's B fragments come from `ldmatrix.trans`), as the JAX
// package's `full_attention` rounds P to the input dtype before P·V; the
// Pallas kernel keeps P in fp32, a difference of about 2^-9 relative. The
// row sum l is taken over the unrounded fp32 P. Key tiles are 64 keys, 32 at
// D = 256, which keeps registers from spilling. Shared memory: 26 KB at
// D = 32 to 101 KB at D = 256.
//
// Both versions can also write each row's log-sum-exp (fp32 [B, Hq, Sq],
// natural units) where they store the row, for the backward kernels of
// flash_attention_bwd.cu; the serving path passes no buffer for it.
//
// fp32 (used by the card's fp32 parity checks and fp32 training, never on
// the bf16 serving path) keeps the first, CUDA-core version: one CTA of 256 threads
// per (batch, query head, 64-query tile) stages Q and 32-key K/V tiles as
// fp32 with rows of D + 1 floats, each thread owns 8 scores and D / 4
// output columns of one query row, and the products are scalar FMAs.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;  // query rows per CTA (both versions)

// counts[0] += 1 for the launch, counts[1] += 1 where a row's query offset
// (by value, or the device-offset form's, read here) is > 0.  Called
// before a CTA replaces q_offset by its row's.
__device__ __forceinline__ void count_prefill(int* counts, int q_offset,
                                              const int* q_off,
                                              int q_off_stride) {
  if (counts == nullptr || !first_thread()) return;
  bool at_offset = q_offset > 0;
  if (q_off != nullptr) {
    at_offset = false;
    const int rows = q_off_stride == 0 ? 1 : static_cast<int>(gridDim.z);
    for (int b = 0; b < rows; ++b) at_offset |= q_off[b * q_off_stride] > 0;
  }
  atomicAdd(counts, 1);
  if (at_offset) atomicAdd(counts + 1, 1);
}

// --------------------------------------------------------------------------
// fp32: the CUDA-core version.
// --------------------------------------------------------------------------

constexpr int kBK32 = 32;        // keys per tile
constexpr int kThreads32 = 256;  // 4 threads per query row

template <int D>
constexpr size_t smem_bytes_f32() {
  return static_cast<size_t>(kBQ + 2 * kBK32) * (D + 1) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                    int q_offset, const int* __restrict__ q_off,
                    int q_off_stride, int causal, int window, float softcap,
                    float scale, int* counts) {
  constexpr int LD = D + 1;
  constexpr int NJ = kBK32 / 4;  // scores per thread
  constexpr int NC = D / 4;      // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  count_prefill(counts, q_offset, q_off, q_off_stride);
  if (q_off != nullptr) q_offset = q_off[b * q_off_stride];
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 2;      // query row within the tile
  const int c0 = tid & 3;      // this thread's column / key phase
  const int qpos = q_offset + q0 + r;  // masks compare keys with this

  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK32 * LD;

  const int64_t q_row = static_cast<int64_t>(Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const float* qb = q + static_cast<int64_t>(b) * Sq * q_row +
                    static_cast<int64_t>(hq) * D;
  const float* kb = k + static_cast<int64_t>(b) * Sk * kv_row +
                    static_cast<int64_t>(hk) * D;
  const float* vb = v + static_cast<int64_t>(b) * Sk * kv_row +
                    static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads32) {
    const int rr = i / D;
    const int d = i - rr * D;
    const int p = q0 + rr;
    Qs[rr * LD + d] = p < Sq ? qb[p * q_row + d] : 0.f;
  }

  float o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.f;
  float m_i = kNegInf;
  float l_i = 0.f;

  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK32 - 1) / kBK32;
  if (causal) kt_end = min(kt_end, q_last / kBK32 + 1);
  const int kt_begin =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBK32 : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();  // previous tile consumed (and Q visible on entry)
    for (int i = tid; i < kBK32 * D; i += kThreads32) {
      const int rr = i / D;
      const int d = i - rr * D;
      const int p = k0 + rr;
      const bool ok = p < Sk;
      Ks[rr * LD + d] = ok ? kb[p * kv_row + d] : 0.f;
      Vs[rr * LD + d] = ok ? vb[p * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    const float* qr = Qs + r * LD;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] += qv * Ks[(c0 + 4 * j) * LD + d];
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kp = k0 + c0 + 4 * j;
      const bool ok = kp < Sk && (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      s[j] = ok ? softcap_score(s[j] * scale, softcap) : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j] = expf(s[j] - m_new);
      sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float a = expf(m_i - m_new);
    l_i = l_i * a + sum;
    m_i = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] *= a;

    // o[r, :] += sum_t p[r, t] * V[t, :]; key t = 4 j + kk lives in the
    // row's lane (lane & ~3) | kk
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float p = __shfl_sync(0xffffffffu, s[j], (lane & ~3) | kk);
        const float* vr = Vs + (4 * j + kk) * LD + c0;
#pragma unroll
        for (int c = 0; c < NC; ++c) o[c] += p * vr[4 * c];
      }
    }
  }

  if (q0 + r < Sq) {
    float* ob = out + (static_cast<int64_t>(b) * Sq + q0 + r) * q_row +
                static_cast<int64_t>(hq) * D + c0;
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[4 * c] = o[c] * inv;
    if (lse != nullptr && c0 == 0)
      lse[(static_cast<int64_t>(b) * Hq + hq) * Sq + q0 + r] =
          l_i > 0.f ? m_i + logf(l_i) : kNegInf;
  }
}

// --------------------------------------------------------------------------
// bf16: the tensor-core version.
// --------------------------------------------------------------------------

constexpr int kThreads = 128;  // four warps, 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Keys per tile: 32 at D = 256, where registers are scarcest.
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D >= 256 ? 32 : 64;
}

// Shared-memory row: D bf16 and a 16-byte pad (ldmatrix bank spread).
template <int D>
__host__ __device__ constexpr int smem_ld() {
  return D + 8;
}

template <int D>
constexpr size_t smem_bytes_bf16() {
  return static_cast<size_t>(kBQ + 4 * key_tile<D>()) * smem_ld<D>() *
         sizeof(__nv_bfloat16);
}

// Accumulator fragment layout of m16n8 (lane = 4 * g + t4): c[0], c[1] are
// row g, columns 2 t4 and 2 t4 + 1; c[2], c[3] the same columns of row
// g + 8.  An A fragment of m16n8k16 holds rows g and g + 8 at columns
// 2 t4 (+1) and 2 t4 + 8 (+1), so two neighbouring accumulator tiles of S
// are one A fragment of P.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                     int q_offset, const int* __restrict__ q_off,
                     int q_off_stride, int causal, int window, float softcap,
                     float scale, int* counts) {
  constexpr int BK = key_tile<D>();
  constexpr int LD = smem_ld<D>();
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T
  constexpr int NS = BK / 8;      // n-tiles of S (keys)
  constexpr int NO = D / 8;       // n-tiles of O (columns)
  constexpr int CH = D / 8;       // 16-byte chunks per row
  constexpr bool kQRegs = D <= 128;

  // the last query tiles have the most key tiles under the causal mask:
  // hand them out first, so that the light ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  count_prefill(counts, q_offset, q_off, q_off_stride);
  if (q_off != nullptr) q_offset = q_off[b * q_off_stride];
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * LD;     // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  const int64_t q_row = static_cast<int64_t>(Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * Sq * q_row +
                            static_cast<int64_t>(hq) * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * Sk * kv_row +
                            static_cast<int64_t>(hk) * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * Sk * kv_row +
                            static_cast<int64_t>(hk) * D;

  // Q tile: rows at or past Sq are zero-filled, never read
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = q0 + r < Sq;
    cp_async16(Qs + r * LD + c * 8, qb + (ok ? (q0 + r) * q_row : 0) + c * 8,
               ok);
  }
  cp_async_commit();

  const int q_first = q_offset + q0;  // the tile's first query position
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  const int kt_begin = window > 0 ? max(0, q_first - window + 1) / BK : 0;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* ks = Ks + stage * BK * LD;
    __nv_bfloat16* vs = Vs + stage * BK * LD;
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i / CH;
      const int c = i - r * CH;
      const bool ok = k0 + r < Sk;
      const int64_t off = (ok ? (k0 + r) * kv_row : 0) + c * 8;
      cp_async16(ks + r * LD + c * 8, kb + off, ok);
      cp_async16(vs + r * LD + c * 8, vb + off, ok);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max (log2 units), rows g, g+8
  float l_r[2] = {0.f, 0.f};          // this lane's share of the row sums
  uint32_t qf[kQRegs ? KSTEPS : 1][4];

  // ldmatrix lane addresses: A (Q) rows r0 + (lane & 15), column half
  // lane >> 4; B of K^T: key (lane & 7) + 8 (lane >> 4), column half
  // (lane >> 3) & 1; B of V (transposed): key (lane & 7) + 8 ((lane >> 3)
  // & 1), column half lane >> 4.
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    // tile kt (and, on entry, Q) is visible; every warp is done with tile
    // kt - 1, whose stage the next load overwrites
    __syncthreads();
    if constexpr (kQRegs) {
      if (kt == kt_begin) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldmatrix_x4(qf[ks], Qs + a_row * LD + ks * 16 + a_col);
      }
    }
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();

    const __nv_bfloat16* ks_t = Ks + stage * BK * LD;
    const __nv_bfloat16* vs_t = Vs + stage * BK * LD;

    // S = Q K^T on the tensor cores
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[ks][x];
      } else {
        ldmatrix_x4(a, Qs + a_row * LD + ks * 16 + a_col);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks_t + (jp * 16 + k_row) * LD + ks * 16 + k_col);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap and (on edge tiles) masks, in log2 units
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q_first) ||
                      (window > 0 && k0 <= q_offset + q0 + kBQ - 1 - window);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap_score(s[n][e] * scale, softcap) * kLog2e;
        if (edge) {
          const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qp = q_first + warp * 16 + g + (e >> 1) * 8;
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax: rows g (i = 0) and g + 8 (i = 1), each spread over
    // the four lanes of its quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * i] = exp2f(s[n][2 * i] - m_new);
        s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - m_new);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs_t + (kk * 16 + v_row) * LD + dp * 16 + v_col);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = q0 + warp * 16 + g + i * 8;
    if (r >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    // the row's log-sum-exp in natural units (m is in log2 units)
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<int64_t>(b) * Hq + hq) * Sq + r] =
          l > 0.f ? (m_r[i] + log2f(l)) * kLn2 : kNegInf;
    __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * Sq + r) * q_row +
                          static_cast<int64_t>(hq) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Sq, Sk, Hq, Hkv, q_offset;
  const int* q_off;
  int q_off_stride, causal, window;
  float softcap, scale;
  int* counts;
};

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32<D>();
  cudaError_t err = allow_smem(flash_attention_f32<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_attention_f32<D><<<grid, kThreads32, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.Sq,
      a.Sk, a.Hq, a.Hkv, a.q_offset, a.q_off, a.q_off_stride, a.causal,
      a.window, a.softcap, a.scale, a.counts);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<D>();
  cudaError_t err = allow_smem(flash_attention_bf16<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_attention_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.Sq, a.Sk, a.Hq, a.Hkv,
      a.q_offset, a.q_off, a.q_off_stride, a.causal, a.window, a.softcap,
      a.scale, a.counts);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == kFloat32) return launch_f32<D>(a, s);
  if (dtype == kBFloat16) return launch_bf16<D>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; out [B, Sq, Hq, D]; lse, when not
// null, fp32 [B, Hq, Sq]: each row's log-sum-exp of its scaled (softcapped)
// scores over the unmasked keys, which the backward kernels recompute P
// from (null on the serving path).  Contiguous, one device, 16-byte
// aligned, D in {32, 64, 128, 256}; query row i at position q_offset + i.
// The device-offset form: where q_off (int32 on the card) is not null,
// batch row b's offset is q_off[b * q_off_stride] (stride 0: one offset
// for every row) and q_offset is not read.  counts: null, or int32 [2] on
// the card: the launch adds one to counts[0], and one to counts[1] where
// an offset it reads is > 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* lse, int B,
                               int Sq, int Sk, int Hq, int Hkv, int D,
                               int q_offset, const void* q_off,
                               int q_off_stride, int causal, int window,
                               float softcap, float scale, void* counts,
                               void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, Hq, Hkv,
               q_offset, static_cast<const int*>(q_off), q_off_stride, causal,
               window, softcap, scale, static_cast<int*>(counts)};
  switch (D) {
    case 32:
      return launch<32>(dtype, a, s);
    case 64:
      return launch<64>(dtype, a, s);
    case 128:
      return launch<128>(dtype, a, s);
    case 256:
      return launch<256>(dtype, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
