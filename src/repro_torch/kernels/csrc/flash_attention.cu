// Causal (or full) flash attention for prefill on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py): q [B, Sq, Hq, D] attends to
// k/v [B, Sk, Hkv, D], query head h reading KV head h / group (GQA in the
// index arithmetic, no expanded K/V copy), with optional tanh softcap,
// causal mask k <= q, sliding window k > q - window and an fp32 online
// softmax over key tiles.  Query row i sits at position q_offset + i for
// both masks (a prefill chunk after q_offset resident tokens; 0 for a
// whole prompt), keys at their index.  Ragged Sq / Sk are masked inside
// the kernel, so no caller pads anything (the non-causal padded-key leak
// of the JAX padding wrapper does not exist here).
//
// What bounds it on an H100: operations at prefill lengths (4 * Sq * Sk *
// D / 2 FLOPs per head under the causal mask against ~2 bytes per element
// moved).  This FA2-style first version is written for correctness: one
// CTA of 256 threads per (batch, query head, 64-query tile) stages Q and
// 32-key K/V tiles in shared memory as fp32 (rows padded to D + 1 floats so
// neither the per-row Q reads nor the per-key K reads conflict on banks),
// each thread owns 8 scores and D / 4 output columns of one query row, and
// the four threads of a row exchange probabilities by warp shuffles.  The
// products run on the CUDA cores in fp32, not on the tensor cores;
// mma.sync / wgmma tiles and TMA loads are later work.  Key tiles past the
// causal limit are never visited and tiles wholly below the window's lower
// edge are skipped.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256; // 4 threads per query row

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ + 2 * kBK) * (D + 1) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, int q_offset, int causal,
                       int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = kBK / 4;  // scores per thread
  constexpr int NC = D / 4;    // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 2;      // query row within the tile
  const int c0 = tid & 3;      // this thread's column / key phase
  const int qpos = q_offset + q0 + r;  // masks compare keys with this

  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;

  const int64_t q_row = static_cast<int64_t>(Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const T* qb = q + static_cast<int64_t>(b) * Sq * q_row +
                static_cast<int64_t>(hq) * D;
  const T* kb = k + static_cast<int64_t>(b) * Sk * kv_row +
                static_cast<int64_t>(hk) * D;
  const T* vb = v + static_cast<int64_t>(b) * Sk * kv_row +
                static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D;
    const int d = i - rr * D;
    const int p = q0 + rr;
    Qs[rr * LD + d] = p < Sq ? to_f(qb[p * q_row + d]) : 0.f;
  }

  float o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.f;
  float m_i = kNegInf;
  float l_i = 0.f;

  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int kt_begin =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile consumed (and Q visible on entry)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D;
      const int d = i - rr * D;
      const int p = k0 + rr;
      const bool ok = p < Sk;
      Ks[rr * LD + d] = ok ? to_f(kb[p * kv_row + d]) : 0.f;
      Vs[rr * LD + d] = ok ? to_f(vb[p * kv_row + d]) : 0.f;
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
    T* ob = out + (static_cast<int64_t>(b) * Sq + q0 + r) * q_row +
            static_cast<int64_t>(hq) * D + c0;
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[4 * c] = from_f<T>(o[c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int q_offset, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(flash_attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv,
      q_offset, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int Hq, int Hkv, int D, int q_offset,
               int causal, int window, float softcap, float scale,
               cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, q_offset, causal,
                           window, softcap, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, q_offset, causal,
                           window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, q_offset, causal,
                            window, softcap, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, q_offset, causal,
                            window, softcap, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; out [B, Sq, Hq, D].  Contiguous,
// one device, D in {32, 64, 128, 256}; query row i at position
// q_offset + i.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Sk, int Hq, int Hkv, int D, int q_offset,
                               int causal, int window, float softcap,
                               float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, q_offset,
                             causal, window, softcap, scale, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                     q_offset, causal, window, softcap,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
