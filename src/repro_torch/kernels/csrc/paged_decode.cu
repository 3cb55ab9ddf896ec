// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `_paged_call`
// (src/repro/kernels/flash_decode.py, entry `flash_decode_paged_native`):
// one query token per sequence attends over that sequence's KV pages, read
// through its block-table row from the kernel-native pools
// [P, Hkv, page, D].  Query head h reads KV head h / group.  Positions
// outside [start, len) are masked and pages wholly outside the window are
// never read; optional tanh softcap; fp32 online softmax; len == 0 gives 0.
//
// What bounds it on an H100: bytes.  Each live K/V page must cross device
// memory once (2 * page * D * sizeof(T) per KV head per page) and the work
// per byte is ~group FMAs, far below the card's ~295 operations per byte.
// The design therefore reads every page once per KV head rather than once
// per query head: one CTA per (sequence, KV head) serves all `group` query
// heads, stages the page's K and V in shared memory with 16-byte loads and
// keeps fp32 m / l / acc for its query heads in shared memory.  The Pallas
// grid (B, Hq, pages) is not carried over.  This first version loads one
// page at a time with no copy/compute overlap and no split across pages;
// split-K for long contexts at small batch, cp.async/TMA pipelining and
// wgmma are later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lens,
                    const int* __restrict__ starts, T* __restrict__ out,
                    int Hq, int Hkv, int page, int D, int n_pages,
                    float softcap, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // shared layout: K page, V page (storage type), then fp32 q, acc,
  // scores/probabilities and the per-head softmax state
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + page * D;
  float* qs = reinterpret_cast<float*>(vs + page * D);
  float* acc = qs + G * D;
  float* sc = acc + G * D;
  float* m = sc + G * page;
  float* l = m + G;
  float* alpha = l + G;

  const int len = lens[b];
  const int st = starts[b];
  const int h0 = kvh * G;
  // the group's query heads h0 .. h0 + G - 1 are contiguous in q[b]
  const T* qb = q + (static_cast<int64_t>(b) * Hq + h0) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int first = st / page;
  const int last = len > 0 ? min((len - 1) / page, n_pages - 1) : -1;
  const int64_t page_elems = static_cast<int64_t>(page) * D;
  const int n_vec = static_cast<int>(page_elems * sizeof(T) / 16);
  const int* row = table + static_cast<int64_t>(b) * n_pages;

  for (int j = first; j <= last; ++j) {
    __syncthreads();  // the previous page is consumed; init is visible
    const int64_t base = (static_cast<int64_t>(row[j]) * Hkv + kvh) *
                         page_elems;
    const uint4* kg = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vg = reinterpret_cast<const uint4*>(v_pages + base);
    uint4* kd = reinterpret_cast<uint4*>(ks);
    uint4* vd = reinterpret_cast<uint4*>(vs);
    for (int i = tid; i < n_vec; i += kThreads) {
      kd[i] = kg[i];
      vd[i] = vg[i];
    }
    __syncthreads();

    // scores: one warp per (query head, token) dot product
    for (int e = warp; e < G * page; e += kWarps) {
      const int g = e / page;
      const int t = e - g * page;
      const float* qr = qs + g * D;
      const T* kr = ks + t * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qr[d] * to_f(kr[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int pos = j * page + t;
        const float x = softcap_score(dot * scale, softcap);
        sc[e] = (pos >= st && pos < len) ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax state: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sc + g * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(sg[t] - m_cur);
        sg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_cur;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha[g] + sum_t p[g, t] * V[t, d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = sc + g * page;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < page; ++t) a += pg[t] * to_f(vs[t * D + d]);
      acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + (static_cast<int64_t>(b) * Hq + h0) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float v = len > 0 ? acc[i] / fmaxf(l[i / D], 1e-30f) : 0.f;
    ob[i] = from_f<T>(v);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* lens, const int* starts, void* out,
           int B, int Hq, int Hkv, int page, int D, int n_pages,
           float softcap, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = 2 * static_cast<size_t>(page) * D * sizeof(T) +
                      (2 * static_cast<size_t>(G) * D +
                       static_cast<size_t>(G) * page + 3 * G) * sizeof(float);
  cudaError_t err = allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, lens, starts,
      static_cast<T*>(out), Hq, Hkv, page, D, n_pages, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q [B, Hq, D]; k_pages/v_pages [P, Hkv, page, D]; table [B, n_pages];
// lens/starts [B]; out [B, Hq, D].  All contiguous, on one device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode(int dtype, const void* q, const void* k_pages,
                            const void* v_pages, const void* table,
                            const void* lens, const void* starts, void* out,
                            int B, int Hq, int Hkv, int page, int D,
                            int n_pages, float softcap, float scale,
                            void* stream) {
  using namespace repro_torch;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  const int* sb = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k_pages, v_pages, tb, ln, sb, out, B, Hq, Hkv,
                         page, D, n_pages, softcap, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, sb, out, B, Hq,
                                 Hkv, page, D, n_pages, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
