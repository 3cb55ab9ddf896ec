// The decode inner loop shared by the paged (paged_decode.cu) and dense
// (flash_decode.cu) decode kernels.
//
// One CTA serves one (sequence, KV head) and all `G` query heads of its
// group, so every live K/V row crosses device memory once per KV head, not
// once per query head.  It walks the sequence in tiles of `tile` positions:
// stages the tile's K and V rows in shared memory with 16-byte loads
// (positions at or past `limit` are zero-filled, never read), scores them
// (one warp per (query head, position) dot product, optional tanh softcap,
// positions outside [start, limit) masked), folds them into an fp32 online
// softmax (one warp per query head) and accumulates P V (one thread per
// (query head, column)).  A row with limit == 0 writes zeros.
//
// The two callers differ only in where a tile's rows live, which the
// `Rows` policy says: `tile_base(j)` is the element offset of tile j's first
// row and `row_stride` the elements between consecutive rows.  Paged: a
// tile is a page, found through the block table, rows D apart.  Dense: a
// tile is `tile` consecutive positions of [B, S, Hkv, D], rows Hkv * D
// apart.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;

// Shared memory the loop needs: K and V tiles in the storage type, then
// fp32 q, acc, scores and the per-head softmax state.
template <typename T>
inline size_t decode_smem_bytes(int G, int tile, int D) {
  return 2 * static_cast<size_t>(tile) * D * sizeof(T) +
         (2 * static_cast<size_t>(G) * D + static_cast<size_t>(G) * tile +
          3 * G) * sizeof(float);
}

// qb: the group's G query rows [G, D]; ob: where its G output rows go.
// Positions [start, limit) are attended; tiles wholly before `start` are
// never read.
template <typename T, typename Rows>
__device__ __forceinline__ void decode_group(
    const T* __restrict__ qb, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ ob, const Rows& rows, int G,
    int D, int tile, int start, int limit, float softcap, float scale) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + tile * D;
  float* qs = reinterpret_cast<float*>(vs + tile * D);
  float* acc = qs + G * D;
  float* sc = acc + G * D;
  float* m = sc + G * tile;
  float* l = m + G;
  float* alpha = l + G;

  for (int i = tid; i < G * D; i += kDecodeThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int first = start / tile;
  const int last = limit > 0 ? (limit - 1) / tile : -1;
  const int row_vecs = static_cast<int>(D * sizeof(T) / 16);

  for (int j = first; j <= last; ++j) {
    __syncthreads();  // the previous tile is consumed; init is visible
    const int64_t base = rows.tile_base(j);
    const int p0 = j * tile;
    for (int i = tid; i < tile * row_vecs; i += kDecodeThreads) {
      const int t = i / row_vecs;
      const int c = i - t * row_vecs;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (p0 + t < limit) {
        const int64_t off = base + t * rows.row_stride;
        kv = reinterpret_cast<const uint4*>(k + off)[c];
        vv = reinterpret_cast<const uint4*>(v + off)[c];
      }
      reinterpret_cast<uint4*>(ks + t * D)[c] = kv;
      reinterpret_cast<uint4*>(vs + t * D)[c] = vv;
    }
    __syncthreads();

    // scores: one warp per (query head, position) dot product
    for (int e = warp; e < G * tile; e += kDecodeWarps) {
      const int g = e / tile;
      const int t = e - g * tile;
      const float* qr = qs + g * D;
      const T* kr = ks + t * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qr[d] * to_f(kr[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int pos = p0 + t;
        const float x = softcap_score(dot * scale, softcap);
        sc[e] = (pos >= start && pos < limit) ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax state: one warp per query head
    for (int g = warp; g < G; g += kDecodeWarps) {
      float* sg = sc + g * tile;
      float mx = kNegInf;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
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
    for (int i = tid; i < G * D; i += kDecodeThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = sc + g * tile;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < tile; ++t) a += pg[t] * to_f(vs[t * D + d]);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const float o = limit > 0 ? acc[i] / fmaxf(l[i / D], 1e-30f) : 0.f;
    ob[i] = from_f<T>(o);
  }
}

}  // namespace repro_torch
