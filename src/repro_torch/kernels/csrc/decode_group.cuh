// The decode inner loop shared by the paged (paged_decode.cu) and dense
// (flash_decode.cu) decode kernels, and what both need to split a row's
// positions over several CTAs: the dealing of tiles to splits, the
// partial each split writes, and the combine kernel.
//
// One CTA serves one (sequence, KV head) and all `G` query heads of its
// group, so every live K/V row crosses device memory once per KV head, not
// once per query head.  It walks the tiles [j_begin, j_end) of `tile`
// positions each: the whole live range for one split, or one split's share
// of it.  Positions outside [start, limit) are masked; rows at or past
// `limit` are zero-filled and never read.
//
// What bounds it is the latency of each tile, not the card's rates: a
// tile is a few KB and the CTA has nothing else to do while it waits.  So:
// - K and V tiles are copied by 16-byte `cp.async` into a two-stage ring in
//   shared memory (rows padded by 16 bytes against bank conflicts): tile
//   j + 1 is in flight while tile j is scored and summed.
// - Scores: one warp per query head scores whole positions, `lpp` lanes per
//   position (1 at 32-position tiles, 2 at 16-position pages), each lane
//   reading its K chunks with 16-byte loads against q in fp32 from shared
//   memory (broadcast reads; q of all G heads does not fit in registers at
//   G = 8, D = 128), then a log2(lpp)-step shuffle.  The same warp keeps the
//   head's fp32 online softmax (max and sum by warp shuffles), so scoring
//   and softmax need no barrier between them.
// - P V: each thread owns 16 bytes' worth of output columns of one or more
//   heads, reads its V chunk with one 16-byte load per position and
//   accumulates in registers.
// - Two barriers per tile: tile visible (which also frees the stage the
//   next copy overwrites), and P visible.
//
// The result goes either straight to the G output rows (acc / l; zeros
// where nothing was attended, e.g. len == 0; with `lse`, also each head's
// log-sum-exp m + log(l) of its scores, -inf where nothing was attended),
// or, when the caller splits
// the positions over several CTAs, as the split's fp32 partials (m, l,
// acc), which `combine_splits_kernel` rescales and sums.  An empty split
// writes m = -inf, l = 0.
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

// The decode kernels' launch-count slots (`count_launch`): the kernel's
// launches, its combine launches, and (dense kernel only) its launches
// that wrote the log-sum-exp.
constexpr int kCountLaunches = 0;
constexpr int kCountCombines = 1;
constexpr int kCountLse = 2;

// Where one CTA's result goes when the positions are split: head g's m and
// l at m[g * stride], l[g * stride], its acc row at acc + g * stride * D.
// m == nullptr: no split, write the output rows.
struct DecodePartial {
  float* m;
  float* l;
  float* acc;
  int stride;
};

// The live tiles of split `split` of `n_split` of one row: the row's live
// tiles run from the tile that holds max(start, 0) to the one that holds
// limit - 1; with n of them, split s takes [s * n / n_split,
// (s + 1) * n / n_split) of that run (floor division), so a short row or
// one whose window starts late still spreads over every split it can
// fill, and a split is empty only where n < n_split.  A row that attends
// nothing (limit <= start: a cache split by sequence leaves such rows on
// the shards whose range lies past the position or before the window)
// has no live tile.
__device__ __forceinline__ void split_tiles(int start, int limit, int tile,
                                            int split, int n_split,
                                            int& j_begin, int& j_end) {
  const int live_end = limit > 0 ? (limit - 1) / tile + 1 : 0;
  const int first = min(max(start, 0) / tile, live_end);
  const int n_live = limit > max(start, 0) ? live_end - first : 0;
  j_begin = first + split * n_live / n_split;
  j_end = first + (split + 1) * n_live / n_split;
}

// The partial of split `split` of the G heads from output row `head0` on
// (head0 = b * Hq + first head), in the fp32 scratch
// [m: rows * n_split | l: rows * n_split | acc: rows * n_split * D],
// row (b * Hq + h) * n_split + s, rows = B * Hq.  No split (part ==
// nullptr): write the output rows.
__device__ __forceinline__ DecodePartial split_partial(float* part,
                                                       int64_t rows,
                                                       int64_t head0,
                                                       int split,
                                                       int n_split, int D) {
  if (part == nullptr) return DecodePartial{nullptr, nullptr, nullptr, 0};
  const int64_t n = rows * n_split;
  const int64_t r = head0 * n_split + split;
  return DecodePartial{part + r, part + n + r, part + 2 * n + r * D,
                       n_split};
}

// One CTA per output row (b, h): out = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s over the splits that attended something, summed
// in the order of the splits; zeros where none did.  With `lse`, also the
// row's log-sum-exp M + log(sum_s e^(m_s - M) l_s) in fp32, -inf where no
// split attended anything.  Counts itself in counts[kCountCombines] and,
// with `lse`, the caller's launch in counts[kCountLse].
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
combine_splits_kernel(const float* __restrict__ part, T* __restrict__ out,
                      float* __restrict__ lse, int n_split, int D,
                      int* counts) {
  count_launch(counts, kCountCombines);
  count_launch(counts, kCountLse, lse != nullptr);
  const int64_t row = blockIdx.x;
  const int64_t n_rows = static_cast<int64_t>(gridDim.x) * n_split;
  const float* m = part + row * n_split;
  const float* l = part + n_rows + row * n_split;
  const float* acc = part + 2 * n_rows + row * n_split * D;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, m[s]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (m[s] > -INFINITY) L += expf(m[s] - M) * l[s];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (m[s] > -INFINITY) o += expf(m[s] - M) * acc[s * D + d];
    out[row * D + d] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = L > 0.f ? M + logf(L) : -INFINITY;
}

// After a split launch: combine the `rows` output rows' partials (and
// write their log-sum-exp to `lse` unless it is null).  Returns
// cudaGetLastError() after the launch.
template <typename T>
inline int launch_combine(const float* part, void* out, int64_t rows,
                          int n_split, int D, cudaStream_t stream,
                          int* counts, float* lse = nullptr) {
  combine_splits_kernel<T><<<static_cast<unsigned>(rows), kDecodeThreads, 0,
                             stream>>>(part, static_cast<T*>(out), lse,
                                       n_split, D, counts);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory the loop needs: K and V tiles in the storage type, two
// stages each, then fp32 q (rows of D + 4), acc, P and the per-head
// softmax state.
template <typename T, int D>
inline size_t decode_smem_bytes(int G, int tile) {
  constexpr int kRow = D + 16 / static_cast<int>(sizeof(T));
  return 4 * static_cast<size_t>(tile) * kRow * sizeof(T) +
         (static_cast<size_t>(G) * (2 * D + 4) +
          static_cast<size_t>(G) * tile + 3 * G) *
             sizeof(float);
}

// 16 bytes of K or V as floats.
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_group(
    const T* __restrict__ qb, const T* __restrict__ k,
    const T* __restrict__ v, const Rows& rows, int G, int tile, int start,
    int limit, int j_begin, int j_end, float softcap, float scale,
    T* __restrict__ ob, DecodePartial part, float* __restrict__ lse = nullptr) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements / chunk
  constexpr int NC = D / VEC;                            // chunks per row
  constexpr int LDT = D + VEC;                           // smem K/V row
  constexpr int LDQ = D + 4;                             // smem q row
  constexpr int HS = kDecodeThreads / NC;  // heads summed in parallel
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [2][tile][LDT]
  T* vs = ks + 2 * tile * LDT;         // [2][tile][LDT]
  float* qs = reinterpret_cast<float*>(vs + 2 * tile * LDT);  // [G][LDQ]
  float* acc = qs + G * LDQ;  // [G][D]
  float* sc = acc + G * D;    // [G][tile]: scores, then P
  float* m = sc + G * tile;
  float* l = m + G;
  float* alpha = l + G;

  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D;
    qs[g * LDQ + i - g * D] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  auto load = [&](int j, int stage) {
    const int64_t base = rows.tile_base(j);
    const int p0 = j * tile;
    T* kd = ks + stage * tile * LDT;
    T* vd = vs + stage * tile * LDT;
    for (int i = tid; i < tile * NC; i += kDecodeThreads) {
      const int t = i / NC;
      const int c = i - t * NC;
      const bool ok = p0 + t < limit;
      const int64_t off = ok ? base + t * rows.row_stride + c * VEC : 0;
      cp_async16(kd + t * LDT + c * VEC, k + off, ok);
      cp_async16(vd + t * LDT + c * VEC, v + off, ok);
    }
  };

  // scores: lpp lanes per position, ppw positions per warp pass
  int lpp = 1;
  while (lpp * 2 * tile <= 32) lpp *= 2;
  const int ppw = 32 / lpp;
  const int sub = lane & (lpp - 1);
  const int tl = lane / lpp;
  // P V: this thread's column chunk and first head
  const int pc = tid % NC;
  const int ph = tid / NC;

  if (j_begin < j_end) load(j_begin, 0);
  cp_async_commit();

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = (j - j_begin) & 1;
    cp_async_wait<0>();
    // tile j (and, on entry, q and the state) is visible; every thread is
    // done with tile j - 1, whose stage the next copy overwrites
    __syncthreads();
    if (j + 1 < j_end) load(j + 1, stage ^ 1);
    cp_async_commit();
    const T* kt = ks + stage * tile * LDT;
    const T* vt = vs + stage * tile * LDT;
    const int p0 = j * tile;

    for (int g = warp; g < G; g += kDecodeWarps) {
      const float* qr = qs + g * LDQ;
      float* sg = sc + g * tile;
      float mx = kNegInf;
      for (int t0 = 0; t0 < tile; t0 += ppw) {
        const int t = t0 + tl;
        float dot = 0.f;
        if (t < tile) {
          const T* kr = kt + t * LDT;
          for (int c = sub; c < NC; c += lpp) {
            float kx[VEC];
            load_chunk(kr + c * VEC, kx);
            const float* qc = qr + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qc + e);
              dot += kx[e] * qv.x + kx[e + 1] * qv.y + kx[e + 2] * qv.z +
                     kx[e + 3] * qv.w;
            }
          }
        }
        for (int o = lpp >> 1; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int pos = p0 + t;
        const float x = (t < tile && pos >= start && pos < limit)
                            ? softcap_score(dot * scale, softcap)
                            : kNegInf;
        if (t < tile && sub == 0) sg[t] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t0 = 0; t0 < tile; t0 += ppw) {
        const int t = t0 + tl;
        if (t < tile && sub == 0) {
          const float p = expf(sg[t] - m_cur);
          sg[t] = p;
          sum += p;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);  // 0 on the first tile
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_cur;
      }
    }
    __syncthreads();  // P and alpha visible

    // acc[g, cols] = acc * alpha[g] + sum_t P[g, t] * V[t, cols]
    for (int g = ph; g < G; g += HS) {
      float* ag = acc + g * D + pc * VEC;
      const float* pg = sc + g * tile;
      const float a = alpha[g];
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = ag[e] * a;
      for (int t = 0; t < tile; ++t) {
        const float p = pg[t];
        float vx[VEC];
        load_chunk(vt + t * LDT + pc * VEC, vx);
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] += p * vx[e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ag[e] = o[e];
    }
  }
  __syncthreads();

  if (part.m == nullptr) {
    for (int i = tid; i < G * D; i += kDecodeThreads) {
      const float lg = l[i / D];
      ob[i] = from_f<T>(lg > 0.f ? acc[i] / lg : 0.f);
    }
    if (lse != nullptr)
      for (int g = tid; g < G; g += kDecodeThreads)
        lse[g] = l[g] > 0.f ? m[g] + logf(l[g]) : -INFINITY;
  } else {
    for (int i = tid; i < G * D; i += kDecodeThreads) {
      const int g = i / D;
      part.acc[static_cast<int64_t>(g) * part.stride * D + i - g * D] =
          acc[i];
    }
    for (int g = tid; g < G; g += kDecodeThreads) {
      part.m[g * part.stride] = m[g];
      part.l[g * part.stride] = l[g];
    }
  }
}

}  // namespace repro_torch
