// Dense flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `flash_decode`
// (src/repro/kernels/flash_decode.py; padding entry `ops.flash_decode`):
// one query token per sequence attends over that sequence's dense cache
// k/v [B, S, Hkv, D] (a layer's slice of the gathered [L, B, S, Hkv, D]
// cache).  Query head h reads KV head h / group.  Positions outside
// [start, min(len, S)) are masked; optional tanh softcap; fp32 online
// softmax; a row that attends nothing (len <= start, len == 0 among them)
// gives 0 (the Pallas kernel gives the mean of V at len == 0, see
// ROADMAP.md Queue C; the engine never asks for it).  Optionally each
// row's fp32 log-sum-exp too (-inf where it attends nothing), so that a
// cache split by sequence over several shards can combine their partial
// softmaxes (the decode plan, models/sharded.py).  The
// Pallas kernel has no `start`: with start = 0 this is its function, and
// `start` lets gemma2's local layers run here too.  S is not padded to a
// tile multiple nor D to 128 lanes: the ragged tail is masked and never
// read.
//
// What bounds it on an H100: bytes.  Each live K/V row must cross device
// memory once (2 * D * sizeof(T) per KV head per position) for ~group FMAs
// per element, far below the card's ~295 operations per byte.  One CTA per
// (sequence, KV head) serves all `group` query heads, so each live row is
// read once per KV head; it walks 32-position tiles through `decode_group`
// (decode_group.cuh), the loop the paged kernel runs over pages.  At small
// batch B * Hkv CTAs leave most of the 132 SMs idle and each walks ~30
// tiles in a row, so the positions are also split: the grid is (B, Hkv,
// n_split), and each row's own live tiles, from the tile that holds
// `start` to the one that holds min(len, S) - 1, are dealt out evenly:
// split s of a row with n live tiles takes tiles [s * n / n_split,
// (s + 1) * n / n_split) of them (floor division, `split_tiles`), so a
// short row or one whose window starts late still spreads over all the
// splits it can fill (empty splits only where n < n_split).  Each split
// writes its fp32 partial (m, l, acc) to a scratch buffer; a second
// kernel, `combine_splits_kernel` (decode_group.cuh, shared with the paged
// kernel), launched from the same C entry, rescales and sums each row's
// partials into the output (zeros where no split attended anything).  A
// second launch rather than a last-CTA combine
// behind an atomic counter: it needs no counter to zero before each call,
// adds a few microseconds at most, and sums the splits in a fixed order.
// The wrapper picks n_split from the batch, the cache length and the SM
// count (`flash_decode.split_count`); with one split the loop writes the
// output itself and the combine is not launched.
#include "decode_group.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 32;  // positions per staged tile

// A tile is kTile consecutive positions of one sequence and KV head.
struct DenseRows {
  int64_t seq_base;    // element offset of (b, position 0, kvh, 0)
  int64_t row_stride;  // Hkv * D
  __device__ int64_t tile_base(int j) const {
    return seq_base + static_cast<int64_t>(j) * kTile * row_stride;
  }
};

// part: fp32 [m: B*Hq*n_split | l: B*Hq*n_split | acc: B*Hq*n_split*D],
// row (b * Hq + h) * n_split + s; nullptr when n_split == 1.
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    const int* __restrict__ starts, T* __restrict__ out,
                    float* __restrict__ part, float* __restrict__ lse, int S,
                    int Hq, int Hkv, float softcap, float scale,
                    int* counts) {
  count_launch(counts, kCountLaunches);
  count_launch(counts, kCountLse, lse != nullptr);
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = Hq / Hkv;
  // the group's query heads kvh * G .. kvh * G + G - 1 are contiguous
  const int64_t head0 = static_cast<int64_t>(b) * Hq + kvh * G;
  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  const DenseRows rows{static_cast<int64_t>(b) * S * row_stride +
                           static_cast<int64_t>(kvh) * D,
                       row_stride};
  const int limit = min(lens[b], S);
  const int start = starts[b];
  int j_begin, j_end;
  split_tiles(start, limit, kTile, split, n_split, j_begin, j_end);
  const DecodePartial pt = split_partial(
      part, static_cast<int64_t>(gridDim.x) * Hq, head0, split, n_split, D);
  decode_group<T, D>(q + head0 * D, k, v, rows, G, kTile, start, limit,
                     j_begin, j_end, softcap, scale, out + head0 * D, pt,
                     lse == nullptr ? nullptr : lse + head0);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lens,
           const int* starts, void* out, float* lse, int B, int S, int Hq,
           int Hkv, int n_split, float* part, float softcap, float scale,
           int* counts, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<T, D>(Hq / Hkv, kTile);
  cudaError_t err = allow_smem(flash_decode_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T, D>
      <<<dim3(B, Hkv, n_split), kDecodeThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lens, starts, static_cast<T*>(out),
          n_split > 1 ? part : nullptr, n_split > 1 ? nullptr : lse, S, Hq,
          Hkv, softcap, scale, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return launch_combine<T>(part, out, static_cast<int64_t>(B) * Hq, n_split,
                           D, stream, counts, lse);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* lens,
               const int* starts, void* out, float* lse, int B, int S,
               int Hq, int Hkv, int D, int n_split, float* part,
               float softcap, float scale, int* counts, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lens, starts, out, lse, B, S, Hq, Hkv,
                           n_split, part, softcap, scale, counts, s);
    case 64:
      return launch<T, 64>(q, k, v, lens, starts, out, lse, B, S, Hq, Hkv,
                           n_split, part, softcap, scale, counts, s);
    case 128:
      return launch<T, 128>(q, k, v, lens, starts, out, lse, B, S, Hq, Hkv,
                            n_split, part, softcap, scale, counts, s);
    case 256:
      return launch<T, 256>(q, k, v, lens, starts, out, lse, B, S, Hq, Hkv,
                            n_split, part, softcap, scale, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q [B, Hq, D]; k/v [B, S, Hkv, D]; lens/starts [B]; out [B, Hq, D].  All
// contiguous, on one device, K and V 16-byte aligned.  n_split >= 1
// position splits; part: fp32 scratch of B * Hq * n_split * (D + 2)
// floats (unused, may be null, when n_split == 1).  lse: null, or fp32
// [B, Hq] for each row's log-sum-exp of its attended scores (-inf where
// it attends nothing), written by the loop with one split and by the
// combine with several; `out` is the same either way.  counts: null, or
// int32 [3] on the card: the launch adds one to counts[0], its combine
// launch (n_split > 1) one to counts[1], and a launch with lse one to
// counts[2].  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int flash_decode(int dtype, const void* q, const void* k,
                            const void* v, const void* lens,
                            const void* starts, void* out, void* lse, int B,
                            int S, int Hq, int Hkv, int D, int n_split,
                            void* part, float softcap, float scale,
                            void* counts, void* stream) {
  using namespace repro_torch;
  const int* ln = static_cast<const int*>(lens);
  const int* sb = static_cast<const int*>(starts);
  float* pt = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  int* ct = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && pt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, ln, sb, out, ls, B, S, Hq, Hkv, D,
                             n_split, pt, softcap, scale, ct, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, ln, sb, out, ls, B, S, Hq, Hkv,
                                     D, n_split, pt, softcap, scale, ct, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
