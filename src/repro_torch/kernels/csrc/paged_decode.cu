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
// heads (the Pallas grid (B, Hq, pages) is not carried over).  The loop is
// `decode_group` in decode_group.cuh, shared with the dense decode kernel,
// with a page as its tile: pages are copied by 16-byte cp.async into a
// two-stage ring, so page j + 1 loads while page j is scored, a warp
// scores whole positions of one query head, and the fp32 softmax state and
// P V stay on chip.
//
// At small batch B * Hkv CTAs leave most of the 132 SMs idle (32 at
// yi-9b's B = 8, Hkv = 4) and each would walk up to ~60 pages in a row,
// one page's latency after another.  So the pages are split: the grid is
// (B, Hkv, n_split), and each row's own live pages, from the page that
// holds max(start, 0) to the one that holds min(len, n_pages * page) - 1,
// are dealt out evenly over the splits (`split_tiles`, as the dense
// kernel deals its tiles).  Each split writes its fp32 partial (m, l, acc)
// and `combine_splits_kernel` (decode_group.cuh, shared with the dense
// kernel), launched from the same C entry, rescales and sums them in a
// fixed order; with one split the loop writes the output itself and the
// combine is not launched.  The wrapper picks n_split from the batch, the
// block table's width and the SM count (`flash_decode.split_count`): the
// lengths live on the card, where the wrapper cannot read them.
#include "decode_group.cuh"

namespace repro_torch {
namespace {

// A tile is one page, found through the sequence's block-table row.
struct PagedRows {
  const int* row;
  int Hkv;
  int kvh;
  int64_t page_elems;
  int64_t row_stride;  // D
  __device__ int64_t tile_base(int j) const {
    return (static_cast<int64_t>(row[j]) * Hkv + kvh) * page_elems;
  }
};

// part: fp32 [m: B*Hq*n_split | l: B*Hq*n_split | acc: B*Hq*n_split*D],
// row (b * Hq + h) * n_split + s; nullptr when n_split == 1.
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lens,
                    const int* __restrict__ starts, T* __restrict__ out,
                    float* __restrict__ part, int Hq, int Hkv, int page,
                    int n_pages, float softcap, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = Hq / Hkv;
  // the group's query heads kvh * G .. kvh * G + G - 1 are contiguous
  const int64_t head0 = static_cast<int64_t>(b) * Hq + kvh * G;
  const PagedRows rows{table + static_cast<int64_t>(b) * n_pages, Hkv, kvh,
                       static_cast<int64_t>(page) * D, D};
  const int limit = min(lens[b], n_pages * page);
  const int start = starts[b];
  int j_begin, j_end;
  split_tiles(start, limit, page, split, n_split, j_begin, j_end);
  const DecodePartial pt = split_partial(
      part, static_cast<int64_t>(gridDim.x) * Hq, head0, split, n_split, D);
  decode_group<T, D>(q + head0 * D, k_pages, v_pages, rows, G, page, start,
                     limit, j_begin, j_end, softcap, scale, out + head0 * D,
                     pt);
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* lens, const int* starts, void* out,
           int B, int Hq, int Hkv, int page, int n_pages, int n_split,
           float* part, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<T, D>(Hq / Hkv, page);
  cudaError_t err = allow_smem(paged_decode_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T, D>
      <<<dim3(B, Hkv, n_split), kDecodeThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), table, lens, starts,
          static_cast<T*>(out), n_split > 1 ? part : nullptr, Hq, Hkv, page,
          n_pages, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return launch_combine<T>(part, out, static_cast<int64_t>(B) * Hq, n_split,
                           D, stream);
}

template <typename T>
int dispatch_d(const void* q, const void* k_pages, const void* v_pages,
               const int* table, const int* lens, const int* starts,
               void* out, int B, int Hq, int Hkv, int page, int D,
               int n_pages, int n_split, float* part, float softcap,
               float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, table, lens, starts, out, B,
                           Hq, Hkv, page, n_pages, n_split, part, softcap,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, table, lens, starts, out, B,
                           Hq, Hkv, page, n_pages, n_split, part, softcap,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, table, lens, starts, out, B,
                            Hq, Hkv, page, n_pages, n_split, part, softcap,
                            scale, s);
    case 256:
      return launch<T, 256>(q, k_pages, v_pages, table, lens, starts, out, B,
                            Hq, Hkv, page, n_pages, n_split, part, softcap,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q [B, Hq, D]; k_pages/v_pages [P, Hkv, page, D]; table [B, n_pages];
// lens/starts [B]; out [B, Hq, D].  All contiguous, on one device, pools
// 16-byte aligned.  n_split >= 1 page splits; part: fp32 scratch of
// B * Hq * n_split * (D + 2) floats (unused, may be null, when
// n_split == 1).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int paged_decode(int dtype, const void* q, const void* k_pages,
                            const void* v_pages, const void* table,
                            const void* lens, const void* starts, void* out,
                            int B, int Hq, int Hkv, int page, int D,
                            int n_pages, int n_split, void* part,
                            float softcap, float scale, void* stream) {
  using namespace repro_torch;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  const int* sb = static_cast<const int*>(starts);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && pt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k_pages, v_pages, tb, ln, sb, out, B, Hq,
                             Hkv, page, D, n_pages, n_split, pt, softcap,
                             scale, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, sb, out, B,
                                     Hq, Hkv, page, D, n_pages, n_split, pt,
                                     softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
